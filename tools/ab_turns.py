"""Time the port's mask-template, bcrypt and rule kernels for two or more
trees on one card, in turns, each turn a process of its own:

    python3 tools/ab_turns.py --tree NAME=DIR[:FAMILIES] ... \\
        [--order NAME,NAME,...] [--out FILE] [--sass DIR]

DIR holds a tree's ``dprf_tpu_torch`` package: this repository's root, a
parent commit's package (``git archive COMMIT dprf_tpu_torch | tar -x -C
DIR``) or a copy edited into a variant.  Every tree's csrc/ libraries
that its families use are built first, all at once, into the tree's own
``_build/``.  FAMILIES (comma-separated, default ``mask,bcrypt``):

- ``mask``: every instantiation of the mask kernel template (csrc/mask.cu,
  csrc/ext.cu, csrc/keccak.cu) per launch of 2^24 lanes: ?l^6 for md5
  with one target, else ?a^7; one target, 1,000 targets (the Bloom sets)
  and the six cores' blocked probe at 1,000.  ``mask64`` is the same
  without the wide cores (sha512/384, Keccak).  Each instantiation is
  first held equal to its plain version over 2^20 lanes at an odd window
  offset, a hit planted in the last lanes (exact count, lanes and
  target positions);
- ``bcrypt``: bcrypt_advance, 16 cost rounds a launch, at 4,224
  candidates (a 132-SM card at 32 an SM) and at the tree's resident
  wave, after one cost round at that wave is held equal to its plain
  version; ms a cost round, ps a candidate-round and cycles a Feistel
  round at the sampled clock;
- ``rules``: the four rule-kernel instantiations (csrc/rules.cu: md5,
  ntlm, sha1, sha256) per launch of 2^24 candidates, 2^18 words of
  chip_smoke.py's synthetic list x best64 (max_len 27 for ntlm, else
  55), through the worker's step, which lays out each tree's tables as
  its kernel takes them.  Each is first held equal to its plain version
  over a window of 2^18 - 777 words at word 12,345, a hit planted at its
  last word under best64's 8-op rule (exact count and lanes).

The SM clock is sampled over each family (``SmClock`` of chip_smoke.py).
--order is a comma-separated list of tree names, by default the trees
in order and then in reverse (a, b, b, a).  With --sass DIR, each tree's
first turn writes DIR/NAME/census.json (registers and SASS instructions
of every kernel of its built libraries, by mangled name) and
DIR/NAME/bcrypt.sass or rules.sass where it built them.  Prints one
JSON line a turn, then each kernel's mean ms by tree; writes the turns
to --out.  Needs a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 1 << 24
CHECK_LANES = 1 << 20
N_TARGETS = 1000
SEED = 20261018
#: bcrypt's wave on a 132-SM card at one block of 32 candidates an SM
WAVE_4224 = 132 * 32
ADVANCE_ROUNDS = 16
#: Feistel rounds of one cost round of one candidate
ROUNDS_PER_COST = 2 * 521 * 16
MASK_CORES = ("md5", "ntlm", "sha1", "sha256", "sha512", "sha384")
WIDE = ("sha512", "sha384")
NESTED = ("md5(md5)", "sha1(sha1)", "md5(sha1)", "sha1(md5)", "sha256(md5)",
          "sha256(sha1)", "mysql41")
KECCAK = ("sha3-224", "sha3-256", "sha3-384", "sha3-512")
#: the csrc/ libraries of each family
LIBRARIES = {"mask": ("mask", "ext", "keccak"), "mask64": ("mask", "ext"),
             "bcrypt": ("bcrypt",), "rules": ("rules",)}
RULE_CORES = ("md5", "ntlm", "sha1", "sha256")
#: words a rule-kernel launch: 2^24 candidates under best64's 64 rules
RULE_WORDS = BATCH // 64
#: best64's 8-op rule, the check's planted hit
RULE_8OPS = 56


def _smoke():
    """chip_smoke.py of this repository, for its SmClock and busy."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Turn:
    """One turn's imports from its tree, and the shared inputs."""

    def __init__(self, tree: str):
        sys.path.insert(0, os.path.abspath(tree))
        import numpy as np
        import torch

        import dprf_tpu_torch
        from dprf_tpu_torch import get_engine
        from dprf_tpu_torch.generators.mask import MaskGenerator
        from dprf_tpu_torch.ops import (_build, bloom, cuda_bcrypt, cuda_ext,
                                        cuda_keccak, cuda_mask)
        from dprf_tpu_torch.ops import blowfish
        from dprf_tpu_torch.ops.compare import digest_rows, make_target_table

        pkg = os.path.dirname(os.path.abspath(dprf_tpu_torch.__file__))
        if pkg != os.path.join(os.path.abspath(tree), "dprf_tpu_torch"):
            raise SystemExit(f"ab_turns: imported {pkg}, not {tree}'s")
        if not torch.cuda.is_available():
            raise SystemExit("ab_turns: no CUDA card")
        smoke = _smoke()
        self.smoke = smoke
        self.SmClock, self.busy = smoke.SmClock, smoke.busy
        self.np, self.torch, self.rng = np, torch, np.random.default_rng(SEED)
        self.get_engine, self.bloom = get_engine, bloom
        self.make_target_table, self.digest_rows = make_target_table, \
            digest_rows
        self._build, self.bf = _build, blowfish
        self.cuda_mask, self.cuda_bcrypt = cuda_mask, cuda_bcrypt
        self.g6, self.g7 = MaskGenerator("?l" * 6), MaskGenerator("?a" * 7)
        self.dev = "cuda"
        self._luts = {}
        # (cores, single, multi, single plain, multi plain, name)
        self.families = [
            (MASK_CORES, cuda_mask.mask_kernel, cuda_mask.mask_multi_kernel,
             cuda_mask.mask_plain, cuda_mask.mask_multi_plain, str),
            (NESTED, cuda_ext.nested_kernel, cuda_ext.nested_multi_kernel,
             cuda_ext.nested_plain, cuda_ext.nested_multi_plain, str),
            (KECCAK, cuda_keccak.keccak_mask_kernel,
             cuda_keccak.keccak_mask_multi_kernel,
             cuda_keccak.keccak_mask_plain,
             cuda_keccak.keccak_mask_multi_plain,
             lambda e: f"keccak{e[5:]}")]

    def lut(self, gen):
        return self._luts.setdefault(gen.mask, gen.charset_lut(self.dev))

    def words(self, engine, digests):
        le = self.get_engine(engine, "cuda", torch_device="cpu").little_endian
        return self.digest_rows(digests, le)

    def table(self, engine, digests):
        le = self.get_engine(engine, "cuda", torch_device="cpu").little_endian
        return self.make_target_table(digests, le)

    def bloom_rows(self, table):
        return self.torch.as_tensor(
            self.bloom.bloom_tables(table.original_words())
            .view(self.np.int32), device=self.dev)

    def fillers(self, engine, n):
        words = [bytes(self.rng.integers(33, 127, 8, dtype=self.np.uint8))
                 for _ in range(n)]
        return self.get_engine(engine).hash_batch(words)

    def time(self, fn) -> float:
        """ms a call over 0.4 s of calls, after one warm-up call."""
        fn()
        self.torch.cuda.synchronize()
        return self.busy(self.torch, fn, 0.4, 16)[0]


def _check(t: Turn, name, single, multi, sp, mp, engine, gen) -> None:
    """Kernel == plain over CHECK_LANES lanes at an odd window start: one
    target planted in the last lanes, and 1,000 targets, two planted."""
    torch = t.torch
    start = int(t.rng.integers(0, gen.keyspace // CHECK_LANES - 2)) \
        * CHECK_LANES + 37
    nv = CHECK_LANES - 5
    oracle = t.get_engine(engine)
    target = [int(w) for w in t.words(engine, oracle.hash_batch(
        [gen.candidate(start + nv - 2)]))[0]]
    args = (engine, t.lut(gen), gen.radices, gen.digits(start), nv, target,
            64, CHECK_LANES)
    k, p = single(*args), sp(*args)
    torch.cuda.synchronize()
    k = (int(k[0].item()), sorted(k[1].tolist()))
    p = (int(p[0].item()), sorted(p[1].tolist()))
    if k != p or k[0] != 1:
        raise SystemExit(f"ab_turns: {name} kernel {k} != plain {p}")
    plants = [start, start + nv - 1]
    table = t.table(engine, oracle.hash_batch([gen.candidate(x)
                                               for x in plants])
                    + t.fillers(engine, N_TARGETS - 2))
    args = (engine, t.lut(gen), gen.radices, gen.digits(start), nv,
            t.bloom_rows(table), table.tensor(t.dev), 64, CHECK_LANES)
    k, p = multi(*args), mp(*args)
    torch.cuda.synchronize()

    def flat(count, lanes, tpos, n_maybe):
        return (int(count.item()), sorted(zip(lanes.tolist(),
                                              tpos.tolist())),
                int(n_maybe.item()))
    if flat(*k) != flat(*p) or flat(*k)[0] != 2:
        raise SystemExit(f"ab_turns: {name}_multi kernel {flat(*k)} != "
                         f"plain {flat(*p)}")


def mask_family(t: Turn, wide: bool) -> dict:
    """ms a launch of 2^24 lanes of every instantiation."""
    out = {}
    miss = b"\0" * 9
    with t.SmClock() as clock:
        for cores, single, multi, sp, mp, name in t.families:
            for engine in cores:
                if not wide and (engine in WIDE or cores is KECCAK):
                    continue
                key = f"{name(engine)}_mask"
                _check(t, key, single, multi, sp, mp, engine, t.g7)
                for is_multi in (False, True):
                    gen = t.g6 if (engine == "md5" and not is_multi) \
                        else t.g7
                    start = int(t.rng.integers(0, gen.keyspace // BATCH)) \
                        * BATCH
                    head = (engine, t.lut(gen), gen.radices,
                            gen.digits(start), BATCH)
                    if is_multi:
                        table = t.table(engine, t.fillers(engine, N_TARGETS))
                        args = head + (t.bloom_rows(table),
                                       table.tensor(t.dev), 64, BATCH)
                        out[key + "_multi"] = t.time(lambda: multi(*args))
                    else:
                        target = [int(w) for w in t.words(
                            engine, t.get_engine(engine).hash_batch(
                                [miss]))[0]]
                        args = head + (target, 64, BATCH)
                        out[key] = t.time(lambda: single(*args))
        cm = t.cuda_mask
        for engine in MASK_CORES:
            if not wide and engine in WIDE:
                continue
            start = int(t.rng.integers(0, t.g7.keyspace // BATCH)) * BATCH
            table = t.table(engine, t.fillers(engine, N_TARGETS))
            rows, bits, k = cm.probe_rows(table.words)
            args = (engine, t.lut(t.g7), t.g7.radices, t.g7.digits(start),
                    BATCH, t.torch.as_tensor(rows.view(t.np.int32),
                                             device=t.dev),
                    bits, k, table.tensor(t.dev), 64, BATCH)
            out[f"{engine}_mask_probe"] = t.time(
                lambda: cm.mask_probe_kernel(*args))
    return {"ms": out, "sm_mhz": clock.mhz, "clock_samples":
            len(clock.samples)}


def _bcrypt_state(t: Turn, batch: int):
    np, bf, cb = t.np, t.bf, t.cuda_bcrypt
    lens = t.rng.integers(1, 73, batch)
    cand = np.zeros((batch, 72), np.uint8)
    for i, n in enumerate(lens):
        cand[i, :n] = t.rng.integers(1, 256, n, dtype=np.uint8)
    key = bf.key_words_from_candidates(
        t.torch.as_tensor(cand, device="cuda"),
        t.torch.as_tensor(lens.astype(np.int32), device="cuda"))
    sw = bf.salt_to_words(bytes(range(16)))
    P, S = cb.setup_kernel(key, sw)
    return key, bf.salt18_words(sw), P, S


def bcrypt_family(t: Turn) -> dict:
    torch, cb = t.torch, t.cuda_bcrypt
    wave = cb.resident_batch("cuda")
    key, s18, P, S = _bcrypt_state(t, wave)
    Pk, Sk = P.clone(), S.clone()
    cb.advance_kernel(Pk, Sk, key, s18, 1)
    Pp, Sp = cb.advance_plain(P, S, key, s18, 1)
    torch.cuda.synchronize()
    if not (torch.equal(Pk, Pp) and torch.equal(Sk, Sp)):
        raise SystemExit("ab_turns: bcrypt_advance kernel != plain")
    res = {"wave": wave, "blocks_per_sm": {k: cb.occupancy(0, k)[0]
                                           for k in cb.KERNELS}}
    for batch in sorted({WAVE_4224, wave}):
        key, s18, P, S = _bcrypt_state(t, batch)
        with t.SmClock() as clock:
            ms, calls = t.busy(
                torch, lambda: cb.advance_kernel(P, S, key, s18,
                                                 ADVANCE_ROUNDS),
                seconds=1.0, chunk=4)
        per_round = ms / ADVANCE_ROUNDS
        res[str(batch)] = {
            "ms": ms, "calls": calls, "ms_per_cost_round": per_round,
            "ps_per_candidate_round": per_round / batch * 1e9,
            "sm_mhz": clock.mhz, "cycles_per_feistel_round":
            per_round * 1e-3 * clock.mhz * 1e6 / ROUNDS_PER_COST
            if clock.mhz else None}
    return res


def rules_family(t: Turn) -> dict:
    """ms a launch of 2^24 candidates of each rule instantiation through
    the worker's step (``make_cuda_rules_crack_step``, which lays out the
    tree's tables its own way), after the check: the step with a hit
    planted at the window's last word under best64's 8-op rule == the
    plain version on the packed table (exact count and lanes)."""
    from dprf_tpu_torch.generators.wordlist import WordlistRulesGenerator
    from dprf_tpu_torch.ops import cuda_rules as cr
    from dprf_tpu_torch.rules import load_rules
    np, torch, out = t.np, t.torch, {}
    best64 = load_rules("best64")
    words = t.smoke.synthetic_words(RULE_WORDS + 12345)
    with t.SmClock() as clock:
        for engine in RULE_CORES:
            name = f"{engine}_rules"
            gen = WordlistRulesGenerator(
                words, best64, max_len=27 if engine == "ntlm" else 55)
            buf, lens = gen.packed_words()

            def step(plain):
                target = t.smoke.digest_words(
                    engine, t.get_engine(engine).hash_batch([plain])[0])
                return cr.make_cuda_rules_crack_step(
                    engine, gen, np.asarray(target, np.uint32), RULE_WORDS)

            ws, nv = 12345, RULE_WORDS - 777
            want = gen.candidate(gen.index_of(ws + nv - 1, RULE_8OPS))
            k = step(want)(ws, nv)[:2]
            p = cr.rules_plain(
                engine, torch.as_tensor(buf, device="cuda"),
                torch.as_tensor(lens, device="cuda"),
                *cr.rule_tables(best64, "cuda"), ws, nv,
                t.smoke.digest_words(engine, t.get_engine(engine)
                                     .hash_batch([want])[0]), 64, RULE_WORDS)
            torch.cuda.synchronize()
            k = (int(k[0].item()), sorted(k[1].tolist()))
            p = (int(p[0].item()), sorted(p[1].tolist()))
            lane = RULE_8OPS * RULE_WORDS + nv - 1
            if k != p or lane not in k[1]:
                raise SystemExit(f"ab_turns: {name} kernel {k} != plain {p}")
            miss = step(b"\0" * 9)
            out[name] = t.time(lambda: miss(0, RULE_WORDS))
    return {"ms": out, "sm_mhz": clock.mhz,
            "clock_samples": len(clock.samples)}


def census(_build, name: str) -> dict:
    """(registers, SASS instructions) of each kernel of a built library,
    by mangled name (nvcc's -Xptxas -v log and ``_build.sass_census``)."""
    regs, fn = {}, None
    for line in _build.build(name).log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            regs[fn] = int(m.group(1))
    return {f: (regs.get(f), c["total"])
            for f, c in _build.sass_census(name).items()}


def turn(tree: str, families: list, sass_dir=None) -> dict:
    t = Turn(tree)
    res = {"tree": tree, "families": families}
    for fam in families:
        if fam in ("mask", "mask64"):
            res["mask"] = mask_family(t, wide=fam == "mask")
        elif fam == "bcrypt":
            res["bcrypt"] = bcrypt_family(t)
        elif fam == "rules":
            res["rules"] = rules_family(t)
    if sass_dir:
        os.makedirs(sass_dir, exist_ok=True)
        libs = sorted({lib for f in families for lib in LIBRARIES[f]})
        with open(os.path.join(sass_dir, "census.json"), "w") as fh:
            json.dump({lib: census(t._build, lib) for lib in libs}, fh,
                      indent=1)
        cuobjdump = os.path.join(os.path.dirname(t._build.nvcc_path()),
                                 "cuobjdump")
        for lib in {"bcrypt", "rules"} & set(libs):
            with open(os.path.join(sass_dir, f"{lib}.sass"), "w") as fh:
                fh.write(subprocess.run(
                    [cuobjdump, "-sass", t._build.build(lib).path],
                    capture_output=True, text=True, check=True).stdout)
    res["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    return res


def build_all(trees: dict) -> None:
    """Build every tree's libraries at once; exit 1 if one fails."""
    procs = []
    for name, (tree, families) in trees.items():
        for lib in sorted({x for f in families for x in LIBRARIES[f]}):
            code = (f"import sys; sys.path.insert(0, {tree!r}); "
                    "from dprf_tpu_torch.ops import _build; "
                    f"print(round(_build.build({lib!r}).seconds, 1))")
            procs.append((name, lib, subprocess.Popen(
                [sys.executable, "-c", code], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, cwd=tree)))
    failed = False
    for name, lib, proc in procs:
        out, err = proc.communicate()
        print(f"build {name} {lib}: rc {proc.returncode}, {out.strip()} s",
              flush=True)
        if proc.returncode:
            print(err[-3000:], file=sys.stderr)
            failed = True
    if failed:
        raise SystemExit(1)


def summary(turns: list) -> dict:
    """Each kernel's mean ms by tree (bcrypt: ms a cost round by wave)."""
    acc: dict = {}
    for tr in turns:
        for fam in ("mask", "rules"):
            for k, ms in tr.get(fam, {}).get("ms", {}).items():
                acc.setdefault(k, {}).setdefault(tr["name"], []).append(ms)
        for k, v in tr.get("bcrypt", {}).items():
            if isinstance(v, dict) and "ms_per_cost_round" in v:
                acc.setdefault(f"bcrypt_advance@{k}", {}).setdefault(
                    tr["name"], []).append(v["ms_per_cost_round"])
    return {k: {n: sum(v) / len(v) for n, v in by.items()}
            for k, by in acc.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR[:FAMILIES]")
    ap.add_argument("--order", help="tree names, comma-separated")
    ap.add_argument("--out", default="ab_turns.json")
    ap.add_argument("--sass", help="write each tree's census here")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    ap.add_argument("--families", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.turn:
        print(json.dumps(turn(args.turn, args.families.split(","),
                              args.sass)), flush=True)
        return 0
    trees = {}
    for spec in args.tree:
        name, _, rest = spec.partition("=")
        tree, _, fams = rest.partition(":")
        families = fams.split(",") if fams else ["mask", "bcrypt"]
        bad = set(families) - set(LIBRARIES)
        if not name or not tree or bad:
            ap.error(f"--tree {spec}: NAME=DIR[:FAMILIES], families "
                     f"{sorted(LIBRARIES)}")
        trees[name] = (os.path.abspath(tree), families)
    if len(trees) < 2:
        ap.error("give two or more --tree")
    order = args.order.split(",") if args.order else \
        list(trees) + list(trees)[::-1]
    if set(order) - set(trees):
        ap.error(f"--order names {sorted(set(order) - set(trees))}, "
                 "not a --tree")
    build_all(trees)
    turns, sassed = [], set()
    for name in order:
        tree, families = trees[name]
        argv = [sys.executable, os.path.abspath(__file__), "--turn", tree,
                "--families", ",".join(families)]
        if args.sass and name not in sassed:
            argv += ["--sass", os.path.join(os.path.abspath(args.sass),
                                            name)]
            sassed.add(name)
        # each turn runs as a script from its tree, so it imports the
        # package of that tree alone
        proc = subprocess.run(argv, capture_output=True, text=True, cwd=tree)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        turns.append({"name": name,
                      **json.loads(proc.stdout.strip().splitlines()[-1])})
        print(json.dumps(turns[-1]), flush=True)
    out = {"turns": turns, "mean": summary(turns)}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out["mean"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
