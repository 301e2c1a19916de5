"""Time the port's grouped salted and Kerberos kernels against the
per-target kernels they replaced, on one card, in turns (parent, this
tree, this tree, parent), each turn a process of its own:

    python3 tools/ab_grouped.py --parent DIR
        [--out ab_grouped.json]

DIR holds the per-target tree's ``dprf_tpu_torch`` package, commit
b8f2e92 (``git archive b8f2e92 dprf_tpu_torch | tar -x -C DIR``), the
last with one salted target and one ticket a launch; the phase split
patches that tree's csrc/krb5.cu.  A parent tree with the grouped
kernels, or a tree of its own without them, is refused: the A/B is
between the two designs.  Each turn builds its tree's csrc/ sources
with nvcc into the tree's own ``_build/`` at first use.  A turn
measures, on the tree it imports:

- the six salted cores per 2^24 hashes (a batch of 2^24 candidates of
  ?l^6, 11-byte salts): one target a launch on the parent, groups of 1,
  32 and 250 targets on a grouped tree;
- krb5 per 2^24 (candidate, ticket) pairs (2^24 of ?a^8): one ticket a
  launch on the parent, the Kerberoast's group of 100 on a grouped tree;
- on the parent only, the krb5 phase split: its kernel rebuilt with K3
  made from the decoded candidate and no hashing (RC4 alone) and with
  RC4 left out (the hashing alone), so the three times show whether the
  phases add up;
- ``crack --device cuda`` end to end: md5-ps over the whole ?l^6 against
  1,000 salted targets (salts of 2-32 bytes, 8 planted) and a Kerberoast
  of 100 tickets over 2^28 of ?a^8 (4 planted), wall clock.

Prints one JSON line per turn and, last, the turns together; writes
them to --out.  Needs a card: without one it exits 1.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

BATCH = 1 << 24
SALT = b"S4ltS4ltS4l"
SALT_GROUPS = (1, 32, 250)
TICKETS = 100
SWEEP_TARGETS = 1000
ROAST_WINDOW = 1 << 28
SEED = 20261018

#: the parent's krb5 kernel body lines the phase split replaces
KRB5_HASHING = """        uint32_t nt[4], k1[4], k3[4];
        Md4Core::digest(m, nt);
        hmac_md5<1>(nt, &args.msg_type, k1);
        hmac_md5<4>(k1, args.checksum, k3);
"""
KRB5_RC4 = "        const uint32_t plain = rc4_word2(s, k3) ^ args.cipher;\n"
KRB5_VARIANTS = {
    # K3 from the decoded candidate's words, no MD4 and no HMAC
    "rc4_only": (KRB5_HASHING, """        uint32_t k3[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
            k3[i] = m[i] * 0x9e3779b1u + args.checksum[i];
"""),
    # the hashing, no RC4: K3's words fold into the compared word
    "hash_only": (KRB5_RC4, "        const uint32_t plain = k3[0] ^ k3[1]"
                            " ^ k3[2] ^ k3[3] ^ args.cipher;\n"),
}


def _events(torch, fn, n: int, warm: int = 2) -> float:
    """ms a call of fn, CUDA events over n calls after warm-up."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def _krb5_line(rng, password: bytes, body_len: int) -> str:
    from dprf_tpu_torch.engines.cpu.krb5 import der, encrypt
    body = bytes(rng.integers(0, 256, body_len, dtype="uint8"))
    plain = bytes(rng.integers(0, 256, 8, dtype="uint8")) + \
        der(0x63, der(0x30, body))
    chk, edata = encrypt(password, 2, plain)
    return f"$krb5tgs$23$*svc$CORP.LOCAL$http/web*${chk.hex()}${edata.hex()}"


def _crack(cli, engine, mask, lines, window, skip=0) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        hashfile = os.path.join(tmp, "h.txt")
        with open(hashfile, "w") as fh:
            fh.write("".join(ln + "\n" for ln in lines))
        argv = ["crack", "--device", "cuda", "--engine", engine, mask,
                hashfile, "--no-potfile"]
        if skip:
            argv += ["--skip", str(skip), "--limit", str(window)]
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(argv)
        wall = time.perf_counter() - t0
    summary = [ln for ln in err.getvalue().splitlines()
               if "job finished" in ln]
    return {"rc": rc, "wall_s": wall, "found": len(out.getvalue()
                                                   .splitlines()),
            "summary": summary[0].split("job finished", 1)[1].strip()
            if summary else err.getvalue()[-500:]}


def _salted(torch, np, cuda_ext, get_engine, gen, lut, grouped) -> dict:
    out = {}
    start = 5 * BATCH
    for variant in cuda_ext.SALTED_NAMES:
        eng = get_engine(variant)
        dt = "<u4" if variant.startswith("md5") else ">u4"
        words = [int(w) for w in np.frombuffer(eng.hash_batch(
            [b"\0" * 9], params={"salt": SALT})[0], dt)]
        head = (variant, lut, gen.radices, gen.digits(start), BATCH)
        if not grouped:
            args = (*head, SALT, words, 64, BATCH)
            out[variant] = {"1": _events(
                torch, lambda: cuda_ext.salted_kernel(*args), 30)}
            continue
        out[variant] = {}
        for t in SALT_GROUPS:
            rows, shift = cuda_ext.salted_table(variant, gen.length,
                                                [(SALT, words)] * t, "cuda")
            args = (*head, shift, rows, 64, BATCH)
            out[variant][str(t)] = _events(
                torch, lambda: cuda_ext.salted_kernel(*args),
                max(3, 30 // t)) / t
    return out


def _krb5(torch, np, cuda_krb5, get_engine, gen, lut, grouped, rng) -> dict:
    t = get_engine("krb5tgs").parse_target(_krb5_line(rng, b"\0" * 9, 1200))
    tgt = cuda_krb5.target_kernel_args(t)
    start = 7 * BATCH
    if not grouped:
        args = (lut, gen.radices, gen.digits(start), BATCH, tgt, 64, BATCH)
        out = {"1": _events(torch, lambda: cuda_krb5.krb5_kernel(*args), 20)}
        lib0 = cuda_krb5._library
        for name, (old, new) in KRB5_VARIANTS.items():
            cuda_krb5._library = _variant_library(cuda_krb5, lib0(), name,
                                                  old, new)
            cuda_krb5.blocks_per_sm.cache_clear()
            out[name] = _events(torch, lambda: cuda_krb5.krb5_kernel(*args),
                                20)
        cuda_krb5._library = lib0
        cuda_krb5.blocks_per_sm.cache_clear()
        return out
    out = {}
    for n in (1, TICKETS):
        rows = torch.as_tensor(cuda_krb5.ticket_rows([tgt] * n)
                               .view(np.int32), device="cuda")
        args = (lut, gen.radices, gen.digits(start), BATCH, tgt.msg_type,
                rows, 64, BATCH)
        out[str(n)] = _events(torch, lambda: cuda_krb5.krb5_kernel(*args),
                              max(3, 20 // n)) / n
    return out


def _variant_library(cuda_krb5, lib, name, old, new):
    """The parent's krb5 kernel with ``old`` replaced by ``new``, built
    beside its source and loaded with the parent's C interface."""
    import ctypes

    from dprf_tpu_torch.ops import _build
    with open(os.path.join(_build.CSRC_DIR, "krb5.cu")) as fh:
        src = fh.read()
    if src.count(old) != 1:
        raise RuntimeError(f"krb5 variant {name}: the parent's source "
                           "does not hold the lines it replaces")
    with open(os.path.join(_build.CSRC_DIR, f"krb5_{name}.cu"), "w") as fh:
        fh.write(src.replace(old, new))
    var = ctypes.CDLL(_build.build(f"krb5_{name}").path)
    for fn in ("dprf_krb5_launch", "dprf_krb5_blocks_per_sm"):
        getattr(var, fn).argtypes = getattr(lib, fn).argtypes
        getattr(var, fn).restype = getattr(lib, fn).restype
    return lambda: var


def turn(tree: str, role: str) -> dict:
    """One turn's measurements on the package of ``tree``, the per-target
    design (``role`` "parent") or the grouped one ("new")."""
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    import dprf_tpu_torch
    from dprf_tpu_torch import cli, get_engine
    from dprf_tpu_torch.generators.mask import MaskGenerator
    from dprf_tpu_torch.ops import cuda_ext, cuda_krb5

    here = os.path.dirname(os.path.abspath(dprf_tpu_torch.__file__))
    if here != os.path.join(os.path.abspath(tree), "dprf_tpu_torch"):
        raise RuntimeError(f"imported {here}, not the tree {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("ab_grouped: no CUDA card")
    grouped = hasattr(cuda_ext, "salted_groups")
    if grouped != (role == "new"):
        raise SystemExit(f"ab_grouped: {tree} holds the "
                         f"{'grouped' if grouped else 'per-target'} kernels; "
                         f"its {role} turn needs the other design")
    rng = np.random.default_rng(SEED)
    g6, g8 = MaskGenerator("?l" * 6), MaskGenerator("?a" * 8)
    lut6, lut8 = g6.charset_lut("cuda"), g8.charset_lut("cuda")
    t0 = time.perf_counter()
    cuda_ext.load_kernel()
    cuda_krb5.load_kernel()
    res = {"tree": tree, "grouped": grouped,
           "build_s": time.perf_counter() - t0,
           "salted_ms_per_2e24": _salted(torch, np, cuda_ext, get_engine, g6,
                                         lut6, grouped),
           "krb5_ms_per_2e24": _krb5(torch, np, cuda_krb5, get_engine, g8,
                                     lut8, grouped, rng)}
    # phase 18's sweep and phase 26's Kerberoast through the CLI
    alnum = np.frombuffer(b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTU"
                          b"VWXYZ0123456789", np.uint8)
    oracle = get_engine("md5-ps")
    plants = sorted({g6.keyspace - 1,
                     *(int(x) for x in rng.integers(0, g6.keyspace - 1, 7))})
    lines = []
    for i in range(SWEEP_TARGETS):
        salt = bytes(rng.choice(alnum, int(rng.integers(2, 33))))
        plain = g6.candidate(plants[i]) if i < len(plants) else \
            bytes(rng.integers(33, 127, 8, dtype=np.uint8))
        d = oracle.hash_batch([plain], params={"salt": salt})[0]
        lines.append(f"{d.hex()}:{salt.decode()}")
    res["sweep_md5ps_1000"] = _crack(cli, "md5-ps", "?l" * 6, lines,
                                     g6.keyspace)
    skip = int(rng.integers(0, g8.keyspace - ROAST_WINDOW))
    idx = sorted({ROAST_WINDOW - 1,
                  *(int(x) for x in rng.integers(0, ROAST_WINDOW - 1, 3))})
    lines = [_krb5_line(rng, g8.candidate(skip + i),
                        int(rng.integers(990, 1490))) for i in idx]
    lines += [_krb5_line(rng, b"no-such-password%d" % i,
                         int(rng.integers(990, 1490)))
              for i in range(TICKETS - len(idx))]
    res["kerberoast_100"] = _crack(cli, "krb5tgs", "?a" * 8, lines,
                                   ROAST_WINDOW, skip)
    res["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="the parent tree (runs the turns)")
    ap.add_argument("--turn", help="run one turn on this tree")
    ap.add_argument("--role", choices=("parent", "new"), default="new",
                    help="the design --turn's tree must hold")
    ap.add_argument("--out", default="ab_grouped.json")
    args = ap.parse_args(argv)
    if args.turn:
        print(json.dumps(turn(args.turn, args.role)), flush=True)
        return 0
    if not args.parent:
        ap.error("--parent DIR is required")
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    parent = os.path.abspath(args.parent)
    turns = []
    for tree, role in ((parent, "parent"), (here, "new"), (here, "new"),
                       (parent, "parent")):
        # the file runs as a script, so the turn imports the package of
        # its tree alone
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--turn", tree,
             "--role", role],
            capture_output=True, text=True, cwd=tree)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        turns.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(turns[-1]), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(turns, fh, indent=1)
    print(json.dumps({"turns": [t["tree"] for t in turns]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
