"""The command-line interface of the port: ``python -m dprf_tpu_torch``.

Subcommands: crack (a local mask or wordlist+rules job), bench
(candidates/s of the mask worker), engines, keyspace.  Devices:

- ``cuda`` (the default): the hand-written CUDA kernels on the card
  (the mask kernel, the rule kernel, the PMKID and KDF kernels, the
  bcrypt kernels, the Kerberos RC4 kernel, the 7-Zip KDF kernel, the
  PDF kernel);
- ``torch-cpu``: the same workers on CPU tensors, running the kernels'
  plain PyTorch versions;
- ``cpu``: the CPU oracle (hashlib; a pure-Python MD4 for ntlm).

``--device cuda`` without a card is an error, never a quiet move to
the CPU.  ``crack --devices N`` shards a mask job of a kernel core over
N cards (N CPU shards on ``torch-cpu``), one process over the list.
``crack --targets-file FILE`` takes a bulk target list in place of the
hashfile positional (targets/store.TargetStore: deduplicated, malformed
lines reported, a fingerprint of the set); a list past
``cuda_mask.N_BULK`` targets runs the kernels' bulk probe on one card.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

from dprf_tpu_torch import engine_names, get_engine
from dprf_tpu_torch.generators.mask import MaskGenerator
from dprf_tpu_torch.utils.logging import Log

ATTACKS = ("mask", "wordlist")

DEVICES = ("cuda", "torch-cpu", "cpu")
#: default step batch per device, in candidates: a launch of 2^24 keeps
#: the card busy for about a millisecond; CPU tensors want far smaller
#: steps.  A wordlist step covers batch // n_rules words (rounded down
#: to a multiple of 32) under every rule
DEFAULT_BATCH = {"cuda": 1 << 24, "torch-cpu": 1 << 14, "cpu": 1 << 14}
#: default WorkUnit size, in batches
UNIT_BATCHES = 16


def _add_custom_charsets(c) -> None:
    for i in range(1, 5):
        c.add_argument(f"--custom{i}", default=None,
                       help=f"custom charset ?{i}")


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m dprf_tpu_torch",
        description="password recovery on an NVIDIA card (PyTorch/CUDA)")
    sub = p.add_subparsers(dest="command", required=True)

    c = sub.add_parser("crack", help="run a recovery job locally")
    c.add_argument("attack_arg", help="mask string, or the wordlist file "
                   "(-a wordlist)")
    c.add_argument("hashfile", nargs="?", default=None,
                   help="file of target hashes (or use --targets-file)")
    c.add_argument("--targets-file", default=None, metavar="FILE",
                   help="bulk target list (hashcat-style hash[:salt] lines; "
                   "deduplicated, malformed lines reported; a list past "
                   "2,048 targets runs the bulk probe on one card)")
    c.add_argument("--engine", "-m", required=True,
                   help="hash algorithm (see `engines`)")
    c.add_argument("--device", default="cuda", choices=DEVICES,
                   help="cuda: the CUDA kernel on the card (default); "
                   "torch-cpu: the kernel's plain version on CPU tensors; "
                   "cpu: the CPU oracle")
    c.add_argument("--devices", type=int, default=1,
                   help="shard a mask job over N cards, a keyspace slice "
                   "each (clamped to the cards present; N CPU shards on "
                   "torch-cpu; the md5, ntlm, sha1, sha256, sha384 and "
                   "sha512 kernels)")
    c.add_argument("-a", "--attack", default="mask", choices=ATTACKS,
                   help="attack mode: mask, or wordlist (with --rules)")
    c.add_argument("--rules", default=None,
                   help="rule set for -a wordlist: a built-in name "
                   "(best64, dprf64, leetspeak, toggle) or a file")
    _add_custom_charsets(c)
    c.add_argument("--potfile", default="dprf.potfile")
    c.add_argument("--no-potfile", action="store_true")
    c.add_argument("--batch", type=int, default=None,
                   help="candidates per device step (default 2^24 on "
                   "cuda, 2^14 on the CPU)")
    c.add_argument("--unit-size", type=int, default=None,
                   help=f"keyspace indices per WorkUnit (default "
                   f"{UNIT_BATCHES} of the worker's steps)")
    c.add_argument("--hit-cap", type=int, default=64,
                   help="hit lanes a step reports before the batch goes "
                   "to the exact oracle rescan")
    c.add_argument("--skip", type=int, default=0, metavar="N",
                   help="skip the first N keyspace indices")
    c.add_argument("--limit", type=int, default=None, metavar="N",
                   help="restrict the sweep to N indices after --skip")
    c.add_argument("--quiet", "-q", action="store_true")

    b = sub.add_parser("bench", help="measure the mask worker's "
                       "candidates/s")
    b.add_argument("--engine", "-m", default="md5")
    b.add_argument("--mask", default="?a?a?a?a?a?a?a?a")
    b.add_argument("--device", default="cuda",
                   choices=("cuda", "torch-cpu"))
    b.add_argument("--seconds", type=float, default=5.0)
    b.add_argument("--quiet", "-q", action="store_true")

    e = sub.add_parser("engines", help="list available engines")
    e.add_argument("--device", default=None, choices=("cpu", "cuda"))
    e.add_argument("--quiet", "-q", action="store_true")

    k = sub.add_parser("keyspace", help="print the keyspace size of an "
                       "attack (mask, wordlist+rules)")
    k.add_argument("attack_arg", metavar="mask_or_wordlist")
    k.add_argument("-a", "--attack", default="mask", choices=ATTACKS)
    k.add_argument("--rules", default=None)
    k.add_argument("--max-len", type=int, default=55,
                   help="longest word of -a wordlist")
    _add_custom_charsets(k)
    k.add_argument("--quiet", "-q", action="store_true")
    return p


def _customs(args) -> dict:
    out = {}
    for i in range(1, 5):
        v = getattr(args, f"custom{i}", None)
        if v is not None:
            out[i] = v.encode("latin-1")
    return out


def _torch_device(device: str) -> str:
    """CLI device -> torch device; ``cuda`` needs a card."""
    import torch
    if device == "cuda":
        if not torch.cuda.is_available():
            raise ValueError(
                "--device cuda needs an NVIDIA card and torch finds none "
                "(torch.cuda.is_available() is False); pass --device "
                "torch-cpu or --device cpu to run on the CPU")
        return "cuda"
    return "cpu"


def _wordlist_max_len(engine) -> int:
    """Longest word of a wordlist job: the engine's single-block limit
    (55 bytes; 27 characters for ntlm's UTF-16LE), the same on every
    device, so a job's keyspace does not depend on where it runs."""
    return engine.max_candidate_len


def _build_gen(attack: str, attack_arg: str, args, max_len: int, log: Log):
    """The job's candidate generator: a mask, or a wordlist file under
    the --rules set."""
    if attack == "mask":
        gen = MaskGenerator(attack_arg, custom=_customs(args) or None)
        log.info("keyspace", mask=attack_arg, size=gen.keyspace)
        return gen
    from dprf_tpu_torch.generators.wordlist import WordlistRulesGenerator
    gen = WordlistRulesGenerator.from_files(attack_arg, args.rules,
                                            max_len=max_len)
    if gen.n_skipped_long:
        log.warn("skipped overlong words", count=gen.n_skipped_long,
                 max_len=max_len)
    log.info("keyspace", words=gen.n_words, rules=gen.n_rules,
             size=gen.keyspace)
    return gen


def _unit_size(args, worker, gen, batch: int) -> int:
    """--unit-size, or UNIT_BATCHES of the worker's own step (its
    ``stride``: an engine that caps its batch, as PMKID and bcrypt do,
    gets units of its own steps, not of --batch), in units of whole
    words for a wordlist, so no candidate is hashed twice at a unit
    boundary on the device path."""
    unit_size = args.unit_size or \
        UNIT_BATCHES * getattr(worker, "stride", batch)
    if args.attack != "wordlist":
        return unit_size
    return max(gen.n_rules, (unit_size // gen.n_rules) * gen.n_rules)


def _mesh(tdev: str, n_devices: int, log: Log) -> list:
    """The mesh of ``--devices N``: cuda:0..N-1, clamped to the cards
    present with the reference's warning, or N CPU shards."""
    import torch

    from dprf_tpu_torch.parallel import make_mesh
    if tdev != "cuda":
        return make_mesh(devices=[tdev] * n_devices)
    have = torch.cuda.device_count()
    if have < n_devices:
        log.warn("host has fewer devices than requested; clamping the "
                 "mesh", requested=n_devices, have=have)
        n_devices = have
    return make_mesh(n_devices)


def _make_worker(args, tdev, gen, targets, oracle, batch: int, log: Log):
    """The oracle's CpuWorker for tdev None, else the torch engine's
    mask or wordlist worker on torch device tdev, or its sharded mask
    worker for ``--devices`` above 1."""
    from dprf_tpu_torch.runtime.worker import CpuWorker
    if tdev is None:
        return CpuWorker(oracle, gen, targets)
    if args.devices < 1:
        raise ValueError(f"--devices {args.devices}: at least 1")
    dev = get_engine(args.engine, device="cuda", torch_device=tdev)
    mesh = _mesh(tdev, args.devices, log) if args.devices > 1 else None
    if mesh is not None and len(mesh) > 1:
        make = getattr(dev, "make_sharded_mask_worker", None)
        if make is None or args.attack != "mask":
            raise ValueError(
                f"{args.engine}: no sharded {args.attack} worker on "
                f"--devices {args.devices} yet; run it with --devices 1")
        log.info("mesh", devices=len(mesh))
        return make(gen, targets, mesh, batch, hit_capacity=args.hit_cap,
                    oracle=oracle)
    make = dev.make_wordlist_worker if args.attack == "wordlist" \
        else dev.make_mask_worker
    return make(gen, targets, batch=batch, hit_capacity=args.hit_cap,
                oracle=oracle)


def _make_dispatcher(args, keyspace: int, unit_size: int, log: Log):
    """--skip/--limit restrict this run's sweep by pre-marking the
    excluded ranges covered."""
    from dprf_tpu_torch.runtime.dispatcher import Dispatcher
    skip = min(args.skip or 0, keyspace)
    excluded = []
    if skip:
        excluded.append((0, skip))
        log.info("skipping keyspace prefix", skip=skip)
    if args.limit is not None and skip + args.limit < keyspace:
        excluded.append((skip + args.limit, keyspace))
        log.info("limiting sweep", limit=args.limit)
    if excluded:
        return Dispatcher.from_completed(keyspace, unit_size, excluded)
    return Dispatcher(keyspace, unit_size)


def _load_job_targets(args, engine, log: Log):
    """The job's targets from the hashfile positional or the bulk
    ``--targets-file`` (a ``TargetStore``, its ingest report logged):
    (an object with ``targets`` and ``line_numbers``, the file's path),
    or None on an error already logged (the reference's either-or
    rules)."""
    from dprf_tpu_torch.targets import TargetStore
    from dprf_tpu_torch.utils.hashlist import load_hashlist
    t0 = time.perf_counter()
    if args.targets_file is not None:
        if args.hashfile is not None:
            log.error("pass a hashfile positional OR --targets-file, "
                      "not both")
            return None
        store = TargetStore.from_file(engine, args.targets_file, log=log)
        if not store.targets:
            log.error("no valid targets in targets file",
                      path=args.targets_file)
            return None
        report = store.report()
        log.info("target set", targets=report["targets"],
                 duplicates=report["duplicates"],
                 malformed=len(report["malformed"]),
                 fingerprint=report["fingerprint"],
                 parse_s=f"{time.perf_counter() - t0:.3f}")
        return store, args.targets_file
    if args.hashfile is None:
        log.error("no target hashes: pass a hashfile or --targets-file")
        return None
    hl = load_hashlist(engine, args.hashfile)
    for no, _, err in hl.skipped:
        log.warn("skipping hashlist line", line=no, error=err)
    if not hl.targets:
        log.error("no valid targets in hashlist")
        return None
    log.info("loaded targets", count=len(hl.targets),
             duplicates=hl.duplicates, engine=engine.name,
             parse_s=f"{time.perf_counter() - t0:.3f}")
    return hl, args.hashfile


def cmd_crack(args, log: Log) -> int:
    from dprf_tpu_torch.engines.base import TargetRefused
    from dprf_tpu_torch.runtime.coordinator import Coordinator, JobSpec
    from dprf_tpu_torch.runtime.potfile import Potfile, encode_plain

    device = args.device
    # resolved first: --device cuda without a card fails before set-up
    tdev = None if device == "cpu" else _torch_device(device)
    oracle = get_engine(args.engine, device="cpu")
    loaded = _load_job_targets(args, oracle, log)
    if loaded is None:
        return 2
    hl, path = loaded
    gen = _build_gen(args.attack, args.attack_arg, args,
                     _wordlist_max_len(oracle), log)
    batch = args.batch or DEFAULT_BATCH[device]
    t0 = time.perf_counter()
    try:
        worker = _make_worker(args, tdev, gen, hl.targets, oracle, batch,
                              log)
    except TargetRefused as e:
        raise ValueError(f"{path} line "
                         f"{hl.line_numbers[e.target_index]}: {e}") from None
    setup = time.perf_counter() - t0
    unit_size = _unit_size(args, worker, gen, batch)
    dispatcher = _make_dispatcher(args, gen.keyspace, unit_size, log)
    _log_table(worker, log)
    log.info("worker", kind=type(worker).__name__, device=device,
             batch=getattr(worker, "batch", batch), unit_size=unit_size,
             setup_s=f"{setup:.3f}")
    potfile = None if args.no_potfile else Potfile(args.potfile)

    def progress(done, total, nfound, rate):
        log.info("progress", pct=f"{100.0 * done / total:.2f}%",
                 found=f"{nfound}/{len(hl.targets)}",
                 rate=f"{rate:,.0f}/s")

    spec = JobSpec(engine=oracle.name, device=device, attack=args.attack,
                   attack_arg=args.attack_arg, keyspace=gen.keyspace)
    coord = Coordinator(spec, hl.targets, dispatcher, worker,
                        potfile=potfile,
                        progress_cb=None if args.quiet else progress,
                        # device hits are re-hashed by the oracle before
                        # the potfile; the CPU worker IS the oracle
                        oracle=oracle if device != "cpu" else None,
                        log=log)
    coord.preload_found()
    if coord.found:
        log.info("pre-cracked targets", count=len(coord.found))
    result = coord.run()
    for ti, plain in sorted(result.found.items()):
        print(f"{hl.targets[ti].raw}:{encode_plain(plain)}")
    log.info("job finished",
             found=f"{len(result.found)}/{len(hl.targets)}",
             tested=result.tested, elapsed=f"{result.elapsed:.3f}s",
             rate=f"{result.rate:,.0f}/s", exhausted=result.exhausted,
             rejected=result.rejected,
             batches=getattr(worker, "dispatched", 0),
             **_relaunches(worker), **_windows(worker), **_maybes(worker))
    return 0 if result.found else 1


def _log_table(worker, log: Log) -> None:
    """A bulk list's probe table: its layout, size and build seconds."""
    pt = getattr(worker, "probe_table", None)
    if pt is not None:
        log.info("probe table", targets=pt.num_targets, mode=pt.mode,
                 bits=16 * 32 << pt.block_bits, k=pt.k,
                 fp=f"{pt.fp_est:.3e}", mbytes=f"{pt.nbytes / 1e6:.3f}",
                 build_s=f"{worker.table_seconds:.3f}")


def _relaunches(worker) -> dict:
    """A kernel worker's overflowing dispatches relaunched on the card,
    the oracle rescans their relaunches could not spare, and the
    host-verify survivors the oracle rejected, for the summary."""
    if not hasattr(worker, "relaunches"):
        return {}
    out = {"relaunches": worker.relaunches, "rescans": worker.rescans}
    table = getattr(worker, "probe_table", None)
    if table is not None and table.table is None:
        out["host_rejected"] = worker.rejected_survivors
    return out


def _windows(worker) -> dict:
    """The loop-superstep windows a mask worker queued, for the
    summary: ``windows=`` (and ``shards=`` over several devices)."""
    out = {}
    if hasattr(worker, "windows"):
        out["windows"] = worker.windows
    if len(getattr(worker, "mesh", ())) > 1:
        out["shards"] = len(worker.mesh)
    return out


def _maybes(worker) -> dict:
    """A multi-target kernel worker's prefilter survivors (the mask
    and the rules kernel's lists), or a prefilter worker's maybes the
    oracle rejected (Kerberos), for the summary."""
    n = worker.n_maybe() if hasattr(worker, "n_maybe") else None
    return {} if n is None else {"maybes": n}


def cmd_bench(args, log: Log) -> int:
    """Sweep the mask's keyspace from index 0 through the worker's step
    for --seconds against a target no candidate of the mask can hit
    (the engine's digest of a longer string), and print candidates/s."""
    import json
    import time

    import torch

    from dprf_tpu_torch.engines.base import Target

    tdev = _torch_device(args.device)
    gen = MaskGenerator(args.mask)
    batch = min(DEFAULT_BATCH[args.device], gen.keyspace)
    oracle = get_engine(args.engine, device="cpu")
    if oracle.salted:
        raise ValueError(f"bench measures the unsalted mask engines; "
                         f"{oracle.name} runs through crack")
    miss = oracle.hash_batch([b"\0" * (gen.length + 1)])[0]
    dev = get_engine(args.engine, device="cuda", torch_device=tdev)
    worker = dev.make_mask_worker(gen, [Target(miss.hex(), miss)],
                                  batch=batch, hit_capacity=64,
                                  oracle=oracle)
    sync = torch.cuda.synchronize if tdev == "cuda" else (lambda: None)
    worker.step(gen.digits(0), batch)          # warm-up
    sync()
    pos, tested, hits = 0, 0, None
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        n_valid = min(batch, gen.keyspace - pos)
        count, _, _ = worker.step(gen.digits(pos), n_valid)
        hits = count if hits is None else hits + count
        tested += n_valid
        pos = (pos + n_valid) % gen.keyspace
    sync()
    elapsed = time.perf_counter() - t0
    res = {"engine": args.engine, "device": args.device,
           "device_name": (torch.cuda.get_device_name(0)
                           if tdev == "cuda" else "cpu"),
           "worker": type(worker).__name__, "mask": args.mask,
           "batch": batch, "candidates": tested, "seconds": elapsed,
           "rate": tested / elapsed,
           "hits": 0 if hits is None else int(hits.item())}
    print(json.dumps(res))
    return 0


def cmd_engines(args, log: Log) -> int:
    for dev in [args.device] if args.device else ["cpu", "cuda"]:
        print(f"{dev}: {', '.join(engine_names(dev))}")
    return 0


def cmd_keyspace(args, log: Log) -> int:
    print(_build_gen(args.attack, args.attack_arg, args, args.max_len,
                     log).keyspace)
    return 0


_COMMANDS = {
    "crack": cmd_crack,
    "bench": cmd_bench,
    "engines": cmd_engines,
    "keyspace": cmd_keyspace,
}


def main(argv: Optional[list] = None) -> int:
    args = _build_parser().parse_args(argv)
    log = Log(quiet=getattr(args, "quiet", False))
    try:
        return _COMMANDS[args.command](args, log)
    except (ValueError, KeyError, OSError) as e:
        log.error(str(e))
        return 2


if __name__ == "__main__":
    sys.exit(main())
