#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (dprf_tpu_torch) on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

It drives the port's main path -- benchmark config 1, an MD5 mask
attack ``?l?l?l?l?l?l`` on one target, at its full keyspace of
308,915,776 candidates -- through the CLI a user calls, on the card:

1. the card: name, device count, power limit;
2. builds the CUDA kernel from the checkout's sources and prints
   nvcc's register / shared memory / spill lines;
3. holds the kernel against its plain PyTorch version on the card, with
   exact equality of the hit count and of the sorted hit lanes, at a
   batch of 2^24 in five cases (first lane, last valid lane of a partial
   batch, no hit, ?a^8 from a random base, hit capacity 0), and checks
   that a worker with hit capacity 0 recovers the hit by its rescan;
4. cracks md5("zzzzzz") -- the last keyspace index, so the whole
   keyspace is swept -- with ``crack --device cuda`` and checks the
   plaintext, the potfile line, the oracle's verdict and that the
   kernel's launch count equals the batches the worker dispatched;
5. times the kernel per launch with CUDA events, the plain version for
   one launch, and the CLI's ``bench`` on ?a^8, beside the bound;
6. prints the kernels line and, last, the device line.

Any failure exits non-zero before the last line.  Without a card it
exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

BATCH = 1 << 24
MASK_CONFIG1 = "?l?l?l?l?l?l"
MASK_BENCH = "?a?a?a?a?a?a?a?a"
SEED = 20261016
#: launches between the CUDA events of one kernel timing
TIMED_LAUNCHES = 50
#: INT32 lanes per SM on Hopper (the bound's issue rate)
INT32_LANES_PER_SM = 64


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi(fields: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def md5_words(plain: bytes):
    import numpy as np
    return np.frombuffer(hashlib.md5(plain).digest(), "<u4").astype(np.uint32)


def kernel_vs_plain(cuda_mask, gen, lut, start: int, n_valid: int,
                    target, hit_capacity: int, want_count: int,
                    want_lanes, name: str) -> int:
    """One case on the card: the kernel and the plain version on the
    same inputs; returns the largest absolute difference (0 = equal)."""
    import torch
    args = (lut, gen.radices, gen.digits(start), n_valid,
            [int(w) for w in target], hit_capacity, BATCH)
    kc, kl = cuda_mask.mask_md5_kernel(*args)
    pc, pl = cuda_mask.mask_crack_plain(*args)
    torch.cuda.synchronize()
    kc, pc = int(kc.item()), int(pc.item())
    kl = sorted(int(x) for x in kl.cpu().tolist())
    pl = sorted(int(x) for x in pl.cpu().tolist())
    err = max([abs(kc - pc)] + [abs(a - b) for a, b in zip(kl, pl)])
    print(f"  {name}: kernel count={kc} lanes={[x for x in kl if x >= 0]}"
          f" | plain count={pc} lanes={[x for x in pl if x >= 0]}",
          flush=True)
    check(kc == pc and kl == pl, f"{name}: kernel and plain version differ")
    check(kc == want_count, f"{name}: count {kc}, expected {want_count}")
    check([x for x in kl if x >= 0] == sorted(want_lanes),
          f"{name}: lanes {kl}, expected {sorted(want_lanes)}")
    return err


def time_kernel(cuda_mask, gen, lut, target) -> float:
    """ms per launch at BATCH lanes, CUDA events over TIMED_LAUNCHES
    launches after warm-up."""
    import torch
    args = (lut, gen.radices, gen.digits(0), BATCH,
            [int(w) for w in target], 64, BATCH)
    for _ in range(3):
        cuda_mask.mask_md5_kernel(*args)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(TIMED_LAUNCHES):
        cuda_mask.mask_md5_kernel(*args)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / TIMED_LAUNCHES


def time_plain(cuda_mask, gen, lut, target) -> float:
    """ms of one plain-version call at BATCH lanes on the card."""
    import torch
    args = (lut, gen.radices, gen.digits(0), BATCH,
            [int(w) for w in target], 64, BATCH)
    cuda_mask.mask_crack_plain(*args)          # warm-up (allocator)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    cuda_mask.mask_crack_plain(*args)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1)


def run_cli(cli, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA card: torch.cuda.is_available() is False")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dprf_tpu_torch import cli
    from dprf_tpu_torch.engines.base import Target
    from dprf_tpu_torch.engines.cpu.engines import Md5Engine
    from dprf_tpu_torch.engines.device.engines import TorchMd5Engine
    from dprf_tpu_torch.generators.mask import MaskGenerator
    from dprf_tpu_torch.ops import _build, cuda_mask
    from dprf_tpu_torch.runtime.worker import CudaMaskWorker
    from dprf_tpu_torch.runtime.workunit import WorkUnit

    # 1. the card
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = nvidia_smi("name,power.limit")
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"== card: {name}  devices={count}  torch={torch.__version__} "
          f"cuda={torch.version.cuda}", flush=True)
    print(card, flush=True)
    print(f"  SMs={sms}  max SM clock={clock_mhz:.0f} MHz", flush=True)

    # 2. the kernel build
    built = _build.build("mask_md5")
    cuda_mask.load_kernel()
    print(f"== build: {built.path} ({built.seconds:.1f} s)", flush=True)
    for line in built.log.splitlines():
        if "ptxas info" in line or "spill" in line:
            print("  " + line.strip(), flush=True)
    census = _build.sass_census("mask_md5")
    top = ", ".join(f"{op} {n}" for op, n in
                    list(census["by_opcode"].items())[:12])
    print(f"  SASS (cuobjdump, static): {census['total']} instructions "
          f"({top}); from the first K-table load to the atomic (the 64 "
          f"MD5 steps and the compare): "
          f"{census['constant_to_atomic_block']}", flush=True)

    # 3. kernel vs plain on the card
    print(f"== kernel vs plain at batch {BATCH} (exact equality)",
          flush=True)
    rng = np.random.default_rng(SEED)
    g6 = MaskGenerator(MASK_CONFIG1)
    lut6 = g6.charset_lut("cuda")
    g8 = MaskGenerator(MASK_BENCH)
    lut8 = g8.charset_lut("cuda")
    errs = []
    s = 5 * BATCH
    errs.append(kernel_vs_plain(cuda_mask, g6, lut6, s, BATCH,
                                md5_words(g6.candidate(s)), 64, 1, [0],
                                "?l^6 hit at lane 0"))
    s = (g6.keyspace // BATCH) * BATCH
    nv = g6.keyspace - s
    errs.append(kernel_vs_plain(cuda_mask, g6, lut6, s, nv,
                                md5_words(g6.candidate(g6.keyspace - 1)),
                                64, 1, [nv - 1],
                                f"?l^6 hit at last valid lane, n_valid={nv}"))
    errs.append(kernel_vs_plain(cuda_mask, g6, lut6, 7 * BATCH, BATCH,
                                md5_words(b"\0" * 7), 64, 0, [],
                                "?l^6 no hit"))
    s = int(rng.integers(0, g8.keyspace - BATCH))
    lane = int(rng.integers(0, BATCH))
    errs.append(kernel_vs_plain(cuda_mask, g8, lut8, s, BATCH,
                                md5_words(g8.candidate(s + lane)), 64, 1,
                                [lane], f"?a^8 random base {s}"))
    s = 11 * BATCH
    errs.append(kernel_vs_plain(cuda_mask, g6, lut6, s, BATCH,
                                md5_words(g6.candidate(s + 12345)), 0, 1,
                                [], "?l^6 hit_capacity=0"))
    # the worker's overflow contract: count 1 > capacity 0 -> rescan
    plant = s + 12345
    digest = hashlib.md5(g6.candidate(plant)).digest()
    w = CudaMaskWorker(TorchMd5Engine(), g6, [Target(digest.hex(), digest)],
                       batch=BATCH, hit_capacity=0, oracle=Md5Engine())
    hits = w.process(WorkUnit(0, plant - 100, 4096))
    check([(h.cand_index, h.plaintext) for h in hits]
          == [(plant, g6.candidate(plant))],
          f"hit_capacity=0 worker rescan returned {hits}")
    print(f"  worker rescan with hit_capacity=0 found {hits[0].plaintext!r}"
          f" at {plant}", flush=True)
    max_err = max(errs)

    # 4. end to end: the CLI sweeps the whole ?l^6 keyspace on the card
    print("== end to end: crack --device cuda -a mask ?l?l?l?l?l?l",
          flush=True)
    plain = g6.candidate(g6.keyspace - 1)
    h = hashlib.md5(plain).hexdigest()
    unit = cli.UNIT_BATCHES * BATCH
    want_batches = sum(-(-min(unit, g6.keyspace - u) // BATCH)
                       for u in range(0, g6.keyspace, unit))
    with tempfile.TemporaryDirectory() as tmp:
        hashfile = os.path.join(tmp, "hashes.txt")
        pot = os.path.join(tmp, "e2e.potfile")
        with open(hashfile, "w") as fh:
            fh.write(h + "\n")
        cuda_mask.mask_md5_kernel.launches = 0
        t0 = time.perf_counter()
        rc, out, err = run_cli(cli, [
            "crack", "--device", "cuda", "--engine", "md5", "-a", "mask",
            MASK_CONFIG1, hashfile, "--potfile", pot,
            "--batch", str(BATCH)])
        elapsed = time.perf_counter() - t0
        launches = cuda_mask.mask_md5_kernel.launches
        with open(pot) as fh:
            pot_text = fh.read()
    sys.stdout.write(out)
    sys.stdout.write(err)
    check(rc == 0, f"crack exited {rc}")
    check(f"{h}:{plain.decode()}" in out.splitlines(),
          "crack did not print the plaintext")
    check(pot_text == f"{h}:{plain.decode()}\n",
          f"potfile holds {pot_text!r}")
    finished = [ln for ln in err.splitlines() if "job finished" in ln]
    check(len(finished) == 1 and "rejected=0" in finished[0]
          and "found=1/1" in finished[0]
          and f"tested={g6.keyspace}" in finished[0],
          f"job summary: {finished}")
    check(f"batches={want_batches}" in finished[0],
          f"worker dispatched other than {want_batches} batches")
    check(launches == want_batches,
          f"kernel launched {launches} times for {want_batches} batches")
    print(f"  found {plain!r} over {g6.keyspace} candidates in "
          f"{elapsed:.3f} s = {g6.keyspace / elapsed:,.0f} candidates/s "
          f"(wall clock of the CLI call, host setup included); "
          f"kernel launches={launches} batches={want_batches}; "
          f"card: {card}", flush=True)

    # 5. timing and the CLI bench
    print("== timing at batch 2^24 (CUDA events)", flush=True)
    miss = md5_words(b"\0" * 9)
    ms6 = time_kernel(cuda_mask, g6, lut6, miss)
    ms8 = time_kernel(cuda_mask, g8, lut8, miss)
    plain_ms = time_plain(cuda_mask, g6, lut6, miss)
    rate = sms * INT32_LANES_PER_SM * clock_mhz * 1e6
    bound6 = BATCH * cuda_mask.ops_per_candidate(6) / rate * 1e3
    bound8 = BATCH * cuda_mask.ops_per_candidate(8) / rate * 1e3
    for mask, ms, bound in ((MASK_CONFIG1, ms6, bound6),
                            (MASK_BENCH, ms8, bound8)):
        print(f"  kernel {mask}: {ms:.4f} ms/launch = "
              f"{BATCH / ms / 1e6:.3f} G candidates/s; bound {bound:.4f} ms"
              f" ({bound / ms:.1%} of it); card: {card}", flush=True)
    print(f"  plain version {MASK_CONFIG1}: {plain_ms:.3f} ms for one "
          f"launch of {BATCH}", flush=True)
    print(f"  bound: {cuda_mask.ops_per_candidate(6)} int32 ops/candidate "
          f"(?l^6) / ({sms} SMs x {INT32_LANES_PER_SM} lanes x "
          f"{clock_mhz:.0f} MHz)", flush=True)
    rc, out, err = run_cli(cli, ["bench", "--engine", "md5", "--mask",
                                 MASK_BENCH, "--device", "cuda",
                                 "--seconds", "2"])
    sys.stdout.write(out)
    check(rc == 0, f"bench exited {rc}: {err}")
    bench = json.loads(out.strip().splitlines()[-1])
    check(bench["hits"] == 0, "bench found a hit on an unreachable target")

    # 6. the kernels line, then the device line
    print(json.dumps({"kernels": [{
        "name": "md5_mask", "route": "cuda", "source": cuda_mask.SOURCE,
        "replaces": cuda_mask.REPLACES, "launches": launches,
        "max_abs_err": max_err, "ms": ms6, "plain_ms": plain_ms,
        "bound_ms": bound6, "bound_by": "operations",
        "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": name,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
