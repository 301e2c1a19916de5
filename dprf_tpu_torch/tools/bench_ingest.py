"""Time the host half of a bulk target list: parsing N NTLM hashlist
lines (``utils/hashlist.parse_lines``, through ``TargetStore``), sorting
the digest table and filling the probe bitmap
(``targets/probe.build_probe_table``), on the CPU.

    python -m dprf_tpu_torch.tools.bench_ingest [--lines 1000000]
        [--seed 0]

The lines are random 16-byte digests in hex, made from the seed.  Prints
one JSON line: the seconds of each step, best of three.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from dprf_tpu_torch import get_engine
from dprf_tpu_torch.targets import TargetStore, probe


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m "
                                "dprf_tpu_torch.tools.bench_ingest")
    p.add_argument("--lines", type=int, default=10 ** 6)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    rng = np.random.default_rng(args.seed)
    lines = [r.tobytes().hex() + "\n" for r in rng.integers(
        0, 1 << 32, (args.lines, 4), dtype=np.uint32)]
    engine = get_engine("ntlm", "cpu")
    parse, build = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        store = TargetStore.from_lines(engine, lines)
        parse.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        pt = probe.build_probe_table([t.digest for t in store.targets])
        build.append(time.perf_counter() - t0)
    print(json.dumps({"lines": args.lines, "targets": len(store),
                      "parse_s": min(parse), "table_bitmap_s": min(build),
                      "bitmap_bytes": int(pt.bits.nbytes), "k": pt.k,
                      "fp_est": pt.fp_est, "device": "cpu"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
