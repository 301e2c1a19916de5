"""Time the SHA-512 rounds of ops/sha512.py (64-bit words as int64
tensors) against the same rounds on (hi, lo) int32 pairs, the
reference's form, over one batch of packed blocks; both are held to
hashlib first.

    python -m dprf_tpu_torch.tools.bench_word64 [--batch 65536]
        [--threads 1] [--device cpu]

Prints one JSON line: seconds per batch for each form, best of three.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time

import numpy as np
import torch

from dprf_tpu_torch.ops import sha512
from dprf_tpu_torch.ops.int32 import shr
from dprf_tpu_torch.ops.pack import pack_fixed_wide


def _c32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >> 31 else v


def _add(*xs):
    """(hi, lo) int32 pairs summed with one carry per addition."""
    hi, lo = xs[0]
    for h2, l2 in xs[1:]:
        nl = lo + l2
        # unsigned lo + l2 < lo: the carry, compared with the sign flipped
        carry = ((nl ^ -0x80000000) < (lo ^ -0x80000000)).to(torch.int32)
        hi, lo = hi + h2 + carry, nl
    return hi, lo


def _rotr(x, n: int):
    h, lo = x
    if n >= 32:
        h, lo, n = lo, h, n - 32
    if n == 0:
        return h, lo
    return (shr(h, n) | (lo << (32 - n)), shr(lo, n) | (h << (32 - n)))


def _shr(x, n: int):
    h, lo = x
    return shr(h, n), shr(lo, n) | (h << (32 - n))


def _xor(*xs):
    return (xs[0][0] ^ xs[1][0] ^ xs[2][0], xs[0][1] ^ xs[1][1] ^ xs[2][1])


def sha512_pairs(words: torch.Tensor) -> torch.Tensor:
    """The same digest as ``sha512.sha512_digest_words`` on (hi, lo)
    int32 pairs."""
    w = [(words[:, 2 * i], words[:, 2 * i + 1]) for i in range(16)]
    z = words[:, 0]

    def const(v):
        return (torch.full_like(z, _c32(v >> 32)),
                torch.full_like(z, _c32(v)))

    init = [const(v) for v in sha512.INIT512]
    a, b, c, d, e, f, g, h = init
    for t in range(80):
        if t >= 16:
            w15, w2 = w[(t - 15) % 16], w[(t - 2) % 16]
            s0 = _xor(_rotr(w15, 1), _rotr(w15, 8), _shr(w15, 7))
            s1 = _xor(_rotr(w2, 19), _rotr(w2, 61), _shr(w2, 6))
            w[t % 16] = _add(w[t % 16], s0, w[(t - 7) % 16], s1)
        ch = tuple((e[i] & f[i]) ^ (~e[i] & g[i]) for i in range(2))
        t1 = _add(h, _xor(_rotr(e, 14), _rotr(e, 18), _rotr(e, 41)), ch,
                  const(sha512.K[t]), w[t % 16])
        maj = tuple((a[i] & b[i]) ^ (a[i] & c[i]) ^ (b[i] & c[i])
                    for i in range(2))
        a_next = _add(t1, _xor(_rotr(a, 28), _rotr(a, 34), _rotr(a, 39)),
                      maj)
        a, b, c, d, e, f, g, h = a_next, a, b, c, _add(d, t1), e, f, g
    out = [_add(x, i) for x, i in zip((a, b, c, d, e, f, g, h), init)]
    return torch.stack([x for pair in out for x in pair], dim=-1)


def _best(fn, words, repeats: int = 3) -> float:
    times = []
    for _ in range(repeats):
        if words.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(words)
        if words.device.type == "cuda":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return min(times)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=1 << 16)
    p.add_argument("--threads", type=int, default=1)
    p.add_argument("--device", default="cpu")
    args = p.parse_args(argv)
    torch.set_num_threads(args.threads)
    rng = np.random.default_rng(0)
    cand = torch.as_tensor(rng.integers(97, 123, (args.batch, 7),
                                        dtype=np.uint8), device=args.device)
    words = pack_fixed_wide(cand, 7)
    want = hashlib.sha512(cand[0].cpu().numpy().tobytes()).digest()
    for fn in (sha512.sha512_digest_words, sha512_pairs):
        got = fn(words[:1]).cpu().numpy().astype(">i4").tobytes()
        if got != want:
            raise SystemExit(f"{fn.__name__} disagrees with hashlib")
    res = {"batch": args.batch, "device": args.device,
           "threads": args.threads,
           "int64_s": _best(sha512.sha512_digest_words, words),
           "pairs_s": _best(sha512_pairs, words)}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
