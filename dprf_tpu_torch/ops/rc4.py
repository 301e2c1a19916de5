"""RC4 keystream prefix on torch tensors, over a batch of per-candidate
keys: the counterpart of the JAX package's ops/rc4.py, and the RC4 of
the Kerberos kernel's plain version (ops/cuda_krb5.py).

The Kerberos etype-23 filter needs only the first few keystream words
(the DER header of the decrypted ticket sits at bytes 8-11, after the
RFC 4757 confounder), so this stops after the KSA and a short PRGA.

The 256-entry state of every candidate is one row of an int32[B, 256]
tensor.  The swap at the loop counter is a column read and write (the
counter is the same for every lane); the data-dependent side is a
per-row gather and scatter at j.  The scatter at j lands after the
write at i, so a lane whose j equals i keeps the right byte.  The KSA's
256 chained swaps run in order; the batch dimension is the parallelism.
"""

from __future__ import annotations

import torch


def words_to_bytes(words: torch.Tensor) -> torch.Tensor:
    """int32[B, W] little-endian words -> int32[B, 4W] bytes."""
    B, W = words.shape
    shifts = torch.tensor([0, 8, 16, 24], dtype=torch.int32,
                          device=words.device)
    return ((words[:, :, None] >> shifts) & 0xFF).reshape(B, 4 * W)


def _swap(S: torch.Tensor, i: int, si: torch.Tensor, j: torch.Tensor,
          sj: torch.Tensor) -> None:
    """In place: S[:, i] = sj, then S[lane, j[lane]] = si."""
    S[:, i] = sj
    S.scatter_(1, j[:, None], si[:, None])


def rc4_ksa(key_bytes: torch.Tensor) -> torch.Tensor:
    """The key schedule for per-candidate keys: key_bytes int32[B, K]
    -> S int32[B, 256]."""
    B, K = key_bytes.shape
    device = key_bytes.device
    S = torch.arange(256, dtype=torch.int32, device=device).repeat(B, 1)
    j = torch.zeros((B,), dtype=torch.int64, device=device)
    for i in range(256):
        si = S[:, i].clone()
        j = (j + si + key_bytes[:, i % K]) & 255
        sj = S.gather(1, j[:, None])[:, 0]
        _swap(S, i, si, j, sj)
    return S


def rc4_keystream_bytes(key_bytes: torch.Tensor, nwords: int) -> torch.Tensor:
    """The first ``nwords`` 32-bit keystream words for per-candidate keys
    of any length: key_bytes int32[B, K] -> int32[B, nwords], each word
    four keystream bytes little-endian (byte 4w + t at shift 8t)."""
    S = rc4_ksa(key_bytes)
    B = key_bytes.shape[0]
    j = torch.zeros((B,), dtype=torch.int64, device=key_bytes.device)
    words = []
    word = torch.zeros((B,), dtype=torch.int32, device=key_bytes.device)
    for t in range(4 * nwords):         # PRGA, i = t + 1
        i = t + 1
        si = S[:, i].clone()
        j = (j + si) & 255
        sj = S.gather(1, j[:, None])[:, 0]
        _swap(S, i, si, j, sj)
        k = S.gather(1, ((si + sj) & 255).long()[:, None])[:, 0]
        word = word | (k << (8 * (t % 4)))
        if t % 4 == 3:
            words.append(word)
            word = torch.zeros_like(word)
    return torch.stack(words, dim=1)


def rc4_keystream_words(key4: torch.Tensor, nwords: int) -> torch.Tensor:
    """``rc4_keystream_bytes`` for 16-byte keys given as int32[B, 4]
    little-endian words (an MD5 digest as ops/md5.py gives it)."""
    return rc4_keystream_bytes(words_to_bytes(key4), nwords)


def rc4_keystream_words_reference(key: bytes, nwords: int) -> list[int]:
    """The same packed words for one key from the pure-Python RC4 of
    the oracle (engines/cpu/krb5.py), as unsigned ints."""
    from dprf_tpu_torch.engines.cpu.krb5 import rc4
    ks = rc4(key, bytes(4 * nwords))
    return [int.from_bytes(ks[4 * w:4 * w + 4], "little")
            for w in range(nwords)]
