"""EksBlowfish / bcrypt on int32 torch tensors: the plain version of the
bcrypt kernels (csrc/bcrypt.cu) and the counterpart of the JAX
package's ops/blowfish.py (benchmark config 4).

Every candidate carries 4 KB of mutating S-box state, uint32[B, 1024]
(the four boxes flat), and an 18-word P-array; the key schedule is a
serial chain of Blowfish encryptions with data-dependent S-box reads,
so the batch is the only parallelism.  The four S-box reads of one
Feistel round are one ``gather`` over the flat 1024 axis.  The chains
run as Python loops of torch ops -- about 10^5 ops per ExpandKey, which
is why the card runs the hand-written kernels and this version serves
the tests and ``--device torch-cpu``.

Functions take and return new tensors: inputs are never modified (the
working state is a copy, updated in place).  Words are int32 tensors
with the bit pattern of the reference's uint32 words (ops/int32.py).
Semantics ($2a/$2b: NUL-terminated key, 72-byte cap) match the CPU
oracle engines/cpu/bcrypt.py bit for bit.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from dprf_tpu_torch.engines.cpu._blowfish_tables import P_INIT, S_INIT

P0 = np.array(P_INIT, dtype=np.uint32)                      # [18]
S0 = np.array(S_INIT, dtype=np.uint32).reshape(-1)          # [1024]
#: "OrpheanBeholderScryDoubt", the bcrypt ECB plaintext: three 64-bit
#: blocks = six big-endian words
MAGIC_WORDS = np.frombuffer(b"OrpheanBeholderScryDoubt",
                            dtype=">u4").astype(np.uint32)  # [6]


def _i32(words) -> np.ndarray:
    return np.asarray(words, dtype=np.uint32).view(np.int32)


def _box_offsets(device) -> torch.Tensor:
    """Flat S offsets of the bytes of a word read as uint8[4]: the
    lowest byte first (a little-endian host and card) indexes box 3,
    the highest box 0."""
    if sys.byteorder != "little":
        raise RuntimeError("ops/blowfish reads words as bytes: needs a "
                           "little-endian host")
    return torch.tensor([768, 512, 256, 0], dtype=torch.int64,
                        device=device)


def _feistel(S: torch.Tensor, x: torch.Tensor,
             off: torch.Tensor) -> torch.Tensor:
    """F(x) = ((S0[a] + S1[b]) ^ S2[c]) + S3[d] per lane: S int32[B,
    1024], x int32[B]; the four reads are one gather."""
    idx = x.view(torch.uint8).view(-1, 4).long() + off
    g3, g2, g1, g0 = S.gather(1, idx).unbind(1)
    return ((g0 + g1) ^ g2) + g3


def _encrypt(P: list, S: torch.Tensor, l: torch.Tensor, r: torch.Tensor,
             off: torch.Tensor):
    """One 16-round Blowfish encryption per lane; P: 18 int32[B]
    tensors."""
    for i in range(0, 16, 2):
        l = l ^ P[i]
        r = r ^ P[i + 1] ^ _feistel(S, l, off)
        l = l ^ _feistel(S, r, off)
    return r ^ P[17], l ^ P[16]


def _expand_key(P: list, S: torch.Tensor, key: list, salt_words=None):
    """One ExpandKey in place: P (18 int32[B] tensors, replaced) ^=
    key, then P and S (int32[B, 1024], written) regenerated by chained
    encryption; with salt_words (4 ints), step n's input is perturbed by
    salt words (0, 1) for even n and (2, 3) for odd n."""
    off = _box_offsets(S.device)
    for i in range(18):
        P[i] = P[i] ^ key[i]
    l = torch.zeros_like(P[0])
    r = torch.zeros_like(P[0])
    for n in range(521):
        if salt_words is not None:
            l = l ^ salt_words[2 * (n % 2)]
            r = r ^ salt_words[2 * (n % 2) + 1]
        l, r = _encrypt(P, S, l, r, off)
        if n < 9:
            P[2 * n], P[2 * n + 1] = l, r
        else:
            S[:, 2 * (n - 9)] = l
            S[:, 2 * (n - 9) + 1] = r


def _columns(t: torch.Tensor) -> list:
    return list(t.unbind(1))


def expand_key(P: torch.Tensor, S: torch.Tensor, key_words: torch.Tensor,
               salt_words=None):
    """One EksBlowfish ExpandKey: P int32[B, 18], S int32[B, 1024],
    key_words int32[B, 18]; salt_words: 4 uint32 ints or None.  Returns
    the new (P, S)."""
    Pl, S = _columns(P), S.clone()
    salt = None if salt_words is None else [int(w) for w in
                                            _i32(salt_words)]
    _expand_key(Pl, S, _columns(key_words), salt)
    return torch.stack(Pl, 1), S


def key_words_from_candidates(cand: torch.Tensor,
                              lengths: torch.Tensor) -> torch.Tensor:
    """uint8[B, L] candidates + int32[B] lengths -> int32[B, 18] key
    words: the NUL-terminated password cyclically extended over 72 bytes
    and read as big-endian 32-bit words ($2a/$2b key semantics)."""
    B, L = cand.shape
    klen = lengths.long() + 1                # password + NUL terminator
    pos = torch.arange(72, device=cand.device)[None, :] % klen[:, None]
    byte = torch.gather(cand, 1, torch.clamp(pos, max=L - 1))
    byte = torch.where(pos < lengths[:, None], byte, 0).to(torch.int32)
    b = byte.reshape(B, 18, 4)
    return (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]


def salt18_words(salt_words) -> np.ndarray:
    """ExpandKey(salt)'s key words: the 16-byte salt cyclically extended
    over 72 bytes is word-periodic with period 4.  uint32[18]."""
    return np.tile(np.asarray(salt_words, dtype=np.uint32), 5)[:18]


def eks_setup_begin(key_words: torch.Tensor, salt_words):
    """The EksBlowfish prologue: fresh P/S, then the salted
    ExpandKey(key).  Returns (P int32[B, 18], S int32[B, 1024])."""
    B, device = key_words.shape[0], key_words.device
    P = torch.as_tensor(_i32(P0), device=device).expand(B, 18)
    S = torch.as_tensor(_i32(S0), device=device).expand(B, 1024)
    return expand_key(P, S, key_words, salt_words)


def eks_rounds(P: torch.Tensor, S: torch.Tensor, key_words: torch.Tensor,
               salt18, n_rounds: int):
    """Advance the cost loop by ``n_rounds`` iterations of
    {ExpandKey(key); ExpandKey(salt18)}: the ChunkedEks ``advance``
    contract (salt18: 18 uint32 ints).  The body does not depend on the
    round's index, so the 2**cost chain may be split anywhere."""
    Pl, S = _columns(P), S.clone()
    key = _columns(key_words)
    salt = [int(w) for w in _i32(salt18)]
    for _ in range(int(n_rounds)):
        _expand_key(Pl, S, key)
        _expand_key(Pl, S, salt)
    return torch.stack(Pl, 1), S


def bcrypt_digest_words(P: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """Encrypt the three magic blocks 64 times each: int32[B, 6]
    big-endian digest words (the 23-byte digest is words[:5] and the top
    3 bytes of words[5])."""
    B, device = P.shape[0], P.device
    # the three blocks' chains are independent: one chain of 3B lanes,
    # block-major
    Pl, S3 = _columns(P.repeat(3, 1)), S.repeat(3, 1)
    magic = torch.as_tensor(_i32(MAGIC_WORDS), device=device).view(3, 2)
    l = magic[:, 0].repeat_interleave(B)
    r = magic[:, 1].repeat_interleave(B)
    off = _box_offsets(device)
    for _ in range(64):
        l, r = _encrypt(Pl, S3, l, r, off)
    return torch.stack([l.view(3, B), r.view(3, B)], 2) \
        .permute(1, 0, 2).reshape(B, 6)


# ---------------- host-side target preparation ----------------

def salt_to_words(salt: bytes) -> np.ndarray:
    """16-byte bcrypt salt -> uint32[4] big-endian words."""
    if len(salt) != 16:
        raise ValueError("bcrypt salt must be 16 bytes")
    return np.frombuffer(salt, dtype=">u4").astype(np.uint32)


def digest_to_words(digest: bytes) -> np.ndarray:
    """23-byte bcrypt digest -> uint32[6]; word 5 holds its top 3 bytes
    (low byte zero), as ``compare_digest_words`` reads it."""
    if len(digest) != 23:
        raise ValueError("bcrypt digest must be 23 bytes")
    w = np.zeros(6, dtype=np.uint32)
    w[:5] = np.frombuffer(digest[:20], dtype=">u4").astype(np.uint32)
    w[5] = (digest[20] << 24) | (digest[21] << 16) | (digest[22] << 8)
    return w


def compare_digest_words(dwords: torch.Tensor,
                         target: torch.Tensor) -> torch.Tensor:
    """int32[B, 6] computed words vs int32[6] target -> bool[B].  Only
    23 of the 24 ciphertext bytes count (the format drops the last), so
    word 5 compares its top 24 bits."""
    head = (dwords[:, :5] == target[None, :5]).all(dim=-1)
    tail = (dwords[:, 5] & ~0xFF) == target[5]
    return head & tail


def words_to_digests(dwords: np.ndarray) -> list[bytes]:
    """uint32[B, 6] (or their int32 view) -> 23-byte digests."""
    raw = np.ascontiguousarray(dwords).view(np.uint32).astype(">u4")
    return [raw[i].tobytes()[:23] for i in range(raw.shape[0])]
