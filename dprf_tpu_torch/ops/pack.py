"""Candidate packing: uint8 candidate bytes -> Merkle-Damgard message words.

Single block only: candidates up to 55 bytes (27 characters for NTLM's
UTF-16LE widening) in a 64-byte block, which covers the mask and
wordlist paths of every benchmark config, and up to 111 bytes in
SHA-512's 128-byte block (``pack_fixed_wide``, ``pack_varlen_wide``).
Words come out as int32 tensors with the bit pattern of the reference's
uint32 words.
"""

from __future__ import annotations

import numpy as np
import torch


def pad_const(length: int, big_endian: bool, block: int = 64) -> np.ndarray:
    """Static MD padding for a fixed message length: 0x80 marker + 64-bit
    bit count (LE for MD4/MD5, BE for SHA-1/SHA-256) in the last 8 bytes
    of a 64-byte block, or of SHA-512's 128-byte block (``block``=128,
    whose 128-bit count has its high half zero): messages of up to 55 or
    111 bytes."""
    limit = block - 1 - (8 if block == 64 else 16)
    if length > limit:
        raise ValueError(f"single-block packing needs length <= {limit}, "
                         f"got {length}")
    const = np.zeros(block, dtype=np.uint8)
    const[length] = 0x80
    const[block - 8:block] = np.frombuffer(
        (length * 8).to_bytes(8, "big" if big_endian else "little"),
        dtype=np.uint8)
    return const


def _words_from_bytes(msg: torch.Tensor, big_endian: bool) -> torch.Tensor:
    """uint8[B, 4n] -> int32[B, n]."""
    grouped = msg.reshape(*msg.shape[:-1], -1, 4).to(torch.int32)
    shifts = (24, 16, 8, 0) if big_endian else (0, 8, 16, 24)
    words = grouped[..., 0] << shifts[0]
    for j in range(1, 4):
        words = words | (grouped[..., j] << shifts[j])
    return words


def pack_fixed(cand: torch.Tensor, length: int, big_endian: bool = False,
               widen: bool = False) -> torch.Tensor:
    """Pack fixed-length candidates uint8[B, length] -> int32[B, 16];
    ``widen``: UTF-16LE first (NTLM), a message of 2 * length bytes."""
    if widen:
        cand, length = utf16le_widen(cand), 2 * length
    pad = torch.as_tensor(pad_const(length, big_endian), device=cand.device)
    msg = pad.repeat(cand.shape[0], 1)
    msg[:, :length] = cand
    return _words_from_bytes(msg, big_endian)


def pack_fixed_wide(cand: torch.Tensor, length: int) -> torch.Tensor:
    """Fixed-length candidates uint8[B, length] -> one 128-byte SHA-512
    block as int32[B, 32]: big-endian words, the 0x80 marker at
    ``length`` and the 128-bit big-endian bit length (of which only the
    low 64 bits can be nonzero for a single block)."""
    const = pad_const(length, True, block=128)
    msg = torch.as_tensor(const, device=cand.device).repeat(cand.shape[0], 1)
    msg[:, :length] = cand
    return _words_from_bytes(msg, True)


def pack_varlen(cand: torch.Tensor, lens: torch.Tensor,
                big_endian: bool = False, widen: bool = False) -> torch.Tensor:
    """Pack variable-length candidates uint8[B, L] with int32[B] lengths
    -> int32[B, 16]: each lane's bytes below its length, 0x80 at its
    length, its bit length in word 14 (little-endian, md5/md4) or word
    15 (big-endian, SHA).  ``widen``: UTF-16LE first (NTLM), so byte q
    goes to message byte 2q and the bit length is 16 per character."""
    if widen:
        cand, lens = utf16le_widen(cand), 2 * lens
    words = _varlen_words(cand, lens, 64, big_endian)
    words[:, 15 if big_endian else 14] = lens.to(torch.int32) * 8
    return words


def pack_varlen_wide(cand: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Variable-length candidates uint8[B, L <= 111] with int32[B]
    lengths -> one 128-byte SHA-512 block as int32[B, 32]: big-endian
    words, 0x80 at each lane's length, its bit length in word 31 (the
    low word of the 128-bit length; the words above it stay 0)."""
    words = _varlen_words(cand, lens, 128, True)
    words[:, 31] = lens.to(torch.int32) * 8
    return words


def _varlen_words(cand: torch.Tensor, lens: torch.Tensor, block: int,
                  big_endian: bool) -> torch.Tensor:
    """Each lane's bytes below its length and 0x80 at it in a zeroed
    block of ``block`` bytes (64 or 128), as int32[B, block / 4]
    words."""
    batch, length = cand.shape
    limit = block - 1 - (8 if block == 64 else 16)
    if length > limit:
        raise ValueError(f"single-block packing needs length <= {limit}, "
                         f"got {length}")
    pos = torch.arange(block, dtype=torch.int32, device=cand.device)[None, :]
    lc = lens.to(torch.int32)[:, None]
    msg = torch.zeros((batch, block), dtype=torch.uint8, device=cand.device)
    msg[:, :length] = cand
    msg = torch.where(pos < lc, msg, 0)
    msg = torch.where(pos == lc, 0x80, msg).to(torch.uint8)
    return _words_from_bytes(msg, big_endian)


def pack_raw(cand: torch.Tensor, big_endian: bool = True) -> torch.Tensor:
    """uint8[B, L] (L <= 64) -> int32[B, 16]: one full 64-byte block with
    zero padding and no marker or bit length, the HMAC key-block layout,
    where a short key is zero-extended to the block size."""
    if cand.shape[1] > 64:
        raise ValueError(f"key block packing needs length <= 64, got "
                         f"{cand.shape[1]}")
    msg = torch.zeros((cand.shape[0], 64), dtype=torch.uint8,
                      device=cand.device)
    msg[:, :cand.shape[1]] = cand
    return _words_from_bytes(msg, big_endian)


def utf16le_widen(cand: torch.Tensor) -> torch.Tensor:
    """uint8[B, L] latin-1 bytes -> uint8[B, 2L] UTF-16LE (NTLM input):
    byte p goes to byte 2p, every odd byte is 0."""
    batch, length = cand.shape
    wide = torch.zeros((batch, length, 2), dtype=torch.uint8,
                       device=cand.device)
    wide[:, :, 0] = cand
    return wide.reshape(batch, 2 * length)


def words_to_bytes_be(words: torch.Tensor) -> torch.Tensor:
    """int32[B, W] big-endian words -> their uint8[B, 4W] bytes (a SHA
    digest's or a PBKDF2 output's); the shifts are scalars, so nothing is
    copied to the words' device."""
    B, W = words.shape
    return torch.stack([(words >> s) & 0xFF for s in (24, 16, 8, 0)],
                       dim=2).reshape(B, 4 * W).to(torch.uint8)
