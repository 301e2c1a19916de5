"""HMAC-SHA1 and PBKDF2-HMAC-SHA1 on int32 torch tensors: the plain
version of the PMKID kernel (csrc/pbkdf2.cu) and the counterpart of the
JAX package's ops/hmac_sha1.py.

The WPA2-PMKID path (benchmark config 5): PMK = PBKDF2-HMAC-SHA1(pass,
essid, 4096, 32), PMKID = HMAC-SHA1(PMK, "PMK Name"|AP|STA)[:16].

- Passphrases (<= 63 bytes) and PMKs (32 bytes) are shorter than the
  64-byte SHA-1 block, so the HMAC key pad is a single xor of the raw
  zero-padded key block; the inner and outer keyed states are computed
  once per candidate and reused for every iteration.
- Every PBKDF2 iteration after the first hashes a 20-byte U value: two
  compressions of padded one-block messages.
- The first message of block i (salt || INT32BE(i)) is the same for
  every candidate, so it is built once on the host.

Words are int32 tensors with the bit pattern of the reference's uint32
words (ops/int32.py); the iteration count is a runtime argument.
"""

from __future__ import annotations

import numpy as np
import torch

from dprf_tpu_torch.ops.int32 import as_i32
from dprf_tpu_torch.ops.sha1 import INIT as SHA1_INIT, sha1_compress

_IPAD = as_i32([0x36363636])[0]
_OPAD = as_i32([0x5C5C5C5C])[0]
#: the 0x80 marker after a 20-byte message, and its bit length after a
#: 64-byte key block
_MARK = as_i32([0x80000000])[0]
_BITS20 = (64 + 20) * 8


def _init(shape, device) -> torch.Tensor:
    init = torch.tensor(as_i32(SHA1_INIT), dtype=torch.int32, device=device)
    return init.expand(tuple(shape) + (5,))


def hmac_key_states(key_words: torch.Tensor):
    """Keyed chaining states of a one-block key: key_words int32[..., 16]
    big-endian packed key bytes (<= 64) with raw zero padding (no 0x80
    marker: the key block is a full block).  Returns (istate, ostate),
    int32[..., 5] each."""
    init = _init(key_words.shape[:-1], key_words.device)
    return (sha1_compress(init, key_words ^ _IPAD),
            sha1_compress(init, key_words ^ _OPAD))


def _block20(words5: torch.Tensor) -> torch.Tensor:
    """A 20-byte (5-word) message padded as the block that follows a
    64-byte key block: the 0x80 marker, then the bit length 8 * 84."""
    block = torch.zeros(words5.shape[:-1] + (16,), dtype=torch.int32,
                        device=words5.device)
    block[..., :5] = words5
    block[..., 5] = _MARK
    block[..., 15] = _BITS20
    return block


def hmac_sha1_20(istate: torch.Tensor, ostate: torch.Tensor,
                 msg5: torch.Tensor) -> torch.Tensor:
    """HMAC-SHA1 of a 20-byte message from the keyed states: two
    compressions.  msg5 int32[..., 5] -> int32[..., 5]."""
    inner = sha1_compress(istate, _block20(msg5))
    return sha1_compress(ostate, _block20(inner))


def salt_block(salt: bytes, block_index: int) -> np.ndarray:
    """U1's message block, salt || INT32BE(i), padded as the second
    block of the inner hash (after the 64-byte key block): uint32[16].
    The salt (an ESSID) must leave room for the index, the marker and
    the length in one block: at most 51 bytes."""
    msg = salt + int(block_index).to_bytes(4, "big")
    if len(msg) > 55:
        raise ValueError(f"salt too long for one block: {len(salt)} bytes")
    buf = np.zeros(64, dtype=np.uint8)
    buf[:len(msg)] = np.frombuffer(msg, dtype=np.uint8)
    buf[len(msg)] = 0x80
    buf[56:] = np.frombuffer(((64 + len(msg)) * 8).to_bytes(8, "big"),
                             dtype=np.uint8)
    return buf.view(">u4").astype(np.uint32)


def pbkdf2_sha1_block(istate: torch.Tensor, ostate: torch.Tensor,
                      salt: bytes, block_index: int,
                      iterations: int) -> torch.Tensor:
    """One PBKDF2 output block T_i, int32[..., 5]: U1 = HMAC(key, salt ||
    INT(i)), U_j = HMAC(key, U_{j-1}), T_i = U1 ^ ... ^ U_iterations."""
    first = torch.tensor(as_i32(salt_block(salt, block_index)),
                         dtype=torch.int32, device=istate.device)
    inner = sha1_compress(istate, first.expand(istate.shape[:-1] + (16,)))
    u = sha1_compress(ostate, _block20(inner))
    t = u
    for _ in range(1, iterations):
        u = hmac_sha1_20(istate, ostate, u)
        t = t ^ u
    return t


def pbkdf2_sha1_pmk(key_words: torch.Tensor, salt: bytes,
                    iterations: int = 4096) -> torch.Tensor:
    """PBKDF2-HMAC-SHA1 with a 32-byte output: int32[..., 8], T1 ||
    T2[:3].  key_words: int32[..., 16] zero-padded packed passphrases."""
    istate, ostate = hmac_key_states(key_words)
    t1 = pbkdf2_sha1_block(istate, ostate, salt, 1, iterations)
    t2 = pbkdf2_sha1_block(istate, ostate, salt, 2, iterations)
    return torch.cat([t1, t2[..., :3]], dim=-1)


def pmkid_message(mac_ap: bytes, mac_sta: bytes) -> np.ndarray:
    """The PMKID HMAC's 20-byte message "PMK Name" | AP | STA as
    uint32[5] big-endian words."""
    msg = b"PMK Name" + mac_ap + mac_sta
    if len(msg) != 20:
        raise ValueError("MACs must be 6 bytes each")
    return np.frombuffer(msg, dtype=">u4").astype(np.uint32)


def pmkid_from_pmk(pmk_words: torch.Tensor, mac_ap: bytes,
                   mac_sta: bytes) -> torch.Tensor:
    """PMKID = HMAC-SHA1(PMK, "PMK Name" | AP | STA)[:16]: int32[..., 4].
    The 32-byte PMK is the HMAC key (a single xor pad)."""
    key = torch.zeros(pmk_words.shape[:-1] + (16,), dtype=torch.int32,
                      device=pmk_words.device)
    key[..., :8] = pmk_words
    istate, ostate = hmac_key_states(key)
    msg = torch.tensor(as_i32(pmkid_message(mac_ap, mac_sta)),
                       dtype=torch.int32, device=pmk_words.device)
    return hmac_sha1_20(istate, ostate,
                        msg.expand(pmk_words.shape[:-1] + (5,)))[..., :4]
