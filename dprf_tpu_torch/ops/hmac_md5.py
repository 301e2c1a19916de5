"""HMAC-MD5 with a per-candidate 16-byte key and a short constant
message, on int32 torch tensors: the counterpart of the JAX package's
``hmac_msg_blocks`` and ``_hmac_md5_const_msg``
(engines/device/netntlmv2.py) and of ``pallas_krb5._hmac_md5``.

The key (an NT hash, or an HMAC output) is shorter than the block, so
the key pad is one xor of the zero-padded key block; the message
follows the 64-byte key block, so its padding counts 64 more bytes.
Words are little-endian int32 with the bit pattern of the reference's
uint32 words (ops/int32.py).
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from dprf_tpu_torch.ops.int32 import as_i32
from dprf_tpu_torch.ops.md5 import INIT as MD5_INIT, md5_compress

_IPAD = as_i32([0x36363636])[0]
_OPAD = as_i32([0x5C5C5C5C])[0]


def _hmac_padded(msg: bytes) -> bytes:
    """MD5 padding for a message that follows the 64-byte key block."""
    total = 64 + len(msg)
    padded = msg + b"\x80"
    padded += b"\x00" * ((56 - len(padded) % 64) % 64)
    return padded + (total * 8).to_bytes(8, "little")


def hmac_msg_blocks(msg: bytes, width_blocks: int,
                    what: str = "message") -> tuple:
    """Pre-pad an HMAC message into MD5 blocks: (uint32[width_blocks,
    16] little-endian words, the number of blocks it needs).  Blocks past
    that are zero."""
    padded = _hmac_padded(msg)
    n_blocks = len(padded) // 64
    if n_blocks > width_blocks:
        raise ValueError(
            f"{what} needs {n_blocks} HMAC blocks, cap {width_blocks}")
    buf = np.zeros((width_blocks, 64), np.uint8)
    buf[:n_blocks] = np.frombuffer(padded, np.uint8).reshape(n_blocks, 64)
    return buf.view("<u4").astype(np.uint32), n_blocks


def _key_states(key4: torch.Tensor):
    B = key4.shape[0]
    key_block = torch.zeros((B, 16), dtype=torch.int32, device=key4.device)
    key_block[:, :4] = key4
    init = torch.tensor(as_i32(MD5_INIT), dtype=torch.int32,
                        device=key4.device).expand(B, 4)
    return (md5_compress(init, key_block ^ _IPAD),
            md5_compress(init, key_block ^ _OPAD))


def _outer(ostate: torch.Tensor, inner: torch.Tensor) -> torch.Tensor:
    """The outer hash over the 16-byte inner digest."""
    block = torch.zeros((inner.shape[0], 16), dtype=torch.int32,
                        device=inner.device)
    block[:, :4] = inner
    block[:, 4] = 0x80
    block[:, 14] = (64 + 16) * 8
    return md5_compress(ostate, block)


def hmac_md5_const_msg(key4: torch.Tensor, msg_blocks: np.ndarray,
                       n_blocks: int) -> torch.Tensor:
    """HMAC-MD5 under per-candidate keys int32[B, 4] of a message
    pre-padded by ``hmac_msg_blocks`` (its first ``n_blocks`` blocks)
    -> int32[B, 4]."""
    istate, ostate = _key_states(key4)
    blocks = torch.tensor(np.asarray(msg_blocks, np.uint32).view(np.int32),
                          device=key4.device)
    state = istate
    for k in range(n_blocks):
        state = md5_compress(state, blocks[k].expand(key4.shape[0], 16))
    return _outer(ostate, state)


def hmac_md5(key4: torch.Tensor,
             msg_words: Union[torch.Tensor, Sequence[int]],
             msg_len: int) -> torch.Tensor:
    """HMAC-MD5 of a word-aligned message of ``msg_len`` bytes (4 or 16,
    one inner block) given as little-endian words (a tensor [..., nw]
    broadcast to the batch, or ints) under keys int32[B, 4] ->
    int32[B, 4]: the kernel's form, where the marker and the bit length
    are fixed words."""
    nw = msg_len // 4
    if msg_len % 4 or not 1 <= nw <= 13:
        raise ValueError(f"a word-aligned one-block message, got "
                         f"{msg_len} bytes")
    istate, ostate = _key_states(key4)
    block = torch.zeros((key4.shape[0], 16), dtype=torch.int32,
                        device=key4.device)
    if isinstance(msg_words, torch.Tensor):
        block[:, :nw] = msg_words
    else:
        block[:, :nw] = torch.tensor(as_i32(msg_words), dtype=torch.int32,
                                     device=key4.device)
    block[:, nw] = 0x80
    block[:, 14] = (64 + msg_len) * 8
    return _outer(ostate, md5_compress(istate, block))
