"""Mask attack candidate generation.

Hashcat-style masks: ``?l?l?l?l?l?l`` is six lowercase letters,
``?a?a?a?a?a?a?a`` seven printable-ASCII characters.  Built-ins:

    ?l  a-z (26)          ?u  A-Z (26)         ?d  0-9 (10)
    ?s  printable symbols incl. space (33)     ?a  = ?l?u?d?s (95)
    ?b  all byte values 0x00-0xff (256)
    ?1..?4  user-defined custom charsets       ??  literal '?'

Any other character in the mask is a literal (radix-1 position).

The keyspace is the product of per-position charset sizes; the
index -> candidate map is a mixed-radix decode with the RIGHTMOST mask
position as the least-significant digit (odometer order).

``decode_lut`` materializes a batch of candidates on the tensors'
device from a unit's digit vector plus each lane's offset, with int32
adds, mod and div, and per position either a few compare/selects
(the segment mux) or one gather from the per-position charset table
(``MaskGenerator.charset_lut``), the table the CUDA kernel reads.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from dprf_tpu_torch.generators.base import CandidateGenerator

_LOWER = bytes(range(ord("a"), ord("z") + 1))
_UPPER = bytes(range(ord("A"), ord("Z") + 1))
_DIGIT = bytes(range(ord("0"), ord("9") + 1))
# Printable ASCII symbols including space: 0x20-0x2F, 0x3A-0x40, 0x5B-0x60,
# 0x7B-0x7E (33 chars) -- matches hashcat's ?s.
_SYMBOL = bytes(range(0x20, 0x30)) + bytes(range(0x3A, 0x41)) + \
    bytes(range(0x5B, 0x61)) + bytes(range(0x7B, 0x7F))
_ALL95 = _LOWER + _UPPER + _DIGIT + _SYMBOL
_BYTES256 = bytes(range(256))

BUILTIN_CHARSETS = {
    "l": _LOWER, "u": _UPPER, "d": _DIGIT, "s": _SYMBOL,
    "a": _ALL95, "b": _BYTES256,
}


def parse_mask(mask: str,
               custom: Optional[Dict[int, bytes]] = None) -> list[bytes]:
    """Mask string -> per-position charsets (left to right)."""
    custom = custom or {}
    charsets: list[bytes] = []
    i = 0
    while i < len(mask):
        ch = mask[i]
        if ch == "?":
            if i + 1 >= len(mask):
                raise ValueError(f"dangling '?' at end of mask {mask!r}")
            sel = mask[i + 1]
            if sel == "?":
                charsets.append(b"?")
            elif sel in BUILTIN_CHARSETS:
                charsets.append(BUILTIN_CHARSETS[sel])
            elif sel.isdigit() and int(sel) in custom:
                cs = custom[int(sel)]
                if not cs:
                    raise ValueError(f"custom charset ?{sel} is empty")
                charsets.append(bytes(cs))
            else:
                raise ValueError(f"unknown mask token ?{sel} in {mask!r}")
            i += 2
        else:
            charsets.append(ch.encode("latin-1"))
            i += 1
    if not charsets:
        raise ValueError("empty mask")
    return charsets


#: positions whose charset needs more pieces than this decode through
#: the flat-table gather instead of the segment mux
MAX_SEGMENTS = 16


def charset_segments(charset: bytes):
    """Charset (digit order) -> [(start_digit, byte_delta)] pieces where
    byte = digit + delta for digit >= start_digit (until next piece)."""
    segs = []
    for d, byte in enumerate(charset):
        delta = byte - d
        if not segs or segs[-1][1] != delta:
            segs.append((d, delta))
    return segs


def segment_mux(digit: torch.Tensor, segs) -> torch.Tensor:
    """Piecewise charset lookup: digit tensor -> byte tensor (same
    dtype).  Piece starts are ascending, so the last satisfied select
    wins."""
    byte = digit + segs[0][1]
    for start, delta in segs[1:]:
        byte = torch.where(digit >= start, digit + delta, byte)
    return byte


def decode_lut(lut: torch.Tensor, radices: Sequence[int],
               base_digits: Sequence[int], batch: int, lane_offset: int = 0,
               segments: Optional[Sequence] = None) -> torch.Tensor:
    """Candidates base + lane_offset + lane for lane in [0, batch) on
    the lut's device.

    lut: uint8[length, 256] (``MaskGenerator.charset_lut``); radices and
    base_digits: one int per position (``digits()`` of the first
    candidate).  segments: per position the ``charset_segments`` pieces
    to mux, or None to gather from the lut (all positions gather when
    omitted).  Returns uint8[batch, length].  Lanes that carried past
    the most-significant digit wrap around; callers mask them out with
    the batch's valid count.
    """
    length = lut.shape[0]
    carry = lane_offset + torch.arange(batch, dtype=torch.int32,
                                       device=lut.device)
    cols: list = [None] * length
    for p in range(length - 1, -1, -1):
        s = carry + int(base_digits[p])
        idx = s % int(radices[p])
        segs = segments[p] if segments is not None else None
        if segs is not None:
            cols[p] = segment_mux(idx, segs).to(torch.uint8)
        else:
            cols[p] = lut[p][idx.long()]
        carry = s // int(radices[p])
    return torch.stack(cols, dim=1)


class MaskGenerator(CandidateGenerator):
    """index -> fixed-length candidate via mixed-radix decode."""

    def __init__(self, mask: str,
                 custom: Optional[Dict[int, bytes]] = None):
        self.mask = mask
        self._init_charsets(parse_mask(mask, custom))

    @classmethod
    def from_charsets(cls, charsets: Sequence[bytes]) -> "MaskGenerator":
        """A generator over explicit per-position charsets (the
        reference generator's ``charsets`` list), so both packages can
        be handed the same job."""
        gen = cls.__new__(cls)
        gen.mask = None
        charsets = [bytes(cs) for cs in charsets]
        if not charsets or not all(1 <= len(cs) <= 256 for cs in charsets):
            raise ValueError("every position needs 1..256 charset bytes")
        gen._init_charsets(charsets)
        return gen

    def _init_charsets(self, charsets: list[bytes]) -> None:
        self.charsets = charsets
        self.length = len(charsets)
        self.max_length = self.length
        self.radices = tuple(len(cs) for cs in charsets)
        self.keyspace = 1
        for r in self.radices:
            self.keyspace *= r
        # None = too many pieces for the mux: that position gathers
        self._segments = tuple(
            segs if len(segs) <= MAX_SEGMENTS else None
            for segs in (charset_segments(cs) for cs in charsets))

    # ---------------- host (oracle) path ----------------

    def digits(self, index: int) -> list[int]:
        """Mixed-radix digit vector for a global index (arbitrary size int,
        handled in Python; rightmost position is least significant)."""
        if not 0 <= index < self.keyspace:
            raise IndexError(f"index {index} outside keyspace {self.keyspace}")
        out = [0] * self.length
        for p in range(self.length - 1, -1, -1):
            index, out[p] = divmod(index, self.radices[p])
        return out

    def candidate(self, index: int) -> bytes:
        return bytes(self.charsets[p][d]
                     for p, d in enumerate(self.digits(index)))

    def index_of(self, candidate: bytes) -> int:
        """Inverse map (host): candidate bytes -> global index."""
        if len(candidate) != self.length:
            raise ValueError("wrong candidate length for mask")
        index = 0
        for p, byte in enumerate(candidate):
            d = self.charsets[p].find(bytes([byte]))
            if d < 0:
                raise ValueError(
                    f"byte {byte:#x} not in charset for position {p}")
            index = index * self.radices[p] + d
        return index

    # ---------------- device path ----------------

    def charset_lut(self, device="cpu") -> torch.Tensor:
        """Per-position 256-byte lookup table uint8[length, 256]: row p
        maps digit d to charset byte p[d] (zero past the radix)."""
        lut = np.zeros((self.length, 256), np.uint8)
        for p, cs in enumerate(self.charsets):
            lut[p, :len(cs)] = np.frombuffer(cs, np.uint8)
        return torch.as_tensor(lut, device=device)

    def decode_batch(self, base_digits: Sequence[int], lut: torch.Tensor,
                     batch: int, lane_offset: int = 0) -> torch.Tensor:
        """``decode_lut`` for this mask on the lut's device: positions
        of at most MAX_SEGMENTS charset pieces go through the segment
        mux, the others gather from ``lut`` (``charset_lut``)."""
        return decode_lut(lut, self.radices, base_digits, batch,
                          lane_offset, self._segments)

    def __repr__(self) -> str:  # pragma: no cover
        return f"<MaskGenerator {self.mask!r} keyspace={self.keyspace}>"
