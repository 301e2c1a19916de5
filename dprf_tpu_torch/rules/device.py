"""One rule over a batch of words on torch tensors: the plain version of
the rule kernel's interpreter (csrc/rules.cu).

Each rule's operations are Python constants, so applying a rule to a
batch is straight-line uint8 tensor code: selects, shifts and per-lane
gathers.  Semantics mirror rules/cpu.py byte for byte (see its
docstring for the no-op and reject conventions).

State per batch: (w uint8[B, L], lens int32[B], valid bool[B]).
Invariant after every op: bytes at positions >= lens are 0, and lens
<= L even for rejected lanes (whose ``valid`` bit is cleared).
"""

from __future__ import annotations

from typing import Sequence

import torch

from dprf_tpu_torch.rules.parser import Op, Opcode


def _pos(L: int, device) -> torch.Tensor:
    return torch.arange(L, dtype=torch.int32, device=device)[None, :]


def _gather(w: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Per-lane source-index gather, clamped so indices are always
    legal (callers mask the clamped lanes)."""
    L = w.shape[1]
    src = torch.clamp(src.expand(w.shape[0], L), 0, L - 1)
    return torch.gather(w, 1, src.long())


def _is_upper(w):
    return (w >= 0x41) & (w <= 0x5A)


def _is_lower(w):
    return (w >= 0x61) & (w <= 0x7A)


def _lower(w):
    return torch.where(_is_upper(w), w + 0x20, w)


def _upper(w):
    return torch.where(_is_lower(w), w - 0x20, w)


def _togglec(w):
    return torch.where(_is_upper(w), w + 0x20,
                       torch.where(_is_lower(w), w - 0x20, w))


def _in_word(w, lens):
    return _pos(w.shape[1], w.device) < lens[:, None]


def _count(w, lens, ch: int):
    return ((w == ch) & _in_word(w, lens)).sum(1, dtype=torch.int32)


def _char_at(w, idx):
    """Per-lane byte at index idx[B]; callers guard validity."""
    idx = torch.clamp(idx, 0, w.shape[1] - 1)[:, None].long()
    return torch.gather(w, 1, idx)[:, 0]


def apply_rule(w: torch.Tensor, lens: torch.Tensor, valid: torch.Tensor,
               ops: Sequence[Op], max_len: int):
    """Apply one parsed rule to a batch.

    w: uint8[B, L] (L >= max_len), lens: int32[B], valid: bool[B].
    Returns the new (w, lens, valid)."""
    B, L = w.shape
    pos = _pos(L, w.device)
    zero = torch.zeros((), dtype=torch.uint8, device=w.device)
    for op in ops:
        code, p1, p2 = op.opcode, op.p1, op.p2
        lc = lens[:, None]          # broadcastable per-lane length
        grow = None                 # new lengths of a growth op

        if code == Opcode.NOOP:
            pass
        elif code == Opcode.LOWER:
            w = _lower(w)
        elif code == Opcode.UPPER:
            w = _upper(w)
        elif code == Opcode.CAPITALIZE:
            w = _lower(w)
            w = torch.where(pos == 0, _upper(w), w)
        elif code == Opcode.INV_CAPITALIZE:
            w = _upper(w)
            w = torch.where(pos == 0, _lower(w), w)
        elif code == Opcode.TOGGLE_ALL:
            w = _togglec(w)
        elif code == Opcode.TOGGLE_AT:
            w = torch.where((pos == p1) & (p1 < lc), _togglec(w), w)
        elif code == Opcode.REVERSE:
            w = _gather(w, lc - 1 - pos)
        elif code == Opcode.DUPLICATE:
            w = torch.where(pos < lc, w, _gather(w, pos - lc))
            grow = 2 * lens
        elif code == Opcode.DUPLICATE_N:
            w = _gather(w, pos % torch.clamp(lc, min=1))
            grow = (p1 + 1) * lens
        elif code == Opcode.REFLECT:
            w = torch.where(pos < lc, w, _gather(w, 2 * lc - 1 - pos))
            grow = 2 * lens
        elif code == Opcode.ROT_LEFT:
            safe = torch.clamp(lc, min=1)
            w = torch.where(lc > 1, _gather(w, (pos + 1) % safe), w)
        elif code == Opcode.ROT_RIGHT:
            safe = torch.clamp(lc, min=1)
            w = torch.where(lc > 1, _gather(w, (pos - 1 + safe) % safe), w)
        elif code == Opcode.DEL_FIRST:
            w = _gather(w, pos + 1)
            lens = torch.clamp(lens - 1, min=0)
        elif code == Opcode.DEL_LAST:
            lens = torch.clamp(lens - 1, min=0)
        elif code == Opcode.DEL_AT:
            hit = p1 < lens
            w = torch.where(hit[:, None],
                            _gather(w, torch.where(pos < p1, pos, pos + 1)),
                            w)
            lens = torch.where(hit, lens - 1, lens)
        elif code == Opcode.EXTRACT:
            hit = p1 < lens
            w = torch.where(hit[:, None], _gather(w, pos + p1), w)
            lens = torch.where(hit, torch.clamp(lens - p1, max=p2), lens)
        elif code == Opcode.OMIT:
            hit = p1 < lens
            w = torch.where(hit[:, None],
                            _gather(w, torch.where(pos < p1, pos, pos + p2)),
                            w)
            lens = torch.where(hit, lens - torch.clamp(lens - p1, max=p2),
                               lens)
        elif code == Opcode.INSERT:
            hit = p1 <= lens
            moved = _gather(w, torch.where(pos < p1, pos, pos - 1))
            moved = torch.where(pos == p1, p2, moved)
            w = torch.where(hit[:, None], moved, w)
            grow = torch.where(hit, lens + 1, lens)
        elif code == Opcode.OVERWRITE:
            w = torch.where((pos == p1) & (p1 < lc), p2, w)
        elif code == Opcode.TRUNCATE:
            lens = torch.clamp(lens, max=p1)
        elif code == Opcode.SUBSTITUTE:
            w = torch.where((w == p1) & (pos < lc), p2, w)
        elif code == Opcode.PURGE:
            keep = (w != p1) & (pos < lc)
            key = torch.where(keep, pos, pos + L)
            order = torch.argsort(key, dim=1, stable=True)  # keepers first
            w = torch.gather(w, 1, order)
            lens = keep.sum(1, dtype=torch.int32)
        elif code == Opcode.DUP_FIRST:
            nz = lens > 0
            out = torch.where(pos < p1, w[:, 0:1], _gather(w, pos - p1))
            w = torch.where(nz[:, None], out, w)
            grow = torch.where(nz, lens + p1, lens)
        elif code == Opcode.DUP_LAST:
            nz = lens > 0
            last = _char_at(w, lens - 1)[:, None]
            out = torch.where(pos < lc, w, last)
            w = torch.where(nz[:, None], out, w)
            grow = torch.where(nz, lens + p1, lens)
        elif code == Opcode.DUP_ALL:
            w = _gather(w, pos // 2)
            grow = 2 * lens
        elif code == Opcode.SWAP_FRONT:
            src = torch.where(pos == 0, 1, torch.where(pos == 1, 0, pos))
            w = torch.where((lens >= 2)[:, None], _gather(w, src), w)
        elif code == Opcode.SWAP_BACK:
            src = torch.where(pos == lc - 1, lc - 2,
                              torch.where(pos == lc - 2, lc - 1, pos))
            w = torch.where((lens >= 2)[:, None], _gather(w, src), w)
        elif code == Opcode.SWAP_AT:
            hit = (p1 < lens) & (p2 < lens)
            src = torch.where(pos == p1, p2, torch.where(pos == p2, p1, pos))
            w = torch.where(hit[:, None], _gather(w, src), w)
        elif code == Opcode.SHIFT_LEFT:
            w = torch.where((pos == p1) & (p1 < lc), w << 1, w)
        elif code == Opcode.SHIFT_RIGHT:
            w = torch.where((pos == p1) & (p1 < lc), w >> 1, w)
        elif code == Opcode.INCR_AT:
            w = torch.where((pos == p1) & (p1 < lc), w + 1, w)
        elif code == Opcode.DECR_AT:
            w = torch.where((pos == p1) & (p1 < lc), w - 1, w)
        elif code == Opcode.REPL_NEXT:
            if p1 + 1 < L:
                w = torch.where((pos == p1) & (p1 + 1 < lc),
                                w[:, p1 + 1:p1 + 2], w)
        elif code == Opcode.REPL_PREV:
            if 1 <= p1 < L:
                w = torch.where((pos == p1) & (p1 < lc), w[:, p1 - 1:p1], w)
        elif code == Opcode.DUP_BLOCK_FRONT:
            hit = p1 <= lens
            out = torch.where(pos < p1, w, _gather(w, pos - p1))
            w = torch.where(hit[:, None], out, w)
            grow = torch.where(hit, lens + p1, lens)
        elif code == Opcode.DUP_BLOCK_BACK:
            hit = p1 <= lens
            out = torch.where(pos < lc, w, _gather(w, pos - p1))
            w = torch.where(hit[:, None], out, w)
            grow = torch.where(hit, lens + p1, lens)
        elif code == Opcode.APPEND:
            w = torch.where(pos == lc, p1, w)
            grow = lens + 1
        elif code == Opcode.PREPEND:
            w = torch.where(pos == 0, p1, _gather(w, pos - 1))
            grow = lens + 1
        elif code in (Opcode.TITLE, Opcode.TITLE_SEP):
            sep = 0x20 if code == Opcode.TITLE else p1
            prev = _gather(w, pos - 1)      # original bytes, shifted right
            low = _lower(w)
            up_here = (pos == 0) | (prev == sep)
            w = torch.where(up_here & (pos < lc), _upper(low), low)
        elif code == Opcode.REJ_GT:
            valid = valid & (lens <= p1)
        elif code == Opcode.REJ_LT:
            valid = valid & (lens >= p1)
        elif code == Opcode.REJ_NEQ_LEN:
            valid = valid & (lens == p1)
        elif code == Opcode.REJ_CONTAIN:
            valid = valid & (_count(w, lens, p1) == 0)
        elif code == Opcode.REJ_NOT_CONTAIN:
            valid = valid & (_count(w, lens, p1) > 0)
        elif code == Opcode.REJ_NOT_FIRST:
            valid = valid & (lens > 0) & (w[:, 0] == p1)
        elif code == Opcode.REJ_NOT_LAST:
            valid = valid & (lens > 0) & (_char_at(w, lens - 1) == p1)
        elif code == Opcode.REJ_NOT_AT:
            if p1 < L:
                valid = valid & (p1 < lens) & (w[:, p1] == p2)
            else:
                valid = torch.zeros_like(valid)
        elif code == Opcode.REJ_LT_COUNT:
            valid = valid & (_count(w, lens, p2) >= p1)
        else:  # pragma: no cover
            raise AssertionError(f"unhandled opcode {code}")

        if grow is not None:
            valid = valid & (grow <= max_len)
            lens = torch.clamp(grow, max=max_len).to(torch.int32)
        # re-establish the zero tail (growth ops may have written past a
        # rejected lane's clamped length)
        w = torch.where(pos < lens[:, None], w, zero)
    return w, lens, valid
