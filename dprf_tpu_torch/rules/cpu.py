"""Host rule interpreter — the correctness oracle.

Semantics are defined HERE (and mirrored exactly by rules/device.py and
by the rule kernel, csrc/rules.cu):

- Case operations are ASCII-only (a-z / A-Z), like the standard engines.
- A positional parameter referring past the end of the word makes the
  operation a NO-OP (the word passes through unchanged).
- A growth operation (append, duplicate, reflect, ...) whose result
  would exceed `max_len` REJECTS the candidate (returns None) — the
  candidate is skipped, never hashed, matching the fixed-width device
  buffers where an oversized result cannot be represented.
- Rejection operations (`<`, `>`, `!`, `/`, ...) reject without editing.
"""

from __future__ import annotations

from typing import Optional, Sequence

from dprf_tpu_torch.rules.parser import Op, Opcode


def _tolower(b: int) -> int:
    return b + 32 if 0x41 <= b <= 0x5A else b


def _toupper(b: int) -> int:
    return b - 32 if 0x61 <= b <= 0x7A else b


def _toggle(b: int) -> int:
    if 0x41 <= b <= 0x5A:
        return b + 32
    if 0x61 <= b <= 0x7A:
        return b - 32
    return b


def _title(w: list[int], sep: int) -> list[int]:
    out = [_tolower(b) for b in w]
    for i in range(len(out)):
        if i == 0 or w[i - 1] == sep:
            out[i] = _toupper(out[i])
    return out


def apply_rule(word: bytes, ops: Sequence[Op],
               max_len: int = 55) -> Optional[bytes]:
    """Apply one rule; returns the mangled word or None (rejected)."""
    w = list(word)
    for op in ops:
        code, p1, p2 = op.opcode, op.p1, op.p2
        n = len(w)
        if code == Opcode.NOOP:
            pass
        elif code == Opcode.LOWER:
            w = [_tolower(b) for b in w]
        elif code == Opcode.UPPER:
            w = [_toupper(b) for b in w]
        elif code == Opcode.CAPITALIZE:
            w = [_tolower(b) for b in w]
            if w:
                w[0] = _toupper(w[0])
        elif code == Opcode.INV_CAPITALIZE:
            w = [_toupper(b) for b in w]
            if w:
                w[0] = _tolower(w[0])
        elif code == Opcode.TOGGLE_ALL:
            w = [_toggle(b) for b in w]
        elif code == Opcode.TOGGLE_AT:
            if p1 < n:
                w[p1] = _toggle(w[p1])
        elif code == Opcode.REVERSE:
            w.reverse()
        elif code == Opcode.DUPLICATE:
            if 2 * n > max_len:
                return None
            w = w + w
        elif code == Opcode.DUPLICATE_N:
            if n * (p1 + 1) > max_len:
                return None
            w = w * (p1 + 1)
        elif code == Opcode.REFLECT:
            if 2 * n > max_len:
                return None
            w = w + w[::-1]
        elif code == Opcode.ROT_LEFT:
            if n > 1:
                w = w[1:] + w[:1]
        elif code == Opcode.ROT_RIGHT:
            if n > 1:
                w = w[-1:] + w[:-1]
        elif code == Opcode.DEL_FIRST:
            w = w[1:]
        elif code == Opcode.DEL_LAST:
            w = w[:-1]
        elif code == Opcode.DEL_AT:
            if p1 < n:
                del w[p1]
        elif code == Opcode.EXTRACT:
            if p1 < n:
                w = w[p1:p1 + p2]
        elif code == Opcode.OMIT:
            if p1 < n:
                w = w[:p1] + w[p1 + p2:]
        elif code == Opcode.INSERT:
            if p1 <= n:
                if n + 1 > max_len:
                    return None
                w.insert(p1, p2)
        elif code == Opcode.OVERWRITE:
            if p1 < n:
                w[p1] = p2
        elif code == Opcode.TRUNCATE:
            w = w[:p1]
        elif code == Opcode.SUBSTITUTE:
            w = [p2 if b == p1 else b for b in w]
        elif code == Opcode.PURGE:
            w = [b for b in w if b != p1]
        elif code == Opcode.DUP_FIRST:
            if n:
                if n + p1 > max_len:
                    return None
                w = [w[0]] * p1 + w
        elif code == Opcode.DUP_LAST:
            if n:
                if n + p1 > max_len:
                    return None
                w = w + [w[-1]] * p1
        elif code == Opcode.DUP_ALL:
            if 2 * n > max_len:
                return None
            w = [b for b in w for _ in (0, 1)]
        elif code == Opcode.SWAP_FRONT:
            if n >= 2:
                w[0], w[1] = w[1], w[0]
        elif code == Opcode.SWAP_BACK:
            if n >= 2:
                w[-1], w[-2] = w[-2], w[-1]
        elif code == Opcode.SWAP_AT:
            if p1 < n and p2 < n:
                w[p1], w[p2] = w[p2], w[p1]
        elif code == Opcode.SHIFT_LEFT:
            if p1 < n:
                w[p1] = (w[p1] << 1) & 0xFF
        elif code == Opcode.SHIFT_RIGHT:
            if p1 < n:
                w[p1] = w[p1] >> 1
        elif code == Opcode.INCR_AT:
            if p1 < n:
                w[p1] = (w[p1] + 1) & 0xFF
        elif code == Opcode.DECR_AT:
            if p1 < n:
                w[p1] = (w[p1] - 1) & 0xFF
        elif code == Opcode.REPL_NEXT:
            if p1 + 1 < n:
                w[p1] = w[p1 + 1]
        elif code == Opcode.REPL_PREV:
            if 1 <= p1 < n:
                w[p1] = w[p1 - 1]
        elif code == Opcode.DUP_BLOCK_FRONT:
            if p1 <= n:
                if n + p1 > max_len:
                    return None
                w = w[:p1] + w
        elif code == Opcode.DUP_BLOCK_BACK:
            if p1 <= n:
                if n + p1 > max_len:
                    return None
                w = w + w[n - p1:]
        elif code == Opcode.APPEND:
            if n + 1 > max_len:
                return None
            w.append(p1)
        elif code == Opcode.PREPEND:
            if n + 1 > max_len:
                return None
            w.insert(0, p1)
        elif code == Opcode.TITLE:
            w = _title(w, 0x20)
        elif code == Opcode.TITLE_SEP:
            w = _title(w, p1)
        elif code == Opcode.REJ_GT:
            if n > p1:
                return None
        elif code == Opcode.REJ_LT:
            if n < p1:
                return None
        elif code == Opcode.REJ_NEQ_LEN:
            if n != p1:
                return None
        elif code == Opcode.REJ_CONTAIN:
            if p1 in w:
                return None
        elif code == Opcode.REJ_NOT_CONTAIN:
            if p1 not in w:
                return None
        elif code == Opcode.REJ_NOT_FIRST:
            if not w or w[0] != p1:
                return None
        elif code == Opcode.REJ_NOT_LAST:
            if not w or w[-1] != p1:
                return None
        elif code == Opcode.REJ_NOT_AT:
            if p1 >= n or w[p1] != p2:
                return None
        elif code == Opcode.REJ_LT_COUNT:
            if sum(1 for b in w if b == p2) < p1:
                return None
        else:  # pragma: no cover
            raise AssertionError(f"unhandled opcode {code}")
    return bytes(w)
