"""Rule-language parser: rule line -> tuple of Ops.

Syntax (hashcat/John compatible subset — the widely-published standard):
an operation is one character, immediately followed by its parameters.
Positional parameters are base-36 digits ('0'-'9' = 0-9, 'A'-'Z' =
10-35); character parameters are literal bytes (including space).
Whitespace *between* operations is ignored; lines starting with '#' and
blank lines are comments.

Each parsed op is (opcode, p1, p2) with unused params = 0, a layout that
serializes directly into the int32 bytecode table the device metadata
uses and that both interpreters share.
"""

from __future__ import annotations

import dataclasses
import enum
import os
from typing import Iterable, Sequence


class Opcode(enum.IntEnum):
    NOOP = 0
    LOWER = 1          # l
    UPPER = 2          # u
    CAPITALIZE = 3     # c   (first upper, rest lower)
    INV_CAPITALIZE = 4  # C  (first lower, rest upper)
    TOGGLE_ALL = 5     # t
    TOGGLE_AT = 6      # TN
    REVERSE = 7        # r
    DUPLICATE = 8      # d
    DUPLICATE_N = 9    # pN
    REFLECT = 10       # f
    ROT_LEFT = 11      # {
    ROT_RIGHT = 12     # }
    DEL_FIRST = 13     # [
    DEL_LAST = 14      # ]
    DEL_AT = 15        # DN
    EXTRACT = 16       # xNM   keep [N, N+M)
    OMIT = 17          # ONM   delete [N, N+M)
    INSERT = 18        # iNX
    OVERWRITE = 19     # oNX
    TRUNCATE = 20      # 'N
    SUBSTITUTE = 21    # sXY
    PURGE = 22         # @X
    DUP_FIRST = 23     # zN    prepend first char N times
    DUP_LAST = 24      # ZN    append last char N times
    DUP_ALL = 25       # q     duplicate every char
    SWAP_FRONT = 26    # k
    SWAP_BACK = 27     # K
    SWAP_AT = 28       # *NM
    SHIFT_LEFT = 29    # LN    char at N <<= 1
    SHIFT_RIGHT = 30   # RN    char at N >>= 1
    INCR_AT = 31       # +N
    DECR_AT = 32       # -N
    REPL_NEXT = 33     # .N    char at N = char at N+1
    REPL_PREV = 34     # ,N    char at N = char at N-1
    DUP_BLOCK_FRONT = 35   # yN  prepend first N chars
    DUP_BLOCK_BACK = 36    # YN  append last N chars
    APPEND = 37        # $X
    PREPEND = 38       # ^X
    TITLE = 39         # E     lowercase, then upper after space/start
    TITLE_SEP = 40     # eX    same with separator X
    # rejection rules: mark the candidate invalid rather than edit it
    REJ_GT = 41        # <N    reject if len > N
    REJ_LT = 42        # >N    reject if len < N
    REJ_NEQ_LEN = 43   # _N    reject if len != N
    REJ_CONTAIN = 44   # !X    reject if word contains X
    REJ_NOT_CONTAIN = 45   # /X  reject unless word contains X
    REJ_NOT_FIRST = 46     # (X  reject unless first char is X
    REJ_NOT_LAST = 47      # )X  reject unless last char is X
    REJ_NOT_AT = 48        # =NX reject unless char at N is X
    REJ_LT_COUNT = 49      # %NX reject unless >= N instances of X


@dataclasses.dataclass(frozen=True)
class OpSpec:
    char: str
    opcode: Opcode
    #: parameter kinds, in order: 'p' = base-36 position, 'c' = literal char
    params: str


_SPECS = [
    OpSpec(":", Opcode.NOOP, ""),
    OpSpec("l", Opcode.LOWER, ""),
    OpSpec("u", Opcode.UPPER, ""),
    OpSpec("c", Opcode.CAPITALIZE, ""),
    OpSpec("C", Opcode.INV_CAPITALIZE, ""),
    OpSpec("t", Opcode.TOGGLE_ALL, ""),
    OpSpec("T", Opcode.TOGGLE_AT, "p"),
    OpSpec("r", Opcode.REVERSE, ""),
    OpSpec("d", Opcode.DUPLICATE, ""),
    OpSpec("p", Opcode.DUPLICATE_N, "p"),
    OpSpec("f", Opcode.REFLECT, ""),
    OpSpec("{", Opcode.ROT_LEFT, ""),
    OpSpec("}", Opcode.ROT_RIGHT, ""),
    OpSpec("[", Opcode.DEL_FIRST, ""),
    OpSpec("]", Opcode.DEL_LAST, ""),
    OpSpec("D", Opcode.DEL_AT, "p"),
    OpSpec("x", Opcode.EXTRACT, "pp"),
    OpSpec("O", Opcode.OMIT, "pp"),
    OpSpec("i", Opcode.INSERT, "pc"),
    OpSpec("o", Opcode.OVERWRITE, "pc"),
    OpSpec("'", Opcode.TRUNCATE, "p"),
    OpSpec("s", Opcode.SUBSTITUTE, "cc"),
    OpSpec("@", Opcode.PURGE, "c"),
    OpSpec("z", Opcode.DUP_FIRST, "p"),
    OpSpec("Z", Opcode.DUP_LAST, "p"),
    OpSpec("q", Opcode.DUP_ALL, ""),
    OpSpec("k", Opcode.SWAP_FRONT, ""),
    OpSpec("K", Opcode.SWAP_BACK, ""),
    OpSpec("*", Opcode.SWAP_AT, "pp"),
    OpSpec("L", Opcode.SHIFT_LEFT, "p"),
    OpSpec("R", Opcode.SHIFT_RIGHT, "p"),
    OpSpec("+", Opcode.INCR_AT, "p"),
    OpSpec("-", Opcode.DECR_AT, "p"),
    OpSpec(".", Opcode.REPL_NEXT, "p"),
    OpSpec(",", Opcode.REPL_PREV, "p"),
    OpSpec("y", Opcode.DUP_BLOCK_FRONT, "p"),
    OpSpec("Y", Opcode.DUP_BLOCK_BACK, "p"),
    OpSpec("$", Opcode.APPEND, "c"),
    OpSpec("^", Opcode.PREPEND, "c"),
    OpSpec("E", Opcode.TITLE, ""),
    OpSpec("e", Opcode.TITLE_SEP, "c"),
    OpSpec("<", Opcode.REJ_GT, "p"),
    OpSpec(">", Opcode.REJ_LT, "p"),
    OpSpec("_", Opcode.REJ_NEQ_LEN, "p"),
    OpSpec("!", Opcode.REJ_CONTAIN, "c"),
    OpSpec("/", Opcode.REJ_NOT_CONTAIN, "c"),
    OpSpec("(", Opcode.REJ_NOT_FIRST, "c"),
    OpSpec(")", Opcode.REJ_NOT_LAST, "c"),
    OpSpec("=", Opcode.REJ_NOT_AT, "pc"),
    OpSpec("%", Opcode.REJ_LT_COUNT, "pc"),
]

OPS: dict[str, OpSpec] = {s.char: s for s in _SPECS}


@dataclasses.dataclass(frozen=True)
class Op:
    opcode: Opcode
    p1: int = 0
    p2: int = 0

    def __repr__(self) -> str:  # pragma: no cover
        return f"Op({self.opcode.name}, {self.p1}, {self.p2})"


def _position(ch: str, rule: str) -> int:
    """Base-36 position digit: 0-9, A-Z = 10-35."""
    if "0" <= ch <= "9":
        return ord(ch) - ord("0")
    if "A" <= ch <= "Z":
        return ord(ch) - ord("A") + 10
    raise ValueError(f"bad position char {ch!r} in rule {rule!r}")


def parse_rule(rule: str) -> tuple[Op, ...]:
    """One rule line -> ops.  Raises ValueError on malformed syntax."""
    ops: list[Op] = []
    i, n = 0, len(rule)
    while i < n:
        ch = rule[i]
        if ch in (" ", "\t"):
            i += 1
            continue
        spec = OPS.get(ch)
        if spec is None:
            raise ValueError(f"unknown rule operation {ch!r} in {rule!r}")
        i += 1
        params = [0, 0]
        for slot, kind in enumerate(spec.params):
            if i >= n:
                raise ValueError(
                    f"rule {rule!r}: op {ch!r} missing parameter {slot + 1}")
            pch = rule[i]
            i += 1
            params[slot] = (_position(pch, rule) if kind == "p"
                            else ord(pch.encode("latin-1")))
        ops.append(Op(spec.opcode, params[0], params[1]))
    if not ops:
        raise ValueError("empty rule")
    return tuple(ops)


def parse_rules(lines: Iterable[str],
                on_error: str = "raise") -> list[tuple[Op, ...]]:
    """Many rule lines -> list of op tuples.

    on_error: 'raise' or 'skip' (skip silently drops bad lines, the
    lenient mode used for user-supplied files full of exotic ops).
    """
    out: list[tuple[Op, ...]] = []
    for line in lines:
        line = line.rstrip("\n").rstrip("\r")
        if not line.strip() or line.lstrip().startswith("#"):
            continue
        try:
            out.append(parse_rule(line))
        except ValueError:
            if on_error == "raise":
                raise
    if not out:
        raise ValueError("rule set contains no usable rules")
    return out


_RULES_DIR = os.path.join(os.path.dirname(__file__), "data")

BUILTIN_RULESETS = ("best64", "dprf64", "leetspeak", "toggle")


def builtin_ruleset(name: str) -> str:
    path = os.path.join(_RULES_DIR, name + ".rule")
    if not os.path.exists(path):
        raise KeyError(f"no builtin ruleset {name!r}; "
                       f"have {', '.join(BUILTIN_RULESETS)}")
    return path


def resolve_rules_path(name_or_path: str) -> str:
    """Builtin set name or file path -> the file that will be loaded.
    The single source of truth for resolution: job fingerprints hash
    exactly the file `load_rules` parses."""
    if os.path.exists(name_or_path):
        return name_or_path
    try:
        return builtin_ruleset(name_or_path)
    except KeyError:
        raise FileNotFoundError(
            f"rule set {name_or_path!r}: not a file and not a builtin "
            f"({', '.join(BUILTIN_RULESETS)})")


def load_rules(name_or_path: str,
               on_error: str = "raise") -> list[tuple[Op, ...]]:
    """Load rules from a builtin set name or a file path."""
    with open(resolve_rules_path(name_or_path), "r",
              encoding="latin-1") as fh:
        return parse_rules(fh, on_error=on_error)
