"""Hashlist parsing: target file -> list of Target.

Lines are parsed by the selected engine (bare hex digests for the fast
hashes).  Blank lines and '#' comments are skipped; duplicates are
dropped preserving first occurrence; malformed lines are collected, not
fatal.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
from typing import Sequence

from dprf_tpu_torch.engines.base import HashEngine, Target

#: the default line parser: a bare hex digest of the engine's size
_BARE_HEX = HashEngine.parse_target


@dataclasses.dataclass
class HashlistResult:
    targets: list
    skipped: list        # (line_number, text, error)
    duplicates: int
    #: each target's line number (from 1), in the order of ``targets``
    line_numbers: list = dataclasses.field(default_factory=list)


def _dedup_key(t: Target):
    """Duplicates are duplicate TARGETS, not duplicate lines: the same
    digest written twice (e.g. in different hex case) is one target."""
    params = tuple(sorted((t.params or {}).items()))
    return (t.digest, params)


def parse_lines(engine: HashEngine, lines: Sequence[str]) -> HashlistResult:
    """Lines -> targets, in file order.  An engine of bare hex lines (the
    default ``parse_target``) takes a fast path that decodes each line
    once and builds a Target only for a new digest, and the cyclic
    garbage collector, which a million new objects would run hundreds of
    times, is paused, so a 10^6-line list parses in a few seconds; a line
    the fast path cannot decode goes through ``parse_target`` for the
    engine's own error."""
    with _gc_paused():
        return _parse(engine, lines)


@contextlib.contextmanager
def _gc_paused():
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def _parse(engine: HashEngine, lines: Sequence[str]) -> HashlistResult:
    targets: list[Target] = []
    numbers: list[int] = []
    seen: set = set()
    skipped, dups = [], 0
    bare = type(engine).parse_target is _BARE_HEX
    size = engine.digest_size
    for no, raw in enumerate(lines, 1):
        text = raw.strip()
        if not text or text[0] == "#":
            continue
        if bare:
            try:
                digest = bytes.fromhex(text)
            except ValueError:
                digest = None
            if digest is not None and len(digest) == size:
                # the default parser raises on every other line, so a
                # bare engine's keys are all digests
                if digest in seen:
                    dups += 1
                    continue
                seen.add(digest)
                targets.append(Target(raw=text, digest=digest))
                numbers.append(no)
                continue
        try:
            t = engine.parse_target(text)
        except ValueError as e:
            skipped.append((no, text, str(e)))
            continue
        key = _dedup_key(t)
        if key in seen:
            dups += 1
            continue
        seen.add(key)
        targets.append(t)
        numbers.append(no)
    return HashlistResult(targets=targets, skipped=skipped, duplicates=dups,
                          line_numbers=numbers)


def load_hashlist(engine: HashEngine, path: str) -> HashlistResult:
    with open(path, encoding="utf-8", errors="replace") as fh:
        return parse_lines(engine, fh.readlines())
