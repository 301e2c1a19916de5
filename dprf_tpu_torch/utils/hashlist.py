"""Hashlist parsing: target file -> list of Target.

Lines are parsed by the selected engine (bare hex digests for the fast
hashes).  Blank lines and '#' comments are skipped; duplicates are
dropped preserving first occurrence; malformed lines are collected, not
fatal.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from dprf_tpu_torch.engines.base import HashEngine, Target


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
    targets: list[Target] = []
    numbers: list[int] = []
    seen: set = set()
    skipped, dups = [], 0
    for no, raw in enumerate(lines, 1):
        text = raw.strip()
        if not text or text.startswith("#"):
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
