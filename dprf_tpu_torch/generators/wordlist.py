"""Wordlist and wordlist+rules candidate generation (benchmark config 3).

Keyspace layout: index = word_index * n_rules + rule_index, so a
contiguous WorkUnit covers whole words (all rules of one word are
adjacent) and a device step over a word window covers a contiguous
index range.

Rejected candidates (a rule that rejects, or whose result overflows
max_len) are *holes* in the keyspace: ``candidate()`` returns None and
workers skip them.  Resume bookkeeping needs only index ranges, so
holes cost nothing.

Words are stored packed -- uint8[N, max_len] zero-padded rows and
int32[N] lengths -- the layout the rule kernel reads; the worker
uploads the pair to the card once per job.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence

import numpy as np

from dprf_tpu_torch.generators.base import CandidateGenerator
from dprf_tpu_torch.rules.cpu import apply_rule as apply_rule_cpu
from dprf_tpu_torch.rules.parser import Op, Opcode, load_rules

NOOP_RULE: tuple[Op, ...] = (Op(Opcode.NOOP),)

_LF, _CR = 0x0A, 0x0D


def load_words_packed(path: str, max_len: int):
    """Read a wordlist file -> (uint8[N, max_len], int32[N], n_skipped).

    Lines end at LF; trailing CRs are stripped (leading and interior
    spaces are part of the word), empty lines are dropped, and words
    longer than max_len are skipped and counted.  Vectorized over the
    file's bytes: no Python object per word."""
    with open(path, "rb") as fh:
        data = np.frombuffer(fh.read(), dtype=np.uint8)
    ends = np.flatnonzero(data == _LF)
    if data.size and data[-1] != _LF:
        ends = np.append(ends, data.size)       # last line without LF
    starts = np.concatenate(([0], ends[:-1] + 1))[:ends.size]
    starts = starts.astype(np.int64)
    ends = ends.astype(np.int64)
    while True:                                 # strip trailing CRs
        cr = (ends > starts) & (data[np.maximum(ends - 1, 0)] == _CR)
        if not cr.any():
            break
        ends = ends - cr
    lens = ends - starts
    long_ = lens > max_len
    keep = (lens > 0) & ~long_
    starts, lens = starts[keep], lens[keep].astype(np.int32)
    buf = np.zeros((lens.size, max_len), dtype=np.uint8)
    for p in range(max_len):
        rows = np.flatnonzero(lens > p)
        if rows.size == 0:
            break
        buf[rows, p] = data[starts[rows] + p]
    if lens.size == 0:
        raise ValueError(f"wordlist {path!r} contains no usable words")
    return buf, lens, int(long_.sum())


def load_words(path: str, max_len: int) -> tuple[list[bytes], int]:
    """Read a wordlist file -> (words, n_skipped_too_long)."""
    buf, lens, skipped = load_words_packed(path, max_len)
    return [buf[i, :n].tobytes() for i, n in enumerate(lens)], skipped


class WordlistRulesGenerator(CandidateGenerator):
    """words x rules keyspace: the host oracle decode and the packed
    word tables the rule kernel reads.  Built from a list of words or
    from packed arrays (``from_files``)."""

    def __init__(self, words: Optional[Sequence[bytes]] = None,
                 rules: Optional[Sequence[tuple[Op, ...]]] = None,
                 max_len: int = 55,
                 packed: Optional[tuple[np.ndarray, np.ndarray]] = None):
        if (words is None) == (packed is None):
            raise ValueError("pass exactly one of words / packed")
        self.rules = list(rules) if rules else [NOOP_RULE]
        self.max_len = self.max_length = max_len
        if packed is not None:
            buf, lens = packed
            if buf.ndim != 2 or buf.shape[1] != max_len or \
                    len(lens) != buf.shape[0]:
                raise ValueError("packed arrays disagree with max_len")
            self._buf = np.ascontiguousarray(buf, dtype=np.uint8)
            self._lens = np.asarray(lens, dtype=np.int32)
        else:
            if not words:
                raise ValueError("empty wordlist")
            if any(len(w) > max_len for w in words):
                raise ValueError(f"word longer than max_len={max_len}")
            self._buf = np.zeros((len(words), max_len), dtype=np.uint8)
            self._lens = np.zeros((len(words),), dtype=np.int32)
            for i, w in enumerate(words):
                self._buf[i, :len(w)] = np.frombuffer(w, dtype=np.uint8)
                self._lens[i] = len(w)
        self.n_words = self._buf.shape[0]
        if self.n_words == 0:
            raise ValueError("empty wordlist")
        self.n_rules = len(self.rules)
        self.keyspace = self.n_words * self.n_rules
        #: overlong lines the file loader skipped (``from_files``)
        self.n_skipped_long = 0

    @classmethod
    def from_files(cls, wordlist_path: str,
                   rules_spec: Optional[str] = None,
                   max_len: int = 55) -> "WordlistRulesGenerator":
        """Build from a wordlist file and a rule set (a built-in name or
        a path; lines the parser rejects are skipped).  The count of
        skipped overlong lines lands on ``n_skipped_long``."""
        rules = load_rules(rules_spec, on_error="skip") if rules_spec \
            else None
        buf, lens, skipped = load_words_packed(wordlist_path, max_len)
        gen = cls(rules=rules, max_len=max_len, packed=(buf, lens))
        gen.n_skipped_long = skipped
        return gen

    def content_id(self) -> str:
        """Digest of the word content (what an index decodes to), for
        job fingerprints."""
        h = hashlib.sha256()
        h.update(b"dprf-wordlist-v2\0")
        h.update(str(self.n_words).encode())
        h.update(np.ascontiguousarray(self._lens))
        h.update(np.ascontiguousarray(self._buf))
        return h.hexdigest()[:16]

    # ---------------- host (oracle) path ----------------

    def word(self, w: int) -> bytes:
        return self._buf[w, :self._lens[w]].tobytes()

    def candidate(self, index: int) -> Optional[bytes]:
        """May return None: the (word, rule) pair rejected."""
        if not 0 <= index < self.keyspace:
            raise IndexError(f"index {index} outside keyspace {self.keyspace}")
        w, r = divmod(index, self.n_rules)
        return apply_rule_cpu(self.word(w), self.rules[r], self.max_len)

    def candidates(self, start: int, count: int) -> list:
        return [self.candidate(i)
                for i in range(start, min(start + count, self.keyspace))]

    def index_of(self, word_index: int, rule_index: int) -> int:
        return word_index * self.n_rules + rule_index

    # ---------------- device path ----------------

    def packed_words(self) -> tuple[np.ndarray, np.ndarray]:
        """(uint8[n_words, max_len], int32[n_words]): rows zero past
        each word's length.  The rule kernel reads rows by word index
        and never past n_words, so no padding is needed."""
        return self._buf, self._lens

    def __repr__(self) -> str:  # pragma: no cover
        return (f"<WordlistRulesGenerator words={self.n_words} "
                f"rules={self.n_rules} keyspace={self.keyspace}>")
