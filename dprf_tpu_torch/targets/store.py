"""TargetStore: bulk hashlist ingest for multi-target jobs -- the port's
copy of the reference's ``dprf_tpu/targets/store.py``.

One object owning what ``crack --targets-file`` needs from a
hashcat-style ``hash[:salt]`` file: the parsed, deduplicated Target list
(utils/hashlist.py does the per-line work), a malformed-line report, and
a content fingerprint that is stable across line order and duplicates
and equal, byte for byte, to the reference's for the same engine and
lines.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Optional, Sequence

from dprf_tpu_torch.utils.hashlist import parse_lines


class TargetStore:
    """Parsed target set + ingest report + cached fingerprint."""

    def __init__(self, engine, targets: Sequence, skipped=(),
                 duplicates: int = 0, source: Optional[str] = None,
                 line_numbers: Sequence[int] = ()):
        self.engine = engine
        self.targets = list(targets)
        self.skipped = list(skipped)     # (line_no, text, error)
        self.duplicates = int(duplicates)
        self.source = source
        #: each target's line number (from 1), in the order of ``targets``
        self.line_numbers = list(line_numbers)
        self._lock = threading.Lock()
        self._fingerprint: Optional[str] = None

    @classmethod
    def from_lines(cls, engine, lines: Sequence[str],
                   source: Optional[str] = None,
                   log=None) -> "TargetStore":
        hl = parse_lines(engine, lines)
        store = cls(engine, hl.targets, hl.skipped, hl.duplicates,
                    source=source, line_numbers=hl.line_numbers)
        if log is not None:
            for no, _text, err in hl.skipped:
                log.warn("targets file: skipping malformed line",
                         source=source or "<lines>", line=no,
                         error=err)
            log.info("loaded target set", source=source or "<lines>",
                     targets=len(store.targets),
                     duplicates=store.duplicates,
                     malformed=len(store.skipped))
        return store

    @classmethod
    def from_file(cls, engine, path: str, log=None) -> "TargetStore":
        with open(path, encoding="utf-8", errors="replace") as fh:
            lines = fh.readlines()
        return cls.from_lines(engine, lines, source=path, log=log)

    def __len__(self) -> int:
        return len(self.targets)

    def lines(self) -> list:
        """The deduplicated target lines."""
        return [t.raw for t in self.targets]

    @property
    def fingerprint(self) -> str:
        """sha256 over the engine name and the SORTED raw target
        lines: line order and dropped duplicates do not change it, a
        different target set always does."""
        with self._lock:
            if self._fingerprint is None:
                h = hashlib.sha256()
                h.update(getattr(self.engine, "name",
                                 "?").encode("utf-8"))
                for raw in sorted(t.raw for t in self.targets):
                    h.update(b"\x00")
                    h.update(raw.encode("utf-8", errors="replace"))
                self._fingerprint = h.hexdigest()
            return self._fingerprint

    def report(self) -> dict:
        """Ingest summary for the log."""
        return {
            "targets": len(self.targets),
            "duplicates": self.duplicates,
            "malformed": [
                {"line": no, "error": err}
                for no, _text, err in self.skipped],
            "fingerprint": self.fingerprint,
            "source": self.source,
        }
