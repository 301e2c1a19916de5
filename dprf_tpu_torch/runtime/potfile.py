"""Potfile: the cracked-results store (hash:plaintext append log).

The reference's exact text format: a global file keyed by the target
hash text; plaintexts that aren't printable ASCII are stored as
$HEX[...] so the file stays line-oriented and lossless.
"""

from __future__ import annotations

import os
import re

_HEX_RE = re.compile(r"^\$HEX\[([0-9a-fA-F]*)\]$")


def encode_plain(plain: bytes) -> str:
    text = plain.decode("ascii", errors="replace")
    if plain and all(0x20 <= b < 0x7F for b in plain) and ":" not in text \
            and not _HEX_RE.match(text):
        return text
    return f"$HEX[{plain.hex()}]"


def decode_plain(text: str) -> bytes:
    m = _HEX_RE.match(text)
    if m:
        return bytes.fromhex(m.group(1))
    return text.encode("latin-1")


class Potfile:
    def __init__(self, path: str):
        self.path = path
        self._cracked: dict[str, bytes] = {}
        if os.path.exists(path):
            with open(path, encoding="utf-8") as fh:
                for line in fh:
                    line = line.rstrip("\n")
                    if not line or ":" not in line:
                        continue
                    key, _, plain = line.rpartition(":")
                    self._cracked[key] = decode_plain(plain)

    def __contains__(self, target_key: str) -> bool:
        return target_key in self._cracked

    def get(self, target_key: str):
        return self._cracked.get(target_key)

    def add(self, target_key: str, plain: bytes) -> None:
        if target_key in self._cracked:
            return
        self._cracked[target_key] = plain
        with open(self.path, "a", encoding="utf-8") as fh:
            fh.write(f"{target_key}:{encode_plain(plain)}\n")
            fh.flush()
            os.fsync(fh.fileno())

    def __len__(self) -> int:
        return len(self._cracked)
