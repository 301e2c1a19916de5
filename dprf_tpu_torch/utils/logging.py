"""Structured logging for the CLI and the coordinator."""

from __future__ import annotations

import sys
import time


class Log:
    def __init__(self, quiet: bool = False, stream=None):
        self.quiet = quiet
        # None = resolve sys.stderr at emit time (so redirection and
        # test capture see loggers created before the capture)
        self._stream = stream
        self._t0 = time.monotonic()

    @property
    def stream(self):
        return self._stream or sys.stderr

    def _emit(self, level: str, msg: str, **kv) -> None:
        if self.quiet and level == "info":
            return
        extra = " ".join(f"{k}={v}" for k, v in kv.items())
        self.stream.write(
            f"[{time.monotonic() - self._t0:8.2f}s] {level:5s} {msg}"
            + (f" {extra}" if extra else "") + "\n")
        self.stream.flush()

    def info(self, msg: str, **kv) -> None:
        self._emit("info", msg, **kv)

    def warn(self, msg: str, **kv) -> None:
        self._emit("warn", msg, **kv)

    def error(self, msg: str, **kv) -> None:
        self._emit("error", msg, **kv)
