"""HashEngine plugin interface.

An engine turns candidate passwords into digests and checks them
against targets.  CPU engines are the bit-exact oracles; device engines
(dprf_tpu_torch.engines.device) compute the same digests on torch
tensors, on a CUDA card or on the CPU.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, ClassVar, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class Target:
    """A single crack target.

    digest: the binary value a candidate's digest must equal.
    params: per-target parameters needed to compute candidate digests
        (empty for the unsalted fast hashes).
    """

    raw: str
    digest: bytes
    params: dict = dataclasses.field(default_factory=dict)


class TargetRefused(ValueError):
    """A target the card's path does not take.  ``target_index`` is its
    position in the job, which the CLI turns into its hashlist line."""

    def __init__(self, target_index: int, message: str):
        super().__init__(message)
        self.target_index = target_index


class HashEngine(abc.ABC):
    """Algorithm plugin: candidate bytes -> digest -> compare vs targets."""

    name: ClassVar[str]
    digest_size: ClassVar[int]
    #: salted engines need Target.params to hash a candidate
    salted: ClassVar[bool] = False
    #: longest candidate (in bytes, pre-encoding) the engine accepts
    max_candidate_len: ClassVar[int] = 55

    def parse_target(self, text: str) -> Target:
        """Parse one hashlist line.  Default: a bare hex digest."""
        text = text.strip()
        digest = bytes.fromhex(text)
        if len(digest) != self.digest_size:
            raise ValueError(
                f"{self.name}: expected {self.digest_size}-byte digest, "
                f"got {len(digest)} bytes from {text!r}")
        return Target(raw=text, digest=digest)

    @abc.abstractmethod
    def hash_batch(self, candidates: Sequence[bytes],
                   params: Optional[dict] = None) -> list[bytes]:
        """Digest a batch of candidate passwords."""

    def verify(self, candidate: bytes, target: Target) -> bool:
        return (self.hash_batch([candidate], params=target.params)[0]
                == target.digest)

    def __repr__(self) -> str:  # pragma: no cover
        return f"<{type(self).__name__} {self.name}>"


class DeviceHashEngine(abc.ABC):
    """Device-side engine: digests computed on packed message blocks.

    The unit of work is a packed batch: candidates laid out as int32
    message words (the bit pattern of the reference's uint32 words),
    produced on the device from a unit's base digits so plaintext never
    crosses the host boundary.
    """

    name: ClassVar[str]
    digest_size: ClassVar[int]
    #: number of 32-bit words of digest output
    digest_words: ClassVar[int]

    @abc.abstractmethod
    def digest_packed(self, blocks: Any) -> Any:
        """blocks: int32[batch, 16] -> int32[batch, digest_words]."""
