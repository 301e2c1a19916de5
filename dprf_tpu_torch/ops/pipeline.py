"""Target words for the fused crack step.

The step itself (index -> candidate -> digest -> compare -> hits) is
``ops/cuda_mask.make_cuda_mask_crack_step``: the hand-written kernel on
a card, its plain PyTorch version on CPU tensors (``--device
torch-cpu``).  This module turns a target's digest into the int32 words
it compares against.
"""

from __future__ import annotations

import numpy as np
import torch


def target_words(digest: bytes, little_endian: bool = True,
                 device="cpu") -> torch.Tensor:
    """Raw digest bytes -> int32[W] in the engine's word layout."""
    words = np.frombuffer(digest, dtype="<u4" if little_endian else ">u4")
    return target_words_from_numpy(words.astype(np.uint32), device=device)


def target_words_from_numpy(words: np.ndarray, device="cpu") -> torch.Tensor:
    """uint32[W] target words (the reference's ``target_words``) ->
    int32[W] tensor with the same bit patterns."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    return torch.as_tensor(words.view(np.int32).copy(), device=device)
