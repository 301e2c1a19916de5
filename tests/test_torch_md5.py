"""The port's pack_fixed and md5_digest_words against the reference ops
and hashlib, on random candidates from a numpy seed; exact equality.
Also holds the CUDA source's MD5 constant table against ops/md5.K."""

import hashlib
import os
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dprf_tpu.ops import md5 as ref_md5
from dprf_tpu.ops import pack as ref_pack
from dprf_tpu.ops.pipeline import target_words as ref_target_words
from dprf_tpu_torch.engines import get_engine
from dprf_tpu_torch.ops import md5 as md5_ops
from dprf_tpu_torch.ops.pack import pack_fixed
from dprf_tpu_torch.ops.compare import digest_rows, target_words_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cands(length: int, n: int = 64, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed + length).integers(
        0, 256, (n, length), dtype=np.uint8)


@pytest.mark.parametrize("length", [1, 6, 8, 31, 55])
def test_pack_fixed_matches_reference(length):
    cand = _cands(length)
    want = np.asarray(ref_pack.pack_fixed(jnp.asarray(cand), length))
    got = pack_fixed(torch.as_tensor(cand), length).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want)
    with pytest.raises(ValueError):
        pack_fixed(torch.zeros((1, 56), dtype=torch.uint8), 56)


@pytest.mark.parametrize("length", [0, 5, 16, 55])
def test_md5_digest_words_matches_reference_and_hashlib(length):
    cand = _cands(length)
    words = pack_fixed(torch.as_tensor(cand), length)
    got = md5_ops.md5_digest_words(words).numpy().view(np.uint32)
    want = np.asarray(ref_md5.md5_digest_words(
        ref_pack.pack_fixed(jnp.asarray(cand), length)))
    np.testing.assert_array_equal(got, want)
    for row, c in zip(got, cand):
        assert row.astype("<u4").tobytes() == hashlib.md5(c.tobytes()).digest()


def test_constants_match_reference():
    np.testing.assert_array_equal(md5_ops.K, ref_md5.K)
    np.testing.assert_array_equal(md5_ops.INIT, ref_md5.INIT)


def test_cuda_source_constant_table():
    """The kernels' K_MD5 table (hex in csrc/cores.cuh) is the one
    ops/md5.py computes from math.sin."""
    with open(os.path.join(REPO, "dprf_tpu_torch", "csrc",
                           "cores.cuh")) as fh:
        src = fh.read()
    body = re.search(r"K_MD5\[64\]\s*=\s*\{([^}]*)\}", src).group(1)
    table = [int(h, 16) for h in re.findall(r"0x([0-9a-f]{8})u", body)]
    assert table == [int(k) for k in md5_ops.K]


def test_engine_hash_batch_matches_hashlib():
    eng = get_engine("md5", device="cuda", torch_device="cpu")
    cands = [b"", b"a", b"password", bytes(range(55)), b"zz", b"abc"]
    assert eng.hash_batch(cands) == [hashlib.md5(c).digest() for c in cands]
    with pytest.raises(ValueError):
        eng.hash_batch([b"x" * 56])


def test_target_words_match_reference():
    digest = hashlib.md5(b"zzzzzz").digest()
    ref = np.asarray(ref_target_words(digest))
    np.testing.assert_array_equal(
        target_words_from_numpy(ref).numpy().view(np.uint32), ref)
    np.testing.assert_array_equal(
        digest_rows([digest])[0], ref)


@pytest.mark.parametrize("length", [0, 5, 63, 64])
def test_pack_raw_matches_reference(length):
    """The HMAC key-block layout: zero padding, no marker, no length."""
    rng = np.random.default_rng(length)
    cand = rng.integers(0, 256, (3, length), dtype=np.uint8)
    from dprf_tpu_torch.ops.pack import pack_raw
    got = pack_raw(torch.as_tensor(cand))
    want = ref_pack.pack_raw(jnp.asarray(cand), length, big_endian=True)
    assert (got.numpy().view(np.uint32) == np.asarray(want)).all()
