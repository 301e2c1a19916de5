"""The port's SHA-1 and SHA-256 cores against hashlib and the
reference's sha1_digest_words / sha256_digest_words on the same packed
words, their constants against the reference's and the CUDA source's,
and the sha engines against hashlib.  Inputs come from a numpy seed;
equality is exact."""

import hashlib
import os
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dprf_tpu.ops import pack as ref_pack
from dprf_tpu.ops import sha1 as ref_sha1
from dprf_tpu.ops import sha256 as ref_sha256
from dprf_tpu_torch.engines import get_engine
from dprf_tpu_torch.ops import sha1 as sha1_ops
from dprf_tpu_torch.ops import sha256 as sha256_ops
from dprf_tpu_torch.ops.pack import pack_fixed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = {"sha1": (sha1_ops.sha1_digest_words, ref_sha1.sha1_digest_words),
         "sha256": (sha256_ops.sha256_digest_words,
                    ref_sha256.sha256_digest_words)}


@pytest.mark.parametrize("algo", sorted(CASES))
@pytest.mark.parametrize("length", [0, 7, 55])
def test_digest_words_match_reference_and_hashlib(algo, length):
    port, ref = CASES[algo]
    cand = np.random.default_rng(length).integers(0, 256, (16, length),
                                                  dtype=np.uint8)
    packed = ref_pack.pack_fixed(jnp.asarray(cand), length, big_endian=True)
    got = port(pack_fixed(torch.as_tensor(cand), length, big_endian=True))
    np.testing.assert_array_equal(
        np.asarray(packed), pack_fixed(torch.as_tensor(cand), length,
                                       big_endian=True).numpy()
        .view(np.uint32))
    want = np.asarray(ref(packed))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    for row, c in zip(want, cand):
        assert row.astype(">u4").tobytes() == \
            hashlib.new(algo, c.tobytes()).digest()


def test_constants_match_reference_and_cuda_source():
    np.testing.assert_array_equal(sha256_ops.K, ref_sha256.K)
    np.testing.assert_array_equal(sha256_ops.INIT, ref_sha256.INIT)
    np.testing.assert_array_equal(sha1_ops.INIT, ref_sha1.INIT)
    with open(os.path.join(REPO, "dprf_tpu_torch", "csrc",
                           "cores.cuh")) as fh:
        src = fh.read()
    body = re.search(r"K_SHA256\[64\]\s*=\s*\{([^}]*)\}", src).group(1)
    assert [int(h, 16) for h in re.findall(r"0x([0-9a-f]{8})u", body)] \
        == [int(k) for k in sha256_ops.K]


@pytest.mark.parametrize("name", ["sha1", "sha-1", "sha256", "sha-256"])
def test_engines_match_hashlib(name):
    algo = name.replace("-", "")
    cands = [b"", b"abc", bytes(range(55)), b"password"]
    want = [hashlib.new(algo, c).digest() for c in cands]
    assert get_engine(name).hash_batch(cands) == want
    dev = get_engine(name, device="cuda", torch_device="cpu")
    assert dev.name == algo
    assert dev.hash_batch(cands) == want
