"""The port's MD4 (the NTLM core) against RFC 1320, the reference's
pure-Python oracle and its md4_digest_words, on the same packed words;
the UTF-16LE widened packing against the reference's; the ntlm engines
against each other.  Inputs come from a numpy seed; equality is exact.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dprf_tpu.engines.cpu.md4 import md4 as ref_md4
from dprf_tpu.ops import md4 as ref_md4_ops
from dprf_tpu.ops import pack as ref_pack
from dprf_tpu_torch.engines import get_engine
from dprf_tpu_torch.engines.cpu.md4 import md4
from dprf_tpu_torch.ops import md4 as md4_ops
from dprf_tpu_torch.ops.pack import pack_fixed, utf16le_widen

#: RFC 1320 appendix A.5
RFC1320 = {
    b"": "31d6cfe0d16ae931b73c59d7e0c089c0",
    b"a": "bde52cb31de33e46245e05fbdbd6fb24",
    b"abc": "a448017aaf21d8525fc10ae87aa6729d",
    b"message digest": "d9130a8164549fe818874806e1c7014b",
    b"abcdefghijklmnopqrstuvwxyz": "d79e1c308aa5bbcdeea8ed63df412da9",
    b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789":
        "043f8582f241db351ce627e153e7f0e4",
    b"1234567890" * 8: "e33b4ddc9c38f2199c3e7b164fcc0536",
}


def _cands(length: int, n: int = 32, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed + length).integers(
        0, 256, (n, length), dtype=np.uint8)


def test_oracle_rfc1320_vectors():
    for msg, want in RFC1320.items():
        assert md4(msg).hex() == want


def test_oracle_matches_reference():
    rng = np.random.default_rng(1)
    for n in (0, 1, 55, 56, 63, 64, 65, 200):
        data = rng.bytes(n)
        assert md4(data) == ref_md4(data)


@pytest.mark.parametrize("length", [1, 7, 27])
def test_widened_packing_matches_reference(length):
    cand = _cands(length)
    want = np.asarray(ref_pack.pack_fixed(
        ref_pack.utf16le_widen(jnp.asarray(cand)), 2 * length))
    got = pack_fixed(utf16le_widen(torch.as_tensor(cand)), 2 * length)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(
        pack_fixed(torch.as_tensor(cand), length, widen=True).numpy(),
        got.numpy())


@pytest.mark.parametrize("length", [0, 7, 27, 55])
def test_md4_digest_words_match_reference_and_oracle(length):
    cand = _cands(length)
    packed = ref_pack.pack_fixed(jnp.asarray(cand), length)
    want = np.asarray(ref_md4_ops.md4_digest_words(packed))
    got = md4_ops.md4_digest_words(
        torch.as_tensor(np.asarray(packed).view(np.int32).copy()))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    for row, c in zip(want, cand):
        assert row.astype("<u4").tobytes() == md4(c.tobytes())


def test_ntlm_engines_match_reference_oracle():
    from dprf_tpu.engines.cpu.engines import NtlmEngine as RefNtlm
    cands = [b"", b"password", b"a" * 27, bytes(range(200, 227)), b"Zz9!"]
    want = RefNtlm().hash_batch(cands)
    assert want[1].hex() == "8846f7eaee8fb117ad06bdd830b7586c"
    assert get_engine("ntlm").hash_batch(cands) == want
    dev = get_engine("ntlm", device="cuda", torch_device="cpu")
    assert dev.hash_batch(cands) == want
    with pytest.raises(ValueError):
        dev.hash_batch([b"x" * 28])
