"""The port's mask generator against the reference's: digits, candidate,
index_of and decode_batch on the same random indices (numpy seed),
exact equality."""

import numpy as np
import jax.numpy as jnp
import pytest

from dprf_tpu.generators.mask import MaskGenerator as RefMaskGenerator
from dprf_tpu_torch.generators.mask import MaskGenerator, decode_lut

#: a custom charset in scrambled order: more pieces than MAX_SEGMENTS,
#: so decode_batch takes the lut gather for it
_SCRAMBLED = bytes(np.random.default_rng(7).permutation(256)[:40]
                   .astype(np.uint8))

MASKS = [
    ("?l?l?l?l", None),
    ("?a?s?a", None),
    ("?b?d?u", None),
    ("ab?l??x?d", None),
    ("?1?2?l", {1: b"0123456789abcdef", 2: _SCRAMBLED}),
]


def _pair(mask, custom):
    return RefMaskGenerator(mask, custom=custom), MaskGenerator(mask,
                                                                custom=custom)


@pytest.mark.parametrize("mask,custom", MASKS)
def test_host_decode_matches_reference(mask, custom):
    ref, gen = _pair(mask, custom)
    assert gen.charsets == ref.charsets
    assert gen.radices == ref.radices
    assert gen.keyspace == ref.keyspace
    rng = np.random.default_rng(1)
    idx = [0, gen.keyspace - 1] + [int(i) for i in
                                   rng.integers(0, gen.keyspace, 50)]
    for i in idx:
        assert gen.digits(i) == ref.digits(i)
        cand = gen.candidate(i)
        assert cand == ref.candidate(i)
        assert gen.index_of(cand) == ref.index_of(cand) == i


@pytest.mark.parametrize("mask,custom", MASKS)
def test_decode_batch_matches_reference(mask, custom):
    ref, gen = _pair(mask, custom)
    rng = np.random.default_rng(2)
    batch = 512
    for start in [0, max(0, gen.keyspace - batch),
                  int(rng.integers(0, gen.keyspace))]:
        digits = gen.digits(start)
        want = np.asarray(ref.decode_batch(jnp.asarray(digits, jnp.int32),
                                           ref.flat_charsets, batch))
        got = gen.decode_batch(digits, gen.charset_lut(), batch).numpy()
        np.testing.assert_array_equal(got, want)
        # every position through the lut gather, as the kernel's plain
        # version decodes
        gathered = decode_lut(gen.charset_lut(), gen.radices, digits, batch)
        np.testing.assert_array_equal(gathered.numpy(), want)
        # the lanes inside the keyspace are the host decode's candidates
        for lane in range(0, min(batch, gen.keyspace - start), 97):
            assert bytes(got[lane]) == ref.candidate(start + lane)


def test_from_charsets_and_lut():
    ref = RefMaskGenerator("?1?d?s", custom={1: _SCRAMBLED})
    gen = MaskGenerator.from_charsets(ref.charsets)
    assert gen.keyspace == ref.keyspace
    lut = gen.charset_lut().numpy()
    assert lut.shape == (3, 256)
    for p, cs in enumerate(ref.charsets):
        assert bytes(lut[p, :len(cs)]) == cs
        assert not lut[p, len(cs):].any()
    with pytest.raises(ValueError):
        MaskGenerator.from_charsets([b"ab", b""])
