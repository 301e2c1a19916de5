"""The multi-target state of the mask kernel against the reference's:
the Bloom rows (ops/bloom.py vs pallas_mask.bloom_tables), the plain
prefilter (vs pallas_mask.bloom_found run eagerly over one (sub, 128)
tile), and the sorted target table with its order and exact compare
(ops/compare.py vs dprf_tpu/ops/compare.py).  Digests come from a numpy
seed; equality is exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dprf_tpu.ops import compare as ref_cmp
from dprf_tpu.ops import pallas_mask as ref_pm
from dprf_tpu_torch.ops import bloom
from dprf_tpu_torch.ops import compare as cmp_ops

pytestmark = pytest.mark.smoke


def _words(n: int, w: int = 4, seed: int = 7) -> np.ndarray:
    return np.random.default_rng(seed + n).integers(
        0, 1 << 32, size=(n, w), dtype=np.uint64).astype(np.uint32)


def test_geometry_matches_reference():
    assert (bloom.K_PROBES, bloom.SET_SIZE, bloom.MAX_TARGETS) == \
        (ref_pm.K_PROBES, ref_pm.SET_SIZE, ref_pm.MAX_TARGETS)


@pytest.mark.parametrize("n", [1, 1000, 2500, 8192])
def test_bloom_tables_match_reference(n):
    tw = _words(n, w=5 if n == 2500 else 4)
    got = bloom.bloom_tables(tw)
    assert got.shape == (bloom.n_sets(n) * bloom.K_PROBES, 128)
    np.testing.assert_array_equal(got, ref_pm.bloom_tables(tw))
    with pytest.raises(ValueError):
        bloom.bloom_tables(_words(8193))


def test_bloom_never_false_negative():
    """Every target passes its own set's 8 probes (the reference's
    test_bloom_tables_never_false_negative case, through the plain
    prefilter)."""
    tw = _words(2500)
    rows = torch.as_tensor(bloom.bloom_tables(tw).view(np.int32))
    digest = torch.as_tensor(tw.view(np.int32))
    found = bloom.bloom_found(digest, rows, torch.ones(2500, dtype=torch.bool))
    assert bool(found.all())


@pytest.mark.parametrize("n,w", [(1000, 4), (2500, 8)])
def test_bloom_found_matches_reference(n, w):
    """The plain prefilter's mask equals the reference's bloom_found on
    the same digest words over an (8, 128) tile: random digests, some
    targets' own digests, and an invalid tail."""
    tw = _words(n, w)
    tile = _words(1024, w, seed=99)
    tile[::97] = tw[:len(tile[::97])]
    # near misses: a target's digest with one probe bit flipped
    tile[5::101] = tw[-len(tile[5::101]):] ^ np.uint32(1 << 13)
    valid = np.arange(1024) < 1000
    rows = bloom.bloom_tables(tw)
    want = ref_pm.bloom_found(
        tuple(jnp.asarray(tile[:, j].reshape(8, 128)) for j in range(w)),
        jnp.asarray(rows), jnp.asarray(valid.reshape(8, 128)),
        bloom.n_sets(n), (8, 128))
    got = bloom.bloom_found(torch.as_tensor(tile.view(np.int32)),
                            torch.as_tensor(rows.view(np.int32)),
                            torch.as_tensor(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).reshape(-1))
    assert 0 < int(got.sum()) < 1000


def _colliding_digests():
    mk = lambda w0, tail: (w0.to_bytes(4, "little")
                           + tail.to_bytes(12, "little"))
    rng = np.random.default_rng(3)
    rand = [rng.bytes(16) for _ in range(200)]
    return rand + [mk(5, 3), mk(5, 1), mk(0xF0000005, 2), mk(5, 2),
                   mk(0xF0000005, 1), mk(9, 1), mk(2, 7)]


@pytest.mark.parametrize("little_endian", [True, False])
def test_target_table_matches_reference(little_endian):
    digests = _colliding_digests()
    ref = ref_cmp.make_target_table(digests, little_endian=little_endian)
    got = cmp_ops.make_target_table(digests, little_endian)
    np.testing.assert_array_equal(got.words, np.asarray(ref.words))
    np.testing.assert_array_equal(got.order, ref.order)
    assert got.num_targets == len(digests)
    np.testing.assert_array_equal(
        got.original_words(), cmp_ops.digest_rows(digests, little_endian))


def test_compare_multi_matches_reference():
    """Targets sharing word 0 (some above 2^31, where int32 and uint32
    order differ), near misses and random probes: the same found mask
    and table positions as the reference's compare_multi."""
    digests = _colliding_digests()
    mk = lambda w0, tail: (w0.to_bytes(4, "little")
                           + tail.to_bytes(12, "little"))
    probes = digests[::3] + digests[-7:] + [mk(5, 99), mk(0xF0000005, 99),
                                            mk(1, 1), mk(10, 1)]
    rows = np.stack([np.frombuffer(d, "<u4") for d in probes]).astype(
        np.uint32)
    ref_table = ref_cmp.make_target_table(digests)
    want_found, want_pos = ref_cmp.compare_multi(jnp.asarray(rows), ref_table)
    table = cmp_ops.make_target_table(digests)
    found, tpos = cmp_ops.compare_multi(torch.as_tensor(rows.view(np.int32)),
                                        table.tensor("cpu"))
    np.testing.assert_array_equal(found.numpy(), np.asarray(want_found))
    np.testing.assert_array_equal(tpos.numpy()[found.numpy()],
                                  np.asarray(want_pos)[found.numpy()])
    assert int(found.sum()) == len(probes) - 4
    for i in np.flatnonzero(found.numpy()):
        assert digests[table.order[int(tpos[i])]] == probes[i]


def test_expected_probes():
    """One empty set costs 1 probe; one full set 8."""
    empty = np.zeros((8, 128), np.uint32)
    assert bloom.expected_probes(empty) == 1.0
    assert bloom.expected_probes(empty | np.uint32(0xFFFFFFFF)) == 8.0
