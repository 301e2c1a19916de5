"""The mask kernel's multi-target step against the reference, on the CPU (the kernel's plain version, what ``--device
torch-cpu`` runs):

- md5 and ntlm at 1,000 targets: the worker's hit set against the
  reference PallasMaskWorker in interpret mode, in the reference's own
  scenario (test_pallas_mask.py: ?l?l?l?l, plants at 7, 2000,
  2*TILE+11 and 5*TILE+4095, two hits in one tile), and the step's
  n_maybe against the reference kernel's per-tile Bloom counts;
- the overflow rescan of a multi-target batch, and kernel_eligible.
"""

import numpy as np
import pytest

from dprf_tpu.engines import get_engine as ref_get_engine
from dprf_tpu.generators.mask import MaskGenerator as RefMaskGenerator
from dprf_tpu.ops.pallas_mask import TILE, emulate_mask_kernel
from dprf_tpu.runtime.worker import PallasMaskWorker
from dprf_tpu.runtime.workunit import WorkUnit as RefWorkUnit
from dprf_tpu_torch.engines import get_engine
from dprf_tpu_torch.generators.mask import MaskGenerator
from dprf_tpu_torch.ops import cuda_mask
from dprf_tpu_torch.ops.compare import make_target_table
from dprf_tpu_torch.runtime.worker import CudaMaskWorker
from dprf_tpu_torch.runtime.workunit import WorkUnit

pytestmark = pytest.mark.smoke

MASK = "?l?l?l?l"
PLANTS = [7, 2000, 2 * TILE + 11, 5 * TILE + 4095]


def _targets(engine: str, plants, n_fill: int, seed: int = 3):
    """Raw digests: the planted candidates' and n_fill random ones."""
    oracle = get_engine(engine)
    gen = MaskGenerator(MASK)
    rng = np.random.default_rng(seed)
    digests = oracle.hash_batch([gen.candidate(i) for i in plants])
    digests += [rng.bytes(oracle.digest_size) for _ in range(n_fill)]
    return digests


def _hits(hits):
    return sorted((h.target_index, h.cand_index, h.plaintext) for h in hits)


@pytest.mark.parametrize("engine", ["md5", "ntlm"])
def test_multi_worker_matches_interpret_kernel(engine):
    digests = _targets(engine, PLANTS, 996)
    ref_eng = ref_get_engine(engine, device="jax")
    ref_targets = [ref_eng.parse_target(d.hex()) for d in digests]
    ref = PallasMaskWorker(ref_eng, RefMaskGenerator(MASK), ref_targets,
                           batch=2 * TILE, hit_capacity=8,
                           oracle=ref_get_engine(engine), interpret=True)
    want = _hits(ref.process(RefWorkUnit(0, 0, 6 * TILE)))

    eng = get_engine(engine, device="cuda", torch_device="cpu")
    targets = [eng.parse_target(d.hex()) for d in digests]
    gen = MaskGenerator(MASK)
    w = eng.make_mask_worker(gen, targets, batch=2 * TILE, hit_capacity=8,
                             oracle=get_engine(engine))
    assert isinstance(w, CudaMaskWorker) and w.multi
    got = _hits(w.process(WorkUnit(0, 0, 6 * TILE)))
    assert got == want
    assert [(t, c, p) for t, c, p in got] == \
        [(i, c, gen.candidate(c)) for i, c in enumerate(PLANTS)]
    assert w.dispatched == 3 and w.n_maybe() >= len(PLANTS)


@pytest.mark.parametrize("engine", ["md5", "ntlm"])
def test_multi_step_maybes_match_reference_counts(engine):
    """One tile holding the colliding plants at 7 and 2000: the step's n_maybe is the sum of the reference kernel's
    per-tile Bloom counts, and it returns exactly the real hits."""
    digests = _targets(engine, PLANTS, 996)
    table = make_target_table(digests, little_endian=True)
    gen, ref_gen = MaskGenerator(MASK), RefMaskGenerator(MASK)
    counts, _ = emulate_mask_kernel(engine, ref_gen, table.original_words(),
                                    TILE, ref_gen.digits(0), TILE)
    step = cuda_mask.make_cuda_multi_crack_step(engine, gen, table, TILE,
                                                hit_capacity=8, device="cpu")
    count, lanes, tpos, n_maybe = step(gen.digits(0), TILE)
    assert int(n_maybe) == int(counts.sum()) >= 2
    assert int(count) == 2
    assert sorted(zip(lanes[:2].tolist(), table.order[tpos[:2]].tolist())) \
        == [(7, 0), (2000, 1)]


@pytest.mark.parametrize("hit_cap", [0, 1])
def test_multi_worker_overflow_rescans_exactly(hit_cap):
    """Two hits in one batch of a multi-target job overflow a hit
    buffer of 0: the unit's window of 2 batches runs again batch by
    batch and the batch goes to the oracle rescan, which finds both
    with their target indices.  At a hit capacity of 1 the window's
    buffer holds 2 hits, and both come back from the card."""
    gen = MaskGenerator(MASK)
    plants = [1500, 1501]
    digests = _targets("ntlm", plants, 30)[::-1]
    eng = get_engine("ntlm", device="cuda", torch_device="cpu")
    targets = [eng.parse_target(d.hex()) for d in digests]
    w = CudaMaskWorker(eng, gen, targets, batch=1024, hit_capacity=hit_cap,
                       oracle=get_engine("ntlm"), device="cpu")
    hits = _hits(w.process(WorkUnit(0, 1024, 2048)))
    assert hits == [(30, 1501, gen.candidate(1501)),
                    (31, 1500, gen.candidate(1500))]
    assert w.dispatched == (4 if hit_cap == 0 else 2)


def test_kernel_eligible_limits():
    assert cuda_mask.kernel_eligible("ntlm", MaskGenerator("?d" * 27), 1)
    assert not cuda_mask.kernel_eligible("ntlm", MaskGenerator("?d" * 28), 1)
    assert cuda_mask.kernel_eligible("sha256", MaskGenerator("?d" * 55), 8192)
    assert cuda_mask.kernel_eligible("sha-1", MaskGenerator("?d"), 8193)
    assert not cuda_mask.kernel_eligible("sha-1", MaskGenerator("?d"), 0)
    gen = MaskGenerator("?d" * 28)
    eng = get_engine("ntlm", device="cuda", torch_device="cpu")
    with pytest.raises(ValueError, match="no mask kernel"):
        eng.make_mask_worker(gen, [eng.parse_target("00" * 16)], batch=64,
                             hit_capacity=4)


def test_message_block_matches_packing():
    """The kernel's fixed message words are the block of an all-zero
    candidate: ntlm widened and little-endian, sha big-endian."""
    assert cuda_mask.message_block("ntlm", 7)[3] == 0x80 << 16
    assert cuda_mask.message_block("ntlm", 7)[14] == 8 * 14
    assert cuda_mask.message_block("sha1", 7)[1] == 0x80
    assert cuda_mask.message_block("sha256", 7)[15] == 8 * 7
    assert cuda_mask.message_block("md5", 6)[1] == 0x80 << 16
