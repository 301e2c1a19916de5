"""The mask kernel's md5 step (ops/cuda_mask.py) against the reference
Pallas kernel (make_pallas_mask_crack_step in interpret mode, and
emulate_mask_kernel), on the same job: the step's hit set, exact.

On the CPU the step runs the kernel's plain PyTorch version, because
its tensors lie on the CPU (what ``--device torch-cpu`` runs).
tests/test_torch_cuda.py holds the CUDA kernel against the plain
version on a card.
"""

import hashlib

import numpy as np
import jax.numpy as jnp
import pytest

from dprf_tpu.generators.mask import MaskGenerator as RefMaskGenerator
from dprf_tpu.ops.pallas_mask import (TILE, emulate_mask_kernel,
                                      make_pallas_mask_crack_step)
from dprf_tpu_torch.engines.base import Target
from dprf_tpu_torch.engines.cpu.engines import Md5Engine
from dprf_tpu_torch.engines.device.engines import TorchMd5Engine
from dprf_tpu_torch.generators.mask import MaskGenerator
from dprf_tpu_torch.ops import cuda_mask
from dprf_tpu_torch.runtime.worker import CudaMaskWorker
from dprf_tpu_torch.runtime.workunit import WorkUnit

pytestmark = pytest.mark.smoke

MASK = "?l?l?l?l"
KEYSPACE = 26 ** 4
#: the planted target's keyspace index: first, last, random (seeded)
PLANTS = {"first": 0, "last": KEYSPACE - 1,
          "random": int(np.random.default_rng(3).integers(0, KEYSPACE))}


def _words(plain: bytes) -> np.ndarray:
    return np.frombuffer(hashlib.md5(plain).digest(), "<u4").astype(np.uint32)


def _batches(plant: int):
    """(start, n_valid) batches around the plant: the aligned batch
    holding it, the batch starting at it, the batch ending at it, the
    partial last batch, a batch without it, and one that n_valid cuts
    off just before it."""
    out = {(plant // TILE * TILE, TILE), (plant, TILE),
           (max(0, plant - TILE + 1), TILE),
           (KEYSPACE // TILE * TILE, KEYSPACE % TILE),
           ((plant + 2 * TILE) % (KEYSPACE - TILE), TILE)}
    if plant >= 10:
        out.add((plant - 10, 10))
    return sorted((s, min(nv, KEYSPACE - s)) for s, nv in out)


def _hit_set(count, lanes):
    lanes = sorted(int(x) for x in np.asarray(lanes).ravel() if x >= 0)
    return int(np.asarray(count).reshape(-1)[0]), lanes


@pytest.mark.parametrize("where", sorted(PLANTS))
def test_step_hit_sets_match_interpret_kernel(where):
    plant = PLANTS[where]
    ref_gen, gen = RefMaskGenerator(MASK), MaskGenerator(MASK)
    tw = _words(gen.candidate(plant))
    ref_step = make_pallas_mask_crack_step("md5", ref_gen, tw, batch=TILE,
                                           interpret=True)
    kern_step = cuda_mask.make_cuda_mask_crack_step("md5", gen, tw, TILE, 64,
                                                    device="cpu")
    for start, n_valid in _batches(plant):
        digits = gen.digits(start)
        want = _hit_set(*ref_step(jnp.asarray(digits, jnp.int32),
                                  jnp.int32(n_valid))[:2])
        expect = [plant - start] if 0 <= plant - start < n_valid else []
        assert want == (len(expect), expect), (start, n_valid)
        assert _hit_set(*kern_step(digits, n_valid)[:2]) == want


def test_step_matches_emulated_kernel():
    plant = PLANTS["random"]
    ref_gen, gen = RefMaskGenerator(MASK), MaskGenerator(MASK)
    tw = _words(gen.candidate(plant))
    start = plant - 1000 if plant >= 1000 else plant
    counts, lanes = emulate_mask_kernel("md5", ref_gen, tw, TILE,
                                        ref_gen.digits(start), TILE,
                                        sub=TILE // 128)
    want = sorted(int(t * TILE + l) for t, (c, l) in
                  enumerate(zip(counts[:, 0], lanes[:, 0])) if c == 1)
    count, got = cuda_mask.mask_plain(
        "md5", gen.charset_lut(), gen.radices, gen.digits(start), TILE,
        [int(w) for w in tw], 64, TILE)
    assert (int(count), sorted(got[got >= 0].tolist())) == (len(want), want)
    assert want == [plant - start]


def test_kernel_eligible():
    gen = MaskGenerator(MASK)
    assert cuda_mask.kernel_eligible("md5", gen, 1)
    assert cuda_mask.kernel_eligible("md5", gen, 8192)
    # past N_BULK the bulk probe: a list of any length
    assert cuda_mask.kernel_eligible("md5", gen, 8193)
    assert cuda_mask.kernel_eligible("md5", gen, 10 ** 7)
    assert not cuda_mask.kernel_eligible("md5", gen, 0)
    assert not cuda_mask.kernel_eligible("md5crypt", gen, 1)
    assert cuda_mask.kernel_eligible("sha512", gen, 1)
    assert cuda_mask.kernel_eligible("sha-384", MaskGenerator("?d" * 111), 1)
    assert not cuda_mask.kernel_eligible("sha512", MaskGenerator("?d" * 112),
                                         1)
    assert not cuda_mask.kernel_eligible("md5", MaskGenerator("?d" * 56), 1)
    with pytest.raises(ValueError):
        cuda_mask.make_cuda_mask_crack_step("md5", MaskGenerator("?d" * 56),
                                            _words(b"x"), TILE)


def _worker_direct(gen, targets, hit_cap):
    return CudaMaskWorker(TorchMd5Engine("cpu"), gen, targets, batch=1024,
                          hit_capacity=hit_cap, oracle=Md5Engine(),
                          device="cpu")


def _worker_from_engine(gen, targets, hit_cap):
    return TorchMd5Engine("cpu").make_mask_worker(
        gen, targets, batch=1024, hit_capacity=hit_cap, oracle=Md5Engine())


@pytest.mark.parametrize("make_worker", [_worker_direct, _worker_from_engine])
@pytest.mark.parametrize("hit_cap", [0, 4])
def test_worker_overflow_rescans_exactly(make_worker, hit_cap):
    """A batch whose count exceeds its hit buffer goes to the oracle
    rescan; a unit of several batches finds its hit in the right one
    and the launch counter of the CUDA kernel stays 0 on the CPU.  The
    unit goes out as one loop-superstep window of 4 batches, which a
    hit capacity of 0 overflows, so its batches run again one by one
    before the rescan.  The worker is built directly and through the
    engine, as the CLI does."""
    gen = MaskGenerator(MASK)
    plant = 2 * 1024 + 517
    d = hashlib.md5(gen.candidate(plant)).digest()
    launches = dict(cuda_mask.launches)
    w = make_worker(gen, [Target(d.hex(), d)], hit_cap)
    assert isinstance(w, CudaMaskWorker)
    hits = w.process(WorkUnit(0, 0, 4 * 1024))
    assert [(h.target_index, h.cand_index, h.plaintext) for h in hits] == \
        [(0, plant, gen.candidate(plant))]
    assert w.dispatched == (8 if hit_cap == 0 else 4)
    assert w.process(WorkUnit(1, 4 * 1024, 1024)) == []
    assert cuda_mask.launches == launches


def test_worker_overflow_without_oracle_raises():
    """An overflowing dispatch is relaunched on the device with a buffer
    of its count, which needs no oracle; only a relaunch that cannot hold
    the hits either goes to the oracle rescan, and without an oracle
    that raises."""
    gen = MaskGenerator(MASK)
    d = hashlib.md5(gen.candidate(5)).digest()
    w = CudaMaskWorker(TorchMd5Engine("cpu"), gen, [Target(d.hex(), d)],
                       batch=64, hit_capacity=0, device="cpu")
    hits = w.process(WorkUnit(0, 0, 64))
    assert [(h.cand_index, h.plaintext) for h in hits] == \
        [(5, gen.candidate(5))]
    assert (w.relaunches, w.rescans) == (1, 0)
    w._relaunch = lambda bstart, span, capacity: w.step(
        gen.digits(bstart), span, cap=0)
    with pytest.raises(RuntimeError):
        w.process(WorkUnit(1, 0, 64))
