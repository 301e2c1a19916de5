"""The mask kernel's sha1 and sha256 steps, one target and a list,
against the reference kernel body run eagerly (emulate_mask_kernel):
the reference refuses those kernels off a TPU.  On the CPU the steps
run the kernel's plain version."""

import numpy as np
import pytest

from dprf_tpu.generators.mask import MaskGenerator as RefMaskGenerator
from dprf_tpu.ops.pallas_mask import emulate_mask_kernel
from dprf_tpu_torch.engines import get_engine
from dprf_tpu_torch.generators.mask import MaskGenerator
from dprf_tpu_torch.ops import cuda_mask
from dprf_tpu_torch.ops.compare import make_target_table

pytestmark = pytest.mark.smoke


def _sha_job(engine: str, multi: bool):
    gen, ref_gen = MaskGenerator("?l?d?l"), RefMaskGenerator("?l?d?l")
    plants = [0, 517, 518, 1023]
    oracle = get_engine(engine)
    digests = oracle.hash_batch([gen.candidate(i) for i in plants])
    if multi:
        rng = np.random.default_rng(5)
        digests += oracle.hash_batch([rng.bytes(8) for _ in range(1200)])
    return gen, ref_gen, make_target_table(digests, False)


@pytest.mark.parametrize("engine", ["sha1", "sha256"])
@pytest.mark.parametrize("multi", [False, True])
def test_sha_steps_match_emulated_kernel(engine, multi):
    """One tile of 1,024 lanes (sub=8), n_valid cutting the last plant
    off: the step's hits and n_maybe against the reference kernel body
    run eagerly."""
    gen, ref_gen, table = _sha_job(engine, multi)
    target = np.frombuffer(get_engine(engine).hash_batch(
        [gen.candidate(517)])[0], ">u4").astype(np.uint32)
    tw = table.original_words() if multi else target
    counts, lanes = emulate_mask_kernel(engine, ref_gen, tw, 1024,
                                        ref_gen.digits(0), 1023, sub=8)
    n_valid = 1023
    if multi:
        step = cuda_mask.make_cuda_multi_crack_step(
            engine, gen, table, 1024, hit_capacity=8, device="cpu")
        count, got, tpos, n_maybe = step(gen.digits(0), n_valid)
        assert int(n_maybe) == int(counts.sum())
        assert sorted(table.order[tpos[:int(count)]].tolist()) == [0, 1, 2]
    else:
        step = cuda_mask.make_cuda_mask_crack_step(
            engine, gen, target, 1024, hit_capacity=8, device="cpu")
        count, got, _ = step(gen.digits(0), n_valid)
        assert (int(counts.sum()), int(lanes.max())) == (1, 517)
    want = [0, 517, 518] if multi else [517]
    assert int(count) == len(want)
    assert sorted(x for x in got.tolist() if x >= 0) == want
