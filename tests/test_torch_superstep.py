"""The window offset, the blocked probe and the loop superstep of the
mask kernel against the reference, on the CPU (the kernel's plain
version, what ``--device torch-cpu`` runs):

- the probe's bit layout: targets/probe.bloom_fill and
  kernel_bloom_geometry equal the reference's;
- the plain probe and the offset: ``probe_plain`` and the offset plain
  versions against the reference's ``emulate_mask_kernel(...,
  offset=, probe_fp=)``, run eagerly (never interpret mode): the same
  hit set, and n_maybe the sum of its per-tile probe counts, also on
  a bitmap small enough that most maybes are false;
- windows appended into one set of buffers equal one launch over the
  window;
- the loop superstep of the mask worker, in the reference's scenarios
  (tests/test_a_shard_kernel.py, loop superstep), against the
  reference's CpuWorker oracle.
"""

import hashlib

import numpy as np
import pytest
import torch

from dprf_tpu.engines import get_engine as ref_get_engine
from dprf_tpu.generators.mask import MaskGenerator as RefMaskGenerator
from dprf_tpu.ops.pallas_mask import emulate_mask_kernel
from dprf_tpu.runtime.worker import CpuWorker as RefCpuWorker
from dprf_tpu.runtime.workunit import WorkUnit as RefWorkUnit
from dprf_tpu.targets import probe as ref_probe
from dprf_tpu_torch.engines import get_engine
from dprf_tpu_torch.engines.base import Target
from dprf_tpu_torch.generators.mask import MaskGenerator
from dprf_tpu_torch.ops import cuda_mask, superstep
from dprf_tpu_torch.ops.compare import make_target_table
from dprf_tpu_torch.runtime.worker import CudaMaskWorker
from dprf_tpu_torch.runtime.workunit import WorkUnit
from dprf_tpu_torch.targets import probe

pytestmark = pytest.mark.smoke

SUB = 8
TILE = SUB * 128


def _words(engine: str, plains) -> np.ndarray:
    oracle = get_engine(engine)
    return np.stack([np.frombuffer(d, "<u4").astype(np.uint32)
                     for d in oracle.hash_batch(list(plains))])


@pytest.mark.parametrize("n", [2, 100, 1000, 8192])
def test_probe_bits_match_reference(n):
    rng = np.random.default_rng(n)
    rows = rng.integers(0, 1 << 32, (n, 4), dtype=np.uint64) \
        .astype(np.uint32)
    geo = probe.kernel_bloom_geometry(n, cuda_mask.PROBE_FP,
                                      8 * 128 * probe.BLOCK_BITS)
    assert geo == ref_probe.kernel_bloom_geometry(
        n, cuda_mask.PROBE_FP, 8 * 128 * ref_probe.BLOCK_BITS)
    m_bits, k, _ = geo
    got = probe.bloom_fill(rows, m_bits, k)
    np.testing.assert_array_equal(got, ref_probe.bloom_fill(rows, m_bits, k))
    words, block_bits, kk = cuda_mask.probe_rows(rows)
    assert (kk, 16 << block_bits) == (k, m_bits // 32)
    np.testing.assert_array_equal(words, got)


def _ref_window(engine, gen, tw, batch, base, n_valid, offset, probe_fp):
    """The reference kernel body over one window: its maybe count and
    the window lanes of its one-maybe tiles."""
    ref_gen = RefMaskGenerator(gen.mask)
    counts, lanes = emulate_mask_kernel(engine, ref_gen, tw, batch, base,
                                        n_valid, sub=SUB, offset=offset,
                                        probe_fp=probe_fp)
    counts, lanes = counts[:, 0], lanes[:, 0]
    assert (counts <= 1).all()          # plants in separate tiles
    return int(counts.sum()), sorted(
        offset + t * TILE + int(lanes[t]) for t in np.flatnonzero(counts))


@pytest.mark.parametrize("engine", ["md5", "ntlm"])
def test_probe_plain_matches_reference(engine):
    """1,000 targets (6 planted, each in its own tile: the window's
    first and last valid lanes, two inside it, one before it, one at
    n_valid), a window at offset 3 * TILE: the hit set, each hit's
    target, and n_maybe equal to the reference's summed per-tile probe
    counts."""
    gen = MaskGenerator("?l?l?l?l")
    offset, batch = 3 * TILE, 4 * TILE
    n_valid = offset + batch - 5
    plants = [offset, offset + TILE + 1, offset + 2 * TILE + 9, n_valid - 1,
              17, n_valid]
    rng = np.random.default_rng(7)
    tw = np.concatenate([_words(engine, [gen.candidate(i) for i in plants]),
                         rng.integers(0, 1 << 32, (994, 4), dtype=np.uint64)
                         .astype(np.uint32)])
    ref_maybe, ref_lanes = _ref_window(engine, gen, tw, batch,
                                       gen.digits(0), n_valid, offset,
                                       cuda_mask.PROBE_FP)
    table = make_target_table([r.astype("<u4").tobytes() for r in tw])
    step = cuda_mask.make_shard_mask_compute(engine, gen, table, batch, 16,
                                             device="cpu")
    out = cuda_mask.hit_buffers(True, 16, "cpu")
    count, lanes, tpos, n_maybe = step(gen.digits(0), n_valid,
                                       offset=offset, out=out)
    hits = sorted((int(l), int(table.order[t]))
                  for l, t in zip(lanes.tolist(), tpos.tolist()) if l >= 0)
    want = sorted((p, i) for i, p in enumerate(plants)
                  if offset <= p < n_valid)
    assert hits == want and int(count) == len(want) == 4
    assert [l for l, _ in hits] == ref_lanes
    assert int(n_maybe) == ref_maybe == 4


@pytest.mark.parametrize("engine,n,fp", [("md5", 100, 0.2),
                                         ("sha1", 300, 0.2)])
def test_probe_false_maybes_match_reference(engine, n, fp):
    """A bitmap of one block (100 targets, k 4) or two (300, k 2) at a
    false-positive budget of 0.2, so that most of a window's maybes
    are false: the plain probe's n_maybe equals the reference's summed
    per-tile probe counts at the same geometry, and only the planted
    hits come back."""
    gen = MaskGenerator("?l?l?l?l")
    offset, batch = 2 * TILE, 4 * TILE
    n_valid = offset + batch - 3
    plants = [offset + 5, offset + 3 * TILE + 17]
    order = "<u4" if engine == "md5" else ">u4"
    rng = np.random.default_rng(n)
    digests = get_engine(engine).hash_batch([gen.candidate(i)
                                             for i in plants])
    tw = np.concatenate([
        np.stack([np.frombuffer(d, order) for d in digests]),
        rng.integers(0, 1 << 32, (n - 2, len(digests[0]) // 4),
                     dtype=np.uint64)]).astype(np.uint32)
    ref_gen = RefMaskGenerator(gen.mask)
    counts, _ = emulate_mask_kernel(engine, ref_gen, tw, batch,
                                    gen.digits(0), n_valid, sub=SUB,
                                    offset=offset, probe_fp=fp)
    m_bits, k, _ = probe.kernel_bloom_geometry(
        n, fp, cuda_mask.PROBE_GROUPS * 128 * probe.BLOCK_BITS)
    words = torch.as_tensor(probe.bloom_fill(tw, m_bits, k).view(np.int32))
    block_bits = (m_bits // probe.BLOCK_BITS).bit_length() - 1
    assert (block_bits, k) == ((0, 4) if n == 100 else (1, 2))
    table = make_target_table([r.astype(order).tobytes() for r in tw],
                              engine == "md5")
    count, lanes, tpos, n_maybe = cuda_mask.mask_crack_probe(
        engine, gen.charset_lut("cpu"), gen.radices, gen.digits(0), n_valid,
        words, block_bits, k, table.tensor("cpu"), 8, batch, offset=offset)
    assert int(n_maybe) == int(counts.sum()) > 100 * len(plants)
    assert sorted((int(l), int(table.order[t]))
                  for l, t in zip(lanes.tolist(), tpos.tolist())
                  if l >= 0) == [(p, i) for i, p in enumerate(plants)]
    assert int(count) == len(plants)


@pytest.mark.parametrize("engine", ["md5", "sha1"])
def test_offset_plain_matches_reference(engine):
    """One target at a window offset: the reference body's hit (valid
    iff offset + lane < the window's n_valid) is the plain version's;
    a plant past n_valid is not found."""
    gen = MaskGenerator("?l?l?l")
    offset, batch = TILE, 2 * TILE
    n_valid = TILE + 321
    for idx, found in ((offset + 100, True), (n_valid - 1, True),
                       (n_valid, False)):
        words = np.frombuffer(get_engine(engine).hash_batch(
            [gen.candidate(idx)])[0],
            "<u4" if engine == "md5" else ">u4").astype(np.uint32)
        ref_count, ref_lanes = _ref_window(engine, gen, words, batch,
                                           gen.digits(0), n_valid, offset,
                                           None)
        count, lanes = cuda_mask.mask_crack(
            engine, gen.charset_lut("cpu"), gen.radices, gen.digits(0),
            min(n_valid, offset + batch), [int(w) for w in words], 4, batch,
            offset=offset)
        got = [int(x) for x in lanes.tolist() if x >= 0]
        assert (int(count), got) == (ref_count, ref_lanes)
        assert got == ([idx] if found else [])


def test_window_of_launches_equals_one_launch():
    """Four launches at offsets i * batch into one set of window buffers
    give the count, lanes, positions and n_maybe of one launch over the
    whole window; the sets compare (SETS) and the probe agree."""
    gen = MaskGenerator("?l?l?l?l")
    batch, inner = 1024, 4
    plants = [0, 1023, 1024, 2050, 4000, 4095]
    digests = get_engine("md5").hash_batch([gen.candidate(i)
                                            for i in plants])
    table = make_target_table(digests)
    sets = cuda_mask.make_cuda_multi_crack_step("md5", gen, table,
                                                inner * batch, 8, "cpu")
    whole = sets(gen.digits(0), inner * batch)
    for step in (cuda_mask.make_cuda_multi_crack_step("md5", gen, table,
                                                      batch, 8, "cpu"),
                 cuda_mask.make_shard_mask_compute("md5", gen, table, batch,
                                                   8, device="cpu")):
        got = superstep.loop_super_step(
            step, batch, gen.digits(0), inner * batch,
            cuda_mask.hit_buffers(True, 8, "cpu"))
        assert [t.tolist() for t in got] == [t.tolist() for t in whole]
    assert int(whole[0]) == 6 and whole[1][:6].tolist() == plants


def test_max_inner_and_budget():
    """A window's batches: the int32 lane budget and the cap bound
    them, no power of two asked; its launches clip n_valid to their
    own batch; a launch past the budget is refused."""
    assert superstep.max_inner(1 << 24, 256) == 127
    assert superstep.max_inner(1 << 26, 256) == 31
    assert superstep.max_inner(1024, 256) == 256
    assert superstep.max_inner(1 << 31) == 0
    calls = []
    superstep.loop_super_step(
        lambda b, nv, offset, out: calls.append((nv, offset)), 10, [0],
        35, None)
    assert calls == [(10, 0), (20, 10), (30, 20), (35, 30)]
    gen = MaskGenerator("?l?l?l")
    with pytest.raises(ValueError, match="offset"):
        cuda_mask.mask_crack("md5", gen.charset_lut("cpu"), gen.radices,
                             gen.digits(0), 64, [0] * 4, 4, 64,
                             offset=(1 << 31) - 256)


def _md5_targets(gen, idxs):
    return [Target(str(i), hashlib.md5(gen.candidate(i)).digest())
            for i in idxs]


def _oracle_hits(mask, targets, unit):
    """The reference CpuWorker's hit set over the unit."""
    ref_targets = [ref_get_engine("md5").parse_target(t.digest.hex())
                   for t in targets]
    return sorted((h.target_index, h.cand_index, h.plaintext)
                  for h in RefCpuWorker(ref_get_engine("md5"),
                                        RefMaskGenerator(mask), ref_targets)
                  .process(RefWorkUnit(unit.unit_id, unit.start,
                                       unit.length)))


def _worker(gen, targets, cap=16):
    eng = get_engine("md5", device="cuda", torch_device="cpu")
    return CudaMaskWorker(eng, gen, targets, batch=TILE, hit_capacity=cap,
                          oracle=get_engine("md5"), device="cpu")


@pytest.mark.parametrize("window_batches,spans", [
    (256, [10_000]), (4, [4 * TILE, 4 * TILE, 10_000 - 8 * TILE])])
def test_loop_superstep_single_target_parity(window_batches, spans):
    """The reference's scenario: ?d^4 over a 1,024-lane batch, hits at
    a batch boundary inside a window, a window's last index and the
    keyspace's last index (a partial last batch): the whole unit as one
    window of 10 launches, or as windows of 4 batches."""
    gen = MaskGenerator("?d?d?d?d")
    unit = WorkUnit(0, 0, gen.keyspace)
    for i in (0, TILE, 4 * TILE - 1, 8 * TILE - 1, gen.keyspace - 1):
        targets = _md5_targets(gen, [i])
        w = _worker(gen, targets)
        assert w.window_batches == 256
        w.window_batches = window_batches
        pending = w.submit(unit)
        assert [span for (_, span), _ in pending.queued] == spans
        got = sorted((h.target_index, h.cand_index, h.plaintext)
                     for h in pending.resolve())
        assert got == _oracle_hits("?d?d?d?d", targets, unit)
        assert [h[1] for h in got] == [i]
        assert (w.dispatched, w.windows) == (10, len(spans))


def test_loop_superstep_multi_matches_perbatch():
    """The reference's scenario: five targets, two in one tile, over
    the window and the rest, against the oracle."""
    gen = MaskGenerator("?d?d?d?d")
    plants = [10, 11, TILE + 5, 2 * TILE - 1, gen.keyspace - 1]
    targets = _md5_targets(gen, plants)
    w = _worker(gen, targets)
    unit = WorkUnit(0, 0, gen.keyspace)
    pending = w.submit(unit)
    assert [start for start, _ in pending.queued] == [(0, gen.keyspace)]
    got = sorted((h.target_index, h.cand_index, h.plaintext)
                 for h in pending.resolve())
    assert got == _oracle_hits("?d?d?d?d", targets, unit)
    assert w.n_maybe() == len(plants)


def test_loop_superstep_overflow_redrives_per_batch():
    """Twelve hits in a window whose buffers hold 10 (hit capacity 1 x
    10 batches): the window overflows, its 10 batches run again through
    the device step, and only the batch of eleven hits goes to the
    oracle rescan."""
    gen = MaskGenerator("?d?d?d?d")
    plants = [5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 3000]
    targets = _md5_targets(gen, plants)
    w = _worker(gen, targets, cap=1)
    unit = WorkUnit(0, 0, gen.keyspace)
    got = sorted((h.target_index, h.cand_index, h.plaintext)
                 for h in w.process(unit))
    assert got == _oracle_hits("?d?d?d?d", targets, unit)
    # 10 dispatched, then the 10 batches of the window again
    assert w.dispatched == 20


def test_nested_engines_keep_the_per_batch_path():
    gen = MaskGenerator("?d?d?d?d")
    eng = get_engine("md5(md5)", device="cuda", torch_device="cpu")
    target = eng.parse_target(eng.hash_batch([b"0042"])[0].hex())
    w = eng.make_mask_worker(gen, [target], batch=TILE, hit_capacity=4,
                             oracle=get_engine("md5(md5)"))
    pending = w.submit(WorkUnit(0, 0, gen.keyspace))
    assert w.window_batches == 1 and w.windows == 0
    assert [span for (_, span), _ in pending.queued] == [TILE] * 9 + [784]
    assert [h.cand_index for h in pending.resolve()] == [42]


def test_window_buffers_keep_the_count_past_capacity():
    """Appends past a window's capacity drop their lanes but keep the
    count, the overflow contract the worker's redrive reads; a launch
    refuses buffers that do not fit it."""
    gen = MaskGenerator("?l?l?l")
    lut = gen.charset_lut("cpu")
    plants = [3, 9, 100, 700, 701]
    digests = get_engine("md5").hash_batch([gen.candidate(i)
                                            for i in plants])
    step = cuda_mask.make_cuda_multi_crack_step(
        "md5", gen, make_target_table(digests), 512, 2, "cpu")
    out = cuda_mask.hit_buffers(True, 3, "cpu")
    for offset in (0, 512):
        step(gen.digits(0), offset + 512, offset=offset, out=out)
    assert int(out[0]) == 5 and int(out[3]) == 5
    assert out[1].tolist() == [3, 9, 100]
    assert out[2].tolist() != [-1, -1, -1]
    with pytest.raises(ValueError, match="hit buffers"):
        cuda_mask.mask_crack("md5", lut, gen.radices, gen.digits(0), 64,
                             [0] * 4, 4, 64,
                             out=cuda_mask.hit_buffers(True, 4, "cpu"))
    with pytest.raises(ValueError, match="n_valid"):
        cuda_mask.mask_crack("md5", lut, gen.radices, gen.digits(0), 129,
                             [0] * 4, 4, 64, offset=64)


def test_probe_ops_count_the_probe():
    """The probe's least work: at fill 0 the core up to words 0-1, the
    decode, the block and pair ends and one bit tested; each passing
    bit adds its test, and a full bitmap all k bits and words 2-3."""
    from dprf_tpu_torch.ops import opcount
    w2 = opcount.core_work("md5", 6, 2)
    w4 = opcount.core_work("md5", 6, 4)
    empty = opcount.probe_ops("md5", 6, 0.0, 8)
    assert empty == opcount.Work(w2["alu"] + 6 + 3 + 4, w2["add"] + 6 + 2 + 1,
                                 w2["fma"] + 12 + 1)
    full = opcount.probe_ops("md5", 6, 1.0, 8)
    assert full == opcount.Work(w4["alu"] + 6 + 3 + 32, w4["add"] + 6 + 4 + 2,
                                w4["fma"] + 12 + 1 + 6)
    assert opcount.probe_fill(np.array([0xFF, 0, 0, 0], np.uint32)) == 0.0625
    assert opcount.probe_ops("md5", 6, 0.1, 8, maybes=1.0, n_targets=1000) \
        .alu == pytest.approx(opcount.probe_ops("md5", 6, 0.1, 8).alu
                              + 4 * 10 + 4)
