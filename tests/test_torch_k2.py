"""The host side of slice K2's redesigned kernels, on the CPU: the mask
kernel's runs of lanes (ops/cuda_mask.run_count / run_lanes /
run_grid, the partition csrc/mask_kernel.cuh walks) and the decode they
step, against the reference's mask decode; the bcrypt kernels' shared
memory layout (ops/cuda_bcrypt.shared_word, csrc/bcrypt.cu's word_of)
and wave; and the mask workers' hit sets on the CPU against the
reference's.

The kernels themselves run only on a card (tests/test_torch_cuda.py,
chip_smoke.py); here their host mirrors run, and the workers on CPU
tensors run the kernels' plain version.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dprf_tpu.engines import get_engine as ref_get_engine
from dprf_tpu.generators.mask import MaskGenerator as RefMaskGenerator
from dprf_tpu.runtime.worker import CpuWorker as RefCpuWorker
from dprf_tpu.runtime.workunit import WorkUnit as RefWorkUnit
from dprf_tpu_torch.engines import get_engine
from dprf_tpu_torch.generators.mask import MaskGenerator
from dprf_tpu_torch.ops import cuda_bcrypt, cuda_mask
from dprf_tpu_torch.runtime.workunit import WorkUnit

pytestmark = pytest.mark.smoke

#: last-position radices: 1, both sides of a run's length and of two
#: runs', ?l, ?a, ?b
LAST_RADICES = (1, 2, 26, 31, 32, 33, 63, 64, 65, 95, 96, 200, 255, 256)


def _partition(radix, base, offset, n_valid, threads):
    """Each thread's runs (the kernel's grid-stride loop over runs):
    {thread: [(lo, hi, carry), ...]}."""
    n_runs = cuda_mask.run_count(radix, base, offset, n_valid)
    return {t: [cuda_mask.run_lanes(radix, base, offset, n_valid, g)
                for g in range(t, n_runs, threads)]
            for t in range(threads)}


@pytest.mark.parametrize("radix", LAST_RADICES)
def test_runs_cover_every_window_lane_once(radix):
    """Over offsets and valid lanes that cut runs mid-way, and grids of
    1, 7 and 96 threads: every lane of [offset, n_valid) in exactly one
    run, a run at most RUN lanes inside one period of the last
    position, and its carry that period's."""
    rng = np.random.default_rng(radix)
    cases = [(0, 0, 0), (radix - 1, 0, 1), (0, 5, 3 * radix + 1)]
    for _ in range(6):
        base = int(rng.integers(0, radix))
        offset = int(rng.integers(0, 4 * radix + 40))
        cases.append((base, offset,
                      offset + int(rng.integers(0, 6 * radix + 70))))
    for base, offset, n_valid in cases:
        for threads in (1, 7, 96):
            seen = []
            for runs in _partition(radix, base, offset, n_valid,
                                   threads).values():
                for lo, hi, carry in runs:
                    assert hi - lo <= cuda_mask.RUN
                    assert all((base + x) // radix == carry
                               for x in range(lo, hi))
                    seen.extend(range(lo, hi))
            assert sorted(seen) == list(range(offset, max(offset, n_valid)))


def test_run_shape_and_mean_run():
    """A period is cut into ceil(r / RUN) runs of ceil(r / chunks)
    lanes, none empty: ?a's 95 into 32, 32, 31."""
    for r in range(1, 257):
        chunks, run = cuda_mask.run_shape(r)
        assert run <= cuda_mask.RUN and (chunks - 1) * run < r <= chunks * run
    assert cuda_mask.run_shape(95) == (3, 32)
    assert cuda_mask.mean_run(95) == pytest.approx(95 / 3)
    assert cuda_mask.mean_run(26) == 26


def _stepped(charsets, base_digits, offset, n_valid, threads):
    """The kernel's candidates by lane: per run, positions L - 2 .. 0
    decoded from the run's carry by reciprocals (DPRF_DECODE_RCP,
    umulhi(2 s, rcp) >> sh), then position L - 1 stepped a lane."""
    radices = [len(c) for c in charsets]
    rcp, rsh = cuda_mask.decode_reciprocals(radices)
    r, b = radices[-1], base_digits[-1]
    out = {}
    for runs in _partition(r, b, offset, n_valid, threads).values():
        for lo, hi, carry in runs:
            digits = [0] * (len(radices) - 1)
            for q in range(len(radices) - 2, -1, -1):
                s = base_digits[q] + carry
                assert s < 1 << 31
                carry = ((2 * s) * rcp[q] >> 32) >> rsh[q]
                digits[q] = s - carry * radices[q]
            prefix = bytes(charsets[q][d] for q, d in enumerate(digits))
            j = (b + lo) // r
            for lane in range(lo, hi):
                out.setdefault(lane, []).append(
                    prefix + bytes([charsets[-1][b + lane - j * r]]))
    return out


def _mask(rng, length, last):
    """A mask of ``length`` positions over custom charsets of random
    radices 1..256 (and ?b, ?a, a literal), its last position of radix
    ``last``."""
    custom = {i: bytes(rng.permutation(256)[:int(rng.integers(1, 257))]
                       .astype(np.uint8)) for i in (1, 2, 3)}
    custom[4] = bytes(rng.permutation(256)[:last].astype(np.uint8))
    pool = ["?1", "?2", "?3", "?b", "?a", "x"]
    return "".join(pool[int(rng.integers(0, len(pool)))]
                   for _ in range(length - 1)) + "?4", custom


@pytest.mark.parametrize("length", (1, 7, 55))
def test_stepped_decode_matches_reference_decode(length):
    """The runs' stepped decode, the plain version's decode (decode_lut,
    DPRF_DECODE's mirror) and the reference's MaskGenerator.candidate
    give the same bytes for every lane: last radices 1..256, window
    offsets and valid lanes that cut runs, bases whose digits sit at the
    top of their radices so carries cross runs into positions L - 2,
    L - 3, and a window that runs past the keyspace's end (the decode
    drops the last carry: it wraps)."""
    rng = np.random.default_rng(length)
    for last in LAST_RADICES:
        mask, custom = _mask(rng, length, last)
        gen, ref = MaskGenerator(mask, custom), RefMaskGenerator(mask, custom)
        assert list(gen.radices) == [len(c) for c in ref.charsets]
        top = [r - 1 for r in gen.radices]
        top[-1] = int(rng.integers(0, last))
        starts = [int.from_bytes(rng.bytes(48), "little") % gen.keyspace,
                  ref.index_of(bytes(ref.charsets[q][d]
                                     for q, d in enumerate(top))),
                  gen.keyspace - last - 1 if gen.keyspace > last else 0]
        lut = gen.charset_lut()
        for start in starts:
            offset = int(rng.integers(0, 2 * last + 3))
            n_valid = offset + int(rng.integers(1, 3 * last + 80))
            got = _stepped(ref.charsets, gen.digits(start), offset, n_valid,
                           threads=5)
            plain = gen.decode_batch(gen.digits(start), lut, n_valid)
            for lane in range(offset, n_valid):
                want = ref.candidate((start + lane) % gen.keyspace)
                assert got[lane] == [want], (mask, start, lane)
                assert bytes(plain[lane].tolist()) == want


def test_opcount_counts_the_decode_once_a_run():
    """ops/opcount: a run of 1 is the full decode a lane (the pinned
    counts of tests/test_torch_opcount.py); at runs of R lanes the full
    decode counts once a run and DECODE_STEP each other lane, for the
    mask, nested and probe counts alike."""
    from dprf_tpu_torch.ops import opcount
    from dprf_tpu_torch.ops.opcount import Work
    assert opcount.decode_work(7) == Work(7, 7, 14)
    run = cuda_mask.mean_run(95)
    dec = opcount.decode_work(7, run)
    assert dec == Work(7 / run + (1 - 1 / run), 7 / run + (1 - 1 / run),
                       14 / run)
    full, stepped = opcount.decode_work(7), dec
    for one, many in ((opcount.ops_per_candidate("ntlm", 7),
                       opcount.ops_per_candidate("ntlm", 7, run=run)),
                      (opcount.nested_ops("md5(md5)", 7, True, 1.3, 0, 1000),
                       opcount.nested_ops("md5(md5)", 7, True, 1.3, 0, 1000,
                                          run=run)),
                      (opcount.probe_ops("md5", 7, 0.1, 8),
                       opcount.probe_ops("md5", 7, 0.1, 8, run=run))):
        for pipe in ("alu", "add", "fma"):
            assert getattr(one, pipe) - getattr(many, pipe) == \
                pytest.approx(getattr(full, pipe) - getattr(stepped, pipe))
    assert opcount.ops_per_candidate("md5", 6) == Work(128, 73, 12)


def test_run_grid_gives_every_thread_the_same_runs(monkeypatch):
    """The grid: one resident wave's threads or fewer, each taking
    ceil(n_runs / wave) runs at most, so the last pass is full: ?a^7 at
    2^24 lanes is 529,809 runs, 3 passes of 176,603 threads at 6 blocks
    of 256 on 132 SMs."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: SimpleNamespace(
                            multi_processor_count=132))
    wave = 132 * 6 * cuda_mask.THREADS
    for n_runs in (1, 255, 257, wave - 1, wave, wave + 1, 529809, 5 * wave):
        grid = cuda_mask.run_grid(6, n_runs, "cuda")
        threads = grid * cuda_mask.THREADS
        passes = -(-n_runs // wave)
        assert grid <= 132 * 6 and threads >= -(-n_runs // passes)
        assert -(-n_runs // threads) == passes
        assert threads - cuda_mask.THREADS < -(-n_runs // passes)
    assert cuda_mask.run_count(95, 0, 0, 1 << 24) == 529809
    assert cuda_mask.run_grid(6, 529809, "cuda") * cuda_mask.THREADS \
        == 176640


def test_byte_mask_is_the_last_positions_byte():
    """The kernel's sel words: 0xff where the engine's packing puts the
    last position's byte (UTF-16LE for ntlm, big-endian words for SHA,
    the inner core's order for a nested chain), zero elsewhere."""
    assert cuda_mask.byte_mask("md5", 6)[:2] == (0, 0xFF00)
    assert cuda_mask.byte_mask("ntlm", 7)[3] == 0xFF
    assert cuda_mask.byte_mask("sha1", 7)[1] == 0xFF00
    assert cuda_mask.byte_mask("sha512", 9)[2] == 0xFF000000
    assert cuda_mask.byte_mask("md5(md5)", 7)[1] == 0xFF0000
    for name, length in (("md5", 55), ("ntlm", 27), ("sha256", 1),
                         ("sha3-256", 135), ("keccak-512", 71),
                         ("sha384", 111), ("mysql41", 20)):
        words = cuda_mask.byte_mask(name, length)
        assert sorted(bin(w).count("1") for w in words if w) == [8]


def test_bcrypt_layout_is_conflict_free_and_fits():
    """csrc/bcrypt.cu's block: 56 candidates in 224 KB, every (candidate,
    entry) its own word; within each warp the banks a lane can read are
    its own, so the warp's data-dependent reads of any entries never
    conflict.  A warp of 14 candidates at stride 14 (the other design
    timed) shares banks between lanes."""
    assert cuda_bcrypt.BLOCK == sum(cuda_bcrypt.WARPS) == 56
    words = {cuda_bcrypt.shared_word(t, e)
             for t in range(cuda_bcrypt.BLOCK) for e in range(1024)}
    assert words == set(range(56 * 1024))
    assert 56 * 1024 * 4 <= 227 * 1024       # a block's opt-in limit
    first = 0
    for n in cuda_bcrypt.WARPS:
        banks = [{cuda_bcrypt.shared_word(first + lane, e) % 32
                  for e in range(1024)} for lane in range(n)]
        assert all(not (banks[a] & banks[b]) for a in range(n)
                   for b in range(a))
        first += n
    banks14 = [{(e * 14 + lane) % 32 for e in range(1024)}
               for lane in range(14)]
    assert banks14[0] & banks14[2]


def test_resident_batch_follows_the_occupancy(monkeypatch):
    """A wave is SMs x the fewest resident blocks of the three kernels x
    BLOCK: 7,392 at one block an SM on 132 SMs."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: SimpleNamespace(
                            multi_processor_count=132))
    for blocks, want in ({"bcrypt_setup": 1, "bcrypt_advance": 1,
                          "bcrypt_finish": 1}, 7392), \
            ({"bcrypt_setup": 2, "bcrypt_advance": 1,
              "bcrypt_finish": 3}, 7392), \
            ({"bcrypt_setup": 2, "bcrypt_advance": 2,
              "bcrypt_finish": 2}, 14784):
        monkeypatch.setattr(cuda_bcrypt, "occupancy",
                            lambda index, kernel, b=blocks:
                            (b[kernel], 229376))
        assert cuda_bcrypt.resident_batch("cuda:0") == want


@pytest.mark.parametrize("name", ("md5", "ntlm", "md5(md5)"))
def test_torch_cpu_worker_finds_the_reference_hit_set(name):
    """The mask worker on CPU tensors (the kernels' plain version) over
    ?l?d?l: the reference CPU worker's hits on one target and on a
    list of 40 with plants at the first and last index and two in one
    batch, hit capacity 8 and 0 (the oracle rescan)."""
    mask = "?l?d?l"
    gen, ref_gen = MaskGenerator(mask), RefMaskGenerator(mask)
    rng = np.random.default_rng(sum(name.encode()))
    oracle, ref_oracle = get_engine(name), ref_get_engine(name)
    plants = [0, 1000, 1001, gen.keyspace - 1]
    digests = oracle.hash_batch([gen.candidate(p) for p in plants]) + \
        oracle.hash_batch([bytes(rng.integers(33, 127, 8, dtype=np.uint8))
                           for _ in range(36)])
    dev = get_engine(name, "cuda", torch_device="cpu")
    for lines in ([digests[3].hex()], [d.hex() for d in digests]):
        targets = [oracle.parse_target(ln) for ln in lines]
        want = sorted((h.target_index, h.cand_index, h.plaintext) for h in
                      RefCpuWorker(ref_oracle, ref_gen,
                                   [ref_oracle.parse_target(ln)
                                    for ln in lines]).process(
                          RefWorkUnit(0, 0, gen.keyspace)))
        assert len(want) == (len(plants) if len(lines) > 1 else 1)
        for cap in (8, 0):
            w = dev.make_mask_worker(gen, targets, batch=4096,
                                     hit_capacity=cap, oracle=oracle)
            got = sorted((h.target_index, h.cand_index, h.plaintext)
                         for h in w.process(WorkUnit(0, 0, gen.keyspace)))
            assert got == want
