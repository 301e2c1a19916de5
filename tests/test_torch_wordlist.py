"""The port's wordlist generator, varlen packer and rule-kernel worker
(``CudaWordlistWorker`` on CPU tensors, running the kernel's plain
version) against the reference's on the same words, rules and planted
targets.  Exact equality throughout."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dprf_tpu.engines import get_engine as ref_get_engine
from dprf_tpu.engines.base import Target as RefTarget
from dprf_tpu.generators import wordlist as ref_wordlist
from dprf_tpu.ops import pack as ref_pack
from dprf_tpu.rules.parser import load_rules as ref_load_rules
from dprf_tpu.runtime.worker import CpuWorker as RefCpuWorker
from dprf_tpu.runtime.workunit import WorkUnit as RefWorkUnit
from dprf_tpu_torch.engines import get_engine
from dprf_tpu_torch.engines.base import Target
from dprf_tpu_torch.generators import wordlist
from dprf_tpu_torch.ops import cuda_rules
from dprf_tpu_torch.ops.pack import pack_varlen
from dprf_tpu_torch.rules import load_rules
from dprf_tpu_torch.runtime import worker as port_worker
from dprf_tpu_torch.runtime.worker import CudaWordlistWorker
from dprf_tpu_torch.runtime.workunit import WorkUnit

ENGINES = ["md5", "ntlm", "sha1", "sha256"]
#: words per step of the workers here: batch // 64 rules
BATCH = 32 * 64
#: best64's "'7" and "]": both give the first 7 bytes of an 8-byte word
TRUNC7, DEL_LAST = 46, 52


def _words():
    rng = np.random.default_rng(11)
    words = [bytes(rng.integers(33, 127, int(n), dtype=np.uint8))
             for n in rng.integers(1, 14, 69)]
    words[40] = b"abcdefgh"
    return words + [b"Zz9"]           # 70 words: windows of 32, 32, 6


@pytest.fixture(scope="module")
def gens():
    words = _words()
    port = {ml: wordlist.WordlistRulesGenerator(words, load_rules("best64"),
                                                max_len=ml)
            for ml in (27, 55)}
    ref = {ml: ref_wordlist.WordlistRulesGenerator(
        words, ref_load_rules("best64"), max_len=ml) for ml in (27, 55)}
    return port, ref


def test_generator_matches_reference(gens):
    port, ref = gens
    for ml in (27, 55):
        p, r = port[ml], ref[ml]
        assert (p.n_words, p.n_rules, p.keyspace) == \
            (r.n_words, r.n_rules, r.keyspace) == (70, 64, 70 * 64)
        assert p.candidates(0, p.keyspace) == r.candidates(0, r.keyspace)
        assert p.content_id() == r.content_id()
        assert p.word(69) == r.word(69) == b"Zz9"
        assert p.index_of(3, 5) == r.index_of(3, 5) == 3 * 64 + 5
        buf, lens = p.packed_words()
        rbuf, rlens = r.packed_words()
        assert np.array_equal(buf, rbuf) and np.array_equal(lens, rlens)
    assert p.candidate(40 * 64 + DEL_LAST) == \
        p.candidate(40 * 64 + TRUNC7) == b"abcdefg"
    with pytest.raises(IndexError):
        p.candidate(p.keyspace)


def test_load_words_matches_reference(tmp_path):
    path = tmp_path / "w.txt"
    path.write_bytes(b"alpha\r\nbeta\r\r\n\n\r\n  sp ace \nx" + b"y" * 20
                     + b"\ngamma\rdelta\nlast")
    for ml in (5, 8, 55):
        assert wordlist.load_words(str(path), ml) == \
            ref_wordlist.load_words(str(path), ml)
    assert wordlist.load_words(str(path), 8) == (
        [b"alpha", b"beta", b"last"], 3)
    gen = wordlist.WordlistRulesGenerator.from_files(str(path), "best64", 8)
    ref = ref_wordlist.WordlistRulesGenerator.from_files(str(path),
                                                         "best64", 8)
    assert (gen.n_words, gen.n_skipped_long, gen.keyspace) == \
        (ref.n_words, ref.n_skipped_long, ref.keyspace) == (3, 3, 192)
    path.write_bytes(b"\r\n\n")
    with pytest.raises(ValueError, match="no usable words"):
        wordlist.load_words(str(path), 8)


@pytest.mark.parametrize("widen", [False, True])
@pytest.mark.parametrize("big_endian", [False, True])
def test_pack_varlen_matches_reference(widen, big_endian):
    rng = np.random.default_rng(3)
    L = 27 if widen else 55
    cand = rng.integers(0, 256, (64, L), dtype=np.uint8)
    lens = rng.integers(0, L + 1, 64).astype(np.int32)
    lens[:2] = (0, L)
    got = pack_varlen(torch.as_tensor(cand), torch.as_tensor(lens),
                      big_endian, widen).numpy().view(np.uint32)
    masked = np.where(np.arange(L) < lens[:, None], cand, 0).astype(np.uint8)
    if widen:
        want = ref_pack.pack_varlen(
            ref_pack.utf16le_widen(jnp.asarray(masked)),
            jnp.asarray(2 * lens), big_endian)
    else:
        want = ref_pack.pack_varlen(jnp.asarray(masked), jnp.asarray(lens),
                                    big_endian)
    assert np.array_equal(got, np.asarray(want))


def _hits(hits):
    return sorted((h.target_index, h.cand_index, h.plaintext) for h in hits)


def _run(engine, gens, plant, start, length, hit_capacity=64):
    """The port's worker and the reference's oracle worker over one
    unit, with the candidate at keyspace index ``plant`` as target."""
    port, ref = gens
    ml = 27 if engine == "ntlm" else 55
    gen, rgen = port[ml], ref[ml]
    digest = get_engine(engine).hash_batch([gen.candidate(plant)])[0]
    w = CudaWordlistWorker(get_engine(engine, "cuda", torch_device="cpu"),
                           gen, [Target(digest.hex(), digest)], batch=BATCH,
                           hit_capacity=hit_capacity,
                           oracle=get_engine(engine), device="cpu")
    assert w.word_batch == 32
    got = _hits(w.process(WorkUnit(0, start, length)))
    want = _hits(RefCpuWorker(ref_get_engine(engine), rgen,
                              [RefTarget(digest.hex(), digest)])
                 .process(RefWorkUnit(0, start, length)))
    assert got == want
    return got, w


@pytest.mark.parametrize("engine", ENGINES)
def test_worker_matches_reference(engine, gens):
    """Hits equal the oracle's (a planted candidate may also come out
    of other rules of its word: each such index is a hit too)."""
    ks = 70 * 64
    # first word under the first rule; last word under the last rule
    got, w = _run(engine, gens, 0, 0, 64)
    assert got[0][1] == 0 and w.dispatched == 1
    got, _ = _run(engine, gens, ks - 1, ks - 64, 64)
    assert got[-1][1] == ks - 1
    # "'7" and "]" give one candidate twice: both indices come back
    got, w = _run(engine, gens, 40 * 64 + DEL_LAST, 0, ks)
    assert [h[1] for h in got] == [40 * 64 + TRUNC7, 40 * 64 + DEL_LAST]
    assert w.dispatched == 3
    # a unit that starts and ends inside words: a hit at its first
    # index is kept, one just before it (in the same word) is dropped
    start, length = 5 * 64 + 17, 40 * 64 + 3
    got, _ = _run(engine, gens, start, start, length)
    assert got[0][1] == start
    got, _ = _run(engine, gens, start - 1, start, length)
    assert all(h[1] >= start for h in got)


@pytest.mark.parametrize("engine", ["md5", "sha256"])
def test_hit_overflow_rescans_exactly(engine, gens, monkeypatch):
    """Two hits past a capacity of 1: the word window is relaunched on
    the device with a buffer of its count and returns the oracle's hits
    with no rescan; a relaunch that cannot hold them either (its
    capacity forced to 1) sends the window to the exact oracle rescan,
    which returns the same hits."""
    rescans = []
    real = port_worker.WordlistWorkerBase._rescan_words

    def spy(self, ws, nw, unit):
        rescans.append((ws, nw))
        return real(self, ws, nw, unit)

    monkeypatch.setattr(port_worker.WordlistWorkerBase, "_rescan_words", spy)
    want = [40 * 64 + TRUNC7, 40 * 64 + DEL_LAST]
    got, w = _run(engine, gens, 40 * 64 + DEL_LAST, 32 * 64, 38 * 64,
                  hit_capacity=1)
    assert [h[1] for h in got] == want
    assert rescans == [] and (w.relaunches, w.rescans) == (1, 0)
    make = cuda_rules.make_cuda_rules_crack_step

    def capped(*args, **kwargs):
        step = make(*args, **kwargs)

        def one(ws, n, cap=None):
            return step(ws, n, cap=None if cap is None else 1)

        one.word_batch = step.word_batch
        return one

    monkeypatch.setattr(cuda_rules, "make_cuda_rules_crack_step", capped)
    got, w = _run(engine, gens, 40 * 64 + DEL_LAST, 32 * 64, 38 * 64,
                  hit_capacity=1)
    assert [h[1] for h in got] == want
    assert rescans == [(32, 32)] and (w.relaunches, w.rescans) == (1, 1)


def test_worker_refuses_a_target_list(gens, monkeypatch):
    """The worker takes a list (the probe and the verify of the rules
    kernel's plain version): two targets both hit.  It refuses a bulk
    list whose probe table degrades to the host-verify layout (the byte
    budget forced small) when there is no oracle to confirm its
    survivors."""
    from dprf_tpu_torch.ops.cuda_mask import N_BULK
    from dprf_tpu_torch.targets import probe
    port, _ = gens
    gen = port[55]
    plants = [gen.candidate(3), gen.candidate(64 * 7 + 5)]
    targets = [Target(d.hex(), d)
               for d in get_engine("md5").hash_batch(plants)]
    w = CudaWordlistWorker(get_engine("md5", "cuda", torch_device="cpu"),
                           gen, targets, batch=BATCH, device="cpu")
    got = w.process(WorkUnit(0, 0, 64 * 8))
    assert {(h.target_index, h.plaintext) for h in got} >= \
        {(0, plants[0]), (1, plants[1])}
    many = targets + [Target(f"{i:032x}", i.to_bytes(16, "big"))
                      for i in range(N_BULK)]
    monkeypatch.setattr(probe, "byte_budget", lambda device=None: 9000)
    with pytest.raises(ValueError, match="host-verify layout needs"):
        CudaWordlistWorker(get_engine("md5", "cuda", torch_device="cpu"),
                           gen, many, batch=BATCH, device="cpu")
