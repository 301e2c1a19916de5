"""The nested chains outer(hex(inner(p))) and mysql41 in the port
(engines/device/nested.py, ops/cuda_ext.py) against the reference
(engines/device/nested.py's XLA engines, pallas_ext.emulate_ext_kernel,
the CPU oracles), on the same inputs made from numpy seeds.  Exact
equality throughout: these are integers.

On the CPU the steps run the kernel's plain PyTorch version, because
their tensors lie on the CPU (what ``--device torch-cpu`` runs);
tests/test_torch_cuda.py holds the CUDA kernel against it on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dprf_tpu.cli import main as ref_main
from dprf_tpu.engines import get_engine as ref_get_engine
from dprf_tpu.generators.mask import MaskGenerator as RefMaskGenerator
from dprf_tpu.ops import pallas_ext
from dprf_tpu_torch.cli import main as port_main
from dprf_tpu_torch.engines import get_engine
from dprf_tpu_torch.engines.base import Target
from dprf_tpu_torch.engines.device.nested import words_to_hex_bytes
from dprf_tpu_torch.generators.mask import MaskGenerator
from dprf_tpu_torch.generators.wordlist import WordlistRulesGenerator
from dprf_tpu_torch.ops import cuda_ext
from dprf_tpu_torch.ops.compare import digest_rows, make_target_table
from dprf_tpu_torch.rules.parser import parse_rule
from dprf_tpu_torch.runtime.workunit import WorkUnit

pytestmark = pytest.mark.smoke

NAMES = list(cuda_ext.NESTED_NAMES)
MASK = "?l?d?l"
#: the emulator's tile (sub=8): one grid cell of 1024 lanes
SUB = 8
TILE = SUB * 128


def _rng(name: str):
    return np.random.default_rng(sum(name.encode()))


def _cands(rng, length: int, n: int) -> list:
    return [bytes(rng.integers(32, 127, length, dtype=np.uint8))
            for _ in range(n)]


def _target_words(name: str, digests: list) -> np.ndarray:
    """The digests as the final digest's uint32 words (rows)."""
    eng = get_engine(name, "cuda", torch_device="cpu")
    return digest_rows(digests, eng.little_endian)


@pytest.mark.parametrize("name", NAMES)
def test_digests_match_reference_engine_and_oracle(name):
    """digest_packed over candidates of 1, 4 and 55 bytes: the port's
    engine (through hash_batch), the reference's XLA engine and the CPU
    oracle agree."""
    rng = _rng(name)
    cands = [c for n in (1, 4, 55) for c in _cands(rng, n, 2)]
    want = get_engine(name).hash_batch(cands)
    port = get_engine(name, "cuda", torch_device="cpu")
    assert port.hash_batch(cands) == want
    ref = ref_get_engine(name, "jax")
    buf = np.zeros((len(cands), 55), np.uint8)
    lens = np.array([len(c) for c in cands], np.int32)
    for i, c in enumerate(cands):
        buf[i, :len(c)] = np.frombuffer(c, np.uint8)
    words = np.asarray(ref.digest_packed(ref.pack_varlen(jnp.asarray(buf),
                                                         jnp.asarray(lens))))
    assert digest_rows(want, ref.little_endian).tolist() == words.tolist()
    # the port's engine, fed its own packing at each length
    for n in (1, 4, 55):
        batch = torch.as_tensor(buf[lens == n, :n])
        got = port.digest_packed(port.pack(batch, n)).numpy()
        assert got.view(np.uint32).tolist() == words[lens == n].tolist()


def test_hex_bytes_match_hexdigest():
    rng = np.random.default_rng(3)
    words = rng.integers(0, 2 ** 32, (4, 5), dtype=np.uint64).astype(np.uint32)
    for little in (True, False):
        got = words_to_hex_bytes(torch.as_tensor(words.view(np.int32)),
                                 little).numpy()
        want = [row.astype("<u4" if little else ">u4").tobytes().hex()
                for row in words]
        assert [bytes(r).decode() for r in got] == want


def _ref_tiles(name, gen_ref, target_words, start, n_valid, gen, tiles=1):
    """The reference kernel's body, eagerly, over ``tiles`` cells from
    ``start``: its per-cell (count, hit lane) turned into (total, lanes
    of cells with a hit)."""
    counts, lanes = pallas_ext.emulate_ext_kernel(
        name, gen_ref, target_words, tiles * TILE, gen.digits(start),
        n_valid, sub=SUB)
    counts, lanes = counts.ravel(), lanes.ravel()
    return (int(counts.sum()),
            [t * TILE + int(l) for t, l in enumerate(lanes) if counts[t]])


def _hits(count, lanes):
    return int(count.reshape(-1)[0]), sorted(int(x) for x in lanes.tolist()
                                             if x >= 0)


@pytest.mark.parametrize("name", NAMES)
def test_single_target_step_matches_emulated_kernel(name):
    """One target: a plant at lane 0, at the last valid lane of a
    partial batch, and just past it (no hit)."""
    gen, gen_ref = MaskGenerator(MASK), RefMaskGenerator(MASK)
    start = int(_rng(name).integers(0, gen.keyspace // TILE - 1)) * TILE
    oracle = get_engine(name)
    for plant, n_valid in ((0, TILE), (TILE - 25, TILE - 24),
                           (TILE - 24, TILE - 24)):
        tw = _target_words(name, oracle.hash_batch(
            [gen.candidate(start + plant)]))[0]
        step = cuda_ext.make_cuda_mask_crack_step(name, gen, tw, TILE, 8,
                                                  device="cpu")
        want = _ref_tiles(name, gen_ref, tw, start, n_valid, gen)
        assert want == ((1, [plant]) if plant < n_valid else (0, []))
        assert _hits(*step(gen.digits(start), n_valid)[:2]) == want


@pytest.mark.parametrize("name", ["md5(md5)", "sha256(sha1)"])
def test_bloom_step_matches_emulated_kernel(name):
    """~50 targets (the Bloom compare): the planted set comes back with
    its target indices, and the port's prefilter survivors equal the
    reference body's, over two cells of which the second is partial."""
    gen, gen_ref = MaskGenerator(MASK), RefMaskGenerator(MASK)
    rng = _rng(name)
    start = int(rng.integers(0, gen.keyspace // TILE - 2)) * TILE
    n_valid = 2 * TILE - 100
    plants = [0, 77, 78, TILE + 5, n_valid - 1, n_valid]
    oracle = get_engine(name)
    digests = oracle.hash_batch([gen.candidate(start + p) for p in plants])
    digests += oracle.hash_batch(_cands(rng, 8, 44))
    order = rng.permutation(len(digests))
    digests = [digests[i] for i in order]
    table = make_target_table(
        digests, get_engine(name, "cuda", torch_device="cpu").little_endian)
    step = cuda_ext.make_cuda_multi_crack_step(name, gen, table, 2 * TILE,
                                               16, device="cpu")
    count, lanes, tpos, n_maybe = step(gen.digits(start), n_valid)
    got = sorted((int(l), int(table.order[t])) for l, t in
                 zip(lanes.tolist(), tpos.tolist()) if l >= 0)
    inv = {int(i): j for j, i in enumerate(order)}
    assert got == sorted((p, inv[k]) for k, p in enumerate(plants)
                         if p < n_valid)
    assert int(count) == len(got)
    counts, hit_lanes = pallas_ext.emulate_ext_kernel(
        name, gen_ref, table.original_words(), 2 * TILE, gen.digits(start),
        n_valid, sub=SUB)
    assert int(n_maybe) == int(counts.sum()) >= len(got)
    # the reference's highest surviving lane of each cell is a hit here
    # or a false maybe; cell 1's is the last valid lane, planted
    assert int(hit_lanes.ravel()[1]) == n_valid - 1 - TILE


@pytest.mark.parametrize("name", ["md5(md5)", "mysql41"])
def test_worker_matches_cpu_worker(name):
    """The mask worker on CPU tensors (the nested chain's steps): the
    same hits as the reference's CPU worker over the same unit, one
    target and a list; a hit capacity of 0 recovers its hits by the
    oracle rescan."""
    from dprf_tpu.engines import get_engine as rge
    from dprf_tpu.runtime.worker import CpuWorker as RefCpuWorker
    from dprf_tpu.runtime.workunit import WorkUnit as RefWorkUnit
    gen, gen_ref = MaskGenerator(MASK), RefMaskGenerator(MASK)
    oracle = get_engine(name)
    plants = [3, gen.keyspace - 1]
    digests = oracle.hash_batch([gen.candidate(p) for p in plants]
                                + [b"not-in-the-mask"])
    raw = lambda d: "*" + d.hex().upper() if name == "mysql41" else d.hex()
    targets = [oracle.parse_target(raw(d)) for d in digests]
    ref_o = rge(name)
    ref_t = [ref_o.parse_target(raw(d)) for d in digests]
    unit = (0, gen.keyspace)
    want = sorted((h.target_index, h.cand_index, h.plaintext) for h in
                  RefCpuWorker(ref_o, gen_ref, ref_t).process(
                      RefWorkUnit(0, *unit)))
    assert want == [(0, 3, gen.candidate(3)),
                    (1, gen.keyspace - 1, gen.candidate(gen.keyspace - 1))]
    dev = get_engine(name, "cuda", torch_device="cpu")
    for tgts, cap in ((targets, 8), (targets, 0), (targets[1:2], 8)):
        w = dev.make_mask_worker(gen, tgts, batch=2048, hit_capacity=cap,
                                 oracle=oracle)
        hits = sorted((h.target_index, h.cand_index, h.plaintext) for h in
                      w.process(WorkUnit(0, *unit)))
        if len(tgts) == 1:
            assert hits == [(0, *want[1][1:])]
        else:
            assert hits == want


def test_eligibility_and_refusals():
    """The port's nested eligibility and final digest layouts are the
    reference's, except that it takes sha256 stages off a TPU; 8,193
    targets and a 56-position mask are refused naming --device cpu; a
    wordlist job runs (the rules kernel's plain version on CPU tensors)
    and finds its plant."""
    gen = MaskGenerator(MASK)
    ref = RefMaskGenerator(MASK)
    for name in NAMES + ["md5", "sha1-ps"]:
        for n in (0, 1, 8192, 8193):
            want = pallas_ext.nested_eligible(name, ref, n)
            if "sha256" in name and name in cuda_ext.NESTED_NAMES:
                want = 1 <= n <= 8192       # the stated difference
            assert cuda_ext.nested_eligible(name, gen, n) == want
    for name in NAMES:
        assert cuda_ext.variant_words(name) == pallas_ext.variant_words(name)
    for variant in cuda_ext.SALTED_NAMES:
        assert cuda_ext.variant_words(variant) == \
            pallas_ext.variant_words(cuda_ext.split_salted(variant)[0])
    long_gen = MaskGenerator("?d" * 56)
    assert not cuda_ext.nested_eligible("md5(md5)", long_gen, 1)
    assert not pallas_ext.nested_eligible("md5(md5)",
                                          RefMaskGenerator("?d" * 56), 1)
    dev = get_engine("md5(md5)", "cuda", torch_device="cpu")
    one = [Target("x", b"\0" * 16)]
    for gen_, targets in ((gen, one * 8193), (long_gen, one)):
        with pytest.raises(ValueError, match="--device cpu"):
            dev.make_mask_worker(gen_, targets, 1024, 8)
    words = WordlistRulesGenerator([b"alpha", b"bravo", b"echo"],
                                   [parse_rule(":"), parse_rule("c $1")], 55)
    plant = [Target("x", get_engine("md5(md5)").hash_batch([b"Bravo1"])[0])]
    hits = dev.make_wordlist_worker(words, plant, 1024, 8).process(
        WorkUnit(0, 0, words.keyspace))
    assert [(h.target_index, h.cand_index, h.plaintext) for h in hits] == \
        [(0, 3, b"Bravo1")]


def _cli(main, hashfile, pot, engine, device, capsys):
    rc = main(["crack", MASK, str(hashfile), "--engine", engine, "--device",
               device, "--potfile", str(pot), "--batch", "4096", "-q"])
    out = capsys.readouterr().out
    return rc, sorted(out.splitlines()), pot.read_text()


@pytest.mark.parametrize("name", ["md5(md5)", "mysql41"])
def test_cli_matches_reference(tmp_path, capsys, name):
    """crack --device torch-cpu against the reference's crack --device
    cpu: the same found set and potfile lines, a list of 30 targets with
    plants at the first and last index."""
    rng = _rng(name)
    gen = MaskGenerator(MASK)
    oracle = get_engine(name)
    plants = [0, gen.keyspace - 1, *rng.integers(1, gen.keyspace - 1, 3)]
    digests = oracle.hash_batch([gen.candidate(int(p)) for p in plants]
                                + _cands(rng, 8, 25))
    lines = ["*" + d.hex().upper() if name == "mysql41" else d.hex()
             for d in digests]
    hashfile = tmp_path / "h.txt"
    hashfile.write_text("\n".join(lines) + "\n")
    want = _cli(ref_main, hashfile, tmp_path / "ref.pot", name, "cpu",
                capsys)
    got = _cli(port_main, hashfile, tmp_path / "port.pot", name,
               "torch-cpu", capsys)
    assert got == want
    assert want[0] == 0 and len(want[1]) == len(plants)


def test_device_cuda_refuses_what_the_kernel_does_not_take(tmp_path, capsys,
                                                          monkeypatch):
    """On --device cuda (torch made to report a card: the refusal comes
    before any launch) a list of 8,193 nested targets exits 2 naming
    --device cpu; a nested wordlist job over the same list runs on
    --device torch-cpu and finds its plant."""
    plant = get_engine("md5(md5)").hash_batch([b"alpha"])[0].hex()
    hashfile = tmp_path / "h.txt"
    hashfile.write_text("".join(f"{i:032x}\n" for i in range(8192))
                        + plant + "\n")
    words = tmp_path / "w.txt"
    words.write_text("alpha\n")
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        assert port_main(["crack", "?l?l", str(hashfile), "--engine",
                          "md5(md5)", "--no-potfile"]) == 2
        err = capsys.readouterr().err
        assert "--device cpu" in err and "needs an NVIDIA card" not in err
    assert port_main(["crack", "-a", "wordlist", str(words), str(hashfile),
                      "--engine", "md5(md5)", "--device", "torch-cpu",
                      "--no-potfile", "-q"]) == 0
    assert capsys.readouterr().out == f"{plant}:alpha\n"
