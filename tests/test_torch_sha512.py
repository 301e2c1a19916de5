"""SHA-512 and SHA-384 in the port (ops/sha512.py, ops/pack.py's
pack_fixed_wide, the mask kernel's wide cores) against the reference
(dprf_tpu.ops.sha512, dprf_tpu.ops.pack, pallas_mask's kernel body run
eagerly by emulate_mask_kernel at sub=1, the CPU CLI) and hashlib, on
the same inputs made from numpy seeds.  Exact equality throughout:
these are integers.

On the CPU the steps run the kernel's plain PyTorch version, because
their tensors lie on the CPU (what ``--device torch-cpu`` runs);
tests/test_torch_cuda.py holds the CUDA kernel against it on a card.
"""

import functools
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dprf_tpu.cli import main as ref_main
from dprf_tpu.generators.mask import MaskGenerator as RefMaskGenerator
from dprf_tpu.ops import pack as ref_pack
from dprf_tpu.ops import sha512 as ref_sha512
from dprf_tpu.ops.pallas_mask import emulate_mask_kernel
from dprf_tpu_torch.cli import main as port_main
from dprf_tpu_torch.engines import get_engine
from dprf_tpu_torch.generators.mask import MaskGenerator
from dprf_tpu_torch.ops import cuda_mask, sha512
from dprf_tpu_torch.ops.compare import digest_rows, make_target_table
from dprf_tpu_torch.ops.pack import pack_fixed_wide

pytestmark = pytest.mark.smoke

ENGINES = ["sha512", "sha384"]
MASK = "?l?d?l"
#: one emulated tile at sub=1: 128 lanes
TILE = 128


LENGTHS = (0, 1, 55, 56, 111)


def _cands(length: int, n: int = 3) -> np.ndarray:
    rng = np.random.default_rng(length)
    return rng.integers(0, 256, (n, length), dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def _reference():
    """The reference's packed blocks and sha512 / sha384 digest words of
    every length's candidates, in one batch (one compile per core)."""
    words = np.concatenate([np.asarray(ref_pack.pack_fixed_wide(
        jnp.asarray(_cands(n)), n)) for n in LENGTHS])
    return (words, np.asarray(ref_sha512.sha512_digest_words(words)),
            np.asarray(ref_sha512.sha384_digest_words(words)))


@pytest.mark.parametrize("length", LENGTHS)
def test_plain_digests_and_packing_match_reference(length):
    """pack_fixed_wide and the plain sha512 / sha384 digest words
    against the reference's packer and cores and hashlib."""
    cand = _cands(length)
    rows = slice(3 * LENGTHS.index(length), 3 * LENGTHS.index(length) + 3)
    ref_words, ref512, ref384 = (a[rows] for a in _reference())
    words = pack_fixed_wide(torch.as_tensor(cand), length)
    assert words.numpy().view(np.uint32).tolist() == ref_words.tolist()
    for fn, ref, algo in ((sha512.sha512_digest_words, ref512, "sha512"),
                          (sha512.sha384_digest_words, ref384, "sha384")):
        got = fn(words).numpy().view(np.uint32)
        assert got.tolist() == ref.tolist()
        assert [r.astype(">u4").tobytes() for r in got] == \
            [hashlib.new(algo, c.tobytes()).digest() for c in cand]


def test_packing_refuses_past_one_block():
    with pytest.raises(ValueError, match="111"):
        pack_fixed_wide(torch.zeros((1, 112), dtype=torch.uint8), 112)


def test_engines_match_the_oracles():
    cands = [bytes(c) for c in _cands(7)] + [b"", b"x" * 111]
    for name in ENGINES + ["sha-512", "sha-384"]:
        port = get_engine(name, "cuda", torch_device="cpu")
        assert port.hash_batch(cands) == get_engine(name).hash_batch(cands)
        assert port.max_candidate_len == 111
        # the kernel's wide layout holds the longest mask
        block = cuda_mask.message_block(name, 1)
        assert cuda_mask.args_layout(len(block)).POSITIONS >= 111


@pytest.mark.parametrize("engine,plant,n_valid", [
    ("sha512", 0, TILE), ("sha512", TILE - 2, TILE - 1),
    ("sha512", 71, TILE), ("sha384", 93, TILE - 5)])
def test_mask_step_matches_emulated_kernel(engine, plant, n_valid):
    """One target planted at the first lane, the last valid lane of a
    partial batch or a seeded index: the step's hits against the
    reference kernel body run eagerly over one 128-lane tile."""
    gen, ref_gen = MaskGenerator(MASK), RefMaskGenerator(MASK)
    start = 2 * TILE
    digest = get_engine(engine).hash_batch([gen.candidate(start + plant)])
    target = digest_rows(digest, False)[0]
    counts, lanes = emulate_mask_kernel(engine, ref_gen, target, TILE,
                                        ref_gen.digits(start), n_valid,
                                        sub=1)
    step = cuda_mask.make_cuda_mask_crack_step(engine, gen, target, TILE,
                                               hit_capacity=4, device="cpu")
    count, got, _ = step(gen.digits(start), n_valid)
    assert int(count) == int(counts.sum()) == 1
    assert [x for x in got.tolist() if x >= 0] == [int(lanes.max())] \
        == [plant]


def test_multi_hit_set_matches_emulated_kernel():
    """A list of 5 plants (two in one warp, one past n_valid) and 300
    fillers: the step's (lane, target) hits and its Bloom survivors
    against the reference kernel body's survivors over one tile."""
    gen, ref_gen = MaskGenerator(MASK), RefMaskGenerator(MASK)
    start, n_valid = 5 * TILE, TILE - 3
    plants = [0, 40, 41, TILE - 4, TILE - 3]
    oracle = get_engine("sha512")
    rng = np.random.default_rng(11)
    digests = oracle.hash_batch([gen.candidate(start + p) for p in plants])
    digests += oracle.hash_batch([rng.bytes(9) for _ in range(300)])
    order = rng.permutation(len(digests))
    digests = [digests[i] for i in order]
    table = make_target_table(digests, False)
    counts, lanes = emulate_mask_kernel("sha512", ref_gen,
                                        table.original_words(), TILE,
                                        ref_gen.digits(start), n_valid,
                                        sub=1)
    step = cuda_mask.make_cuda_multi_crack_step("sha512", gen, table, TILE,
                                                hit_capacity=8, device="cpu")
    count, got, tpos, n_maybe = step(gen.digits(start), n_valid)
    hits = sorted((int(la), int(table.order[tp])) for la, tp in
                  zip(got[:int(count)].tolist(), tpos[:int(count)].tolist()))
    want = sorted((p, int(np.flatnonzero(order == i)[0]))
                  for i, p in enumerate(plants) if p < n_valid)
    assert hits == want
    assert int(n_maybe) == int(counts.sum()) == len(want)
    assert int(lanes.max()) == max(p for p, _ in want)


def test_mask_lengths_at_the_block_limit(tmp_path, capsys):
    """A 111-position mask takes the kernel's worker; 112 positions is
    refused, naming --device cpu."""
    eng = get_engine("sha512", "cuda", torch_device="cpu")
    oracle = get_engine("sha512")
    targets = [oracle.parse_target(oracle.hash_batch([b"x"])[0].hex())]
    worker = eng.make_mask_worker(MaskGenerator("?d" * 111), targets,
                                  batch=64, hit_capacity=4, oracle=oracle)
    assert worker.step is not None
    with pytest.raises(ValueError, match="--device cpu"):
        eng.make_mask_worker(MaskGenerator("?d" * 112), targets, batch=64,
                             hit_capacity=4, oracle=oracle)
    hashfile = tmp_path / "h.txt"
    hashfile.write_text(targets[0].raw + "\n")
    assert port_main(["crack", "?d" * 112, str(hashfile), "--engine",
                      "sha512", "--device", "torch-cpu", "--no-potfile",
                      "-q"]) == 2
    assert "--device cpu" in capsys.readouterr().err


@pytest.mark.parametrize("engine", ["sha512", "sha-384"])
def test_cli_matches_reference_cli(engine, tmp_path, capsys):
    """crack --device torch-cpu (the port) against the reference's crack
    --device cpu on the same hash file: the same found lines and
    potfile."""
    plains = [b"k7q", b"a0a", b"z9z"]
    oracle = get_engine(engine)
    lines = [d.hex() for d in oracle.hash_batch(plains)]
    lines.append(oracle.hash_batch([b"nope!"])[0].hex())
    hashfile = tmp_path / "h.txt"
    hashfile.write_text("\n".join(lines) + "\n")
    results = []
    for main, device in ((port_main, "torch-cpu"), (ref_main, "cpu")):
        pot = tmp_path / f"{device}.potfile"
        rc = main(["crack", MASK, str(hashfile), "--engine", engine,
                   "--device", device, "--potfile", str(pot), "-q"])
        out = sorted(capsys.readouterr().out.splitlines())
        results.append((rc, out, sorted(pot.read_text().splitlines())))
    assert results[0] == results[1]
    assert len(results[0][1]) == 3
