"""The SHA3 / Keccak family in the port (ops/keccak.py,
engines/device/sha3.py, ops/cuda_keccak.py) against the reference
(dprf_tpu.ops.keccak, pallas_keccak's kernel body run eagerly by
emulate_keccak_kernel at sub=1, the CPU oracles and CLI) and hashlib,
on the same inputs made from numpy seeds.  Exact equality throughout.

On the CPU the steps run the kernel's plain PyTorch version, because
their tensors lie on the CPU (what ``--device torch-cpu`` runs);
tests/test_torch_cuda.py holds the CUDA kernel against it on a card.
"""

import hashlib
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dprf_tpu.cli import main as ref_main
from dprf_tpu.engines import engine_names as ref_engine_names
from dprf_tpu.generators.mask import MaskGenerator as RefMaskGenerator
from dprf_tpu.ops import keccak as ref_keccak
from dprf_tpu.ops.pallas_keccak import emulate_keccak_kernel
from dprf_tpu_torch.cli import main as port_main
from dprf_tpu_torch.engines import engine_names, get_engine
from dprf_tpu_torch.engines.cpu.engines import KECCAK_SIZES
from dprf_tpu_torch.generators.mask import MaskGenerator
from dprf_tpu_torch.generators.wordlist import WordlistRulesGenerator
from dprf_tpu_torch.ops import cuda_keccak, cuda_rules, keccak
from dprf_tpu_torch.ops.compare import digest_rows, make_target_table
from dprf_tpu_torch.rules import parser
from dprf_tpu_torch.runtime.worker import CpuWorker
from dprf_tpu_torch.runtime.workunit import WorkUnit

pytestmark = pytest.mark.smoke

VARIANTS = [(kind, bits, rate) for bits, rate in KECCAK_SIZES
            for kind in ("sha3", "keccak")]
PAD = {"sha3": 0x06, "keccak": 0x01}
#: the 17 names this slice adds
SLICE_NAMES = {"sha512", "sha-512", "sha384", "sha-384", "sha3",
               "sha3-224", "sha3-256", "sha3-384", "sha3-512",
               "keccak-224", "keccak-256", "keccak-384", "keccak-512",
               "keccak224", "keccak256", "keccak384", "keccak512"}
MASK = "?l?d?l"
TILE = 128
SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "dprf_tpu_torch", "csrc", "keccak.cuh")


def test_keccak_f_matches_reference_on_seeded_states():
    rng = np.random.default_rng(4)
    hi = rng.integers(0, 1 << 32, (25, 8), dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, (25, 8), dtype=np.uint64).astype(np.uint32)
    state = {(i % 5, i // 5): (jnp.asarray(hi[i]), jnp.asarray(lo[i]))
             for i in range(25)}
    ref = ref_keccak.keccak_f_unrolled(state)
    lanes = [torch.as_tensor(((hi[i].astype(np.uint64) << np.uint64(32))
                              | lo[i]).view(np.int64)) for i in range(25)]
    got = keccak.keccak_f(lanes)
    for i in range(25):
        h, lo_ = ref[(i % 5, i // 5)]
        want = (np.asarray(h).astype(np.uint64) << np.uint64(32)) \
            | np.asarray(lo_)
        assert got[i].numpy().view(np.uint64).tolist() == want.tolist()


def test_constants_match_the_reference_and_the_source():
    assert keccak.RC == ref_keccak.RC
    assert keccak.RHO == [int(ref_keccak._RHO[i % 5, i // 5])
                          for i in range(25)]
    with open(SOURCE) as fh:
        src = fh.read()
    body = re.search(r"RC_KECCAK\[24\]\s*=\s*\{([^}]*)\}", src).group(1)
    assert [int(x, 16) for x in re.findall(r"0x[0-9a-f]+", body)] == \
        keccak.RC
    moves = re.findall(r"b\[(\d+)\] = rotl64\(a\[(\d+)\] \^ d\[\d\], (\d+)\)",
                       src)
    assert len(moves) == 24
    for dst, lane, rot in moves:
        assert keccak.PI[int(lane)] == int(dst)
        assert keccak.RHO[int(lane)] == int(rot)


@pytest.mark.parametrize("kind,bits,rate", VARIANTS)
def test_sponge_matches_hashlib_and_reference_digest(kind, bits, rate):
    """keccak_words at lengths 0, 1, 55 and rate - 1 against hashlib's
    sha3_* (SHA3) and the reference's scalar keccak_digest; the port's
    CPU oracle and device engine agree."""
    rng = np.random.default_rng(bits + PAD[kind])
    pad = PAD[kind]
    for n in (0, 1, 55, rate - 1):
        cand = rng.integers(0, 256, (2, n), dtype=np.uint8)
        got = keccak.keccak_words(torch.as_tensor(cand), n, pad, rate,
                                  bits // 8).numpy().view(np.uint32)
        want = [ref_keccak.keccak_digest(c.tobytes(), pad, rate, bits // 8)
                for c in cand]
        if kind == "sha3":
            assert want == [hashlib.new(f"sha3_{bits}", c.tobytes())
                            .digest() for c in cand]
        assert [r.astype(">u4").tobytes() for r in got] == want
        assert keccak.keccak_digest(cand[0].tobytes(), pad, rate,
                                    bits // 8) == want[0]
        name = f"{kind}-{bits}"
        port = get_engine(name, "cuda", torch_device="cpu")
        assert port.hash_batch([c.tobytes() for c in cand]) == want
        assert get_engine(name).hash_batch([c.tobytes() for c in cand]) \
            == want


@pytest.mark.parametrize("kind,bits,rate", VARIANTS)
def test_mask_step_matches_emulated_kernel(kind, bits, rate):
    """One target at the first lane (sha3) or the last valid lane of a
    partial batch (keccak): the step's hits against the reference
    kernel body run eagerly over one 128-lane tile."""
    name = f"{kind}-{bits}"
    gen, ref_gen = MaskGenerator(MASK), RefMaskGenerator(MASK)
    start = 3 * TILE
    plant, n_valid = (0, TILE) if kind == "sha3" else (TILE - 3, TILE - 2)
    digest = get_engine(name).hash_batch([gen.candidate(start + plant)])
    target = digest_rows(digest, False)[0]
    counts, lanes = emulate_keccak_kernel(ref_gen, target, TILE,
                                          ref_gen.digits(start), n_valid,
                                          PAD[kind], rate, bits // 8, sub=1)
    step = cuda_keccak.make_cuda_mask_crack_step(name, gen, target, TILE,
                                                 hit_capacity=4,
                                                 device="cpu")
    count, got, _ = step(gen.digits(start), n_valid)
    assert int(count) == int(counts.sum()) == 1
    assert [x for x in got.tolist() if x >= 0] == [int(lanes.max())] \
        == [plant]


def test_seeded_plant_matches_emulated_kernel():
    gen, ref_gen = MaskGenerator(MASK), RefMaskGenerator(MASK)
    rng = np.random.default_rng(9)
    start = int(rng.integers(0, gen.keyspace - TILE))
    plant = int(rng.integers(0, TILE))
    digest = get_engine("keccak256").hash_batch([gen.candidate(start + plant)])
    target = digest_rows(digest, False)[0]
    counts, lanes = emulate_keccak_kernel(ref_gen, target, TILE,
                                          ref_gen.digits(start), TILE, 0x01,
                                          136, 32, sub=1)
    step = cuda_keccak.make_cuda_mask_crack_step("keccak256", gen, target,
                                                 TILE, device="cpu")
    count, got, _ = step(gen.digits(start), TILE)
    assert (int(count), int(got[0])) == (int(counts.sum()),
                                         int(lanes.max())) == (1, plant)


@pytest.mark.parametrize("name,mask", [("sha3-256", "?l?d?l"),
                                       ("keccak-224", "?d?d?d")])
def test_multi_hit_set_matches_the_oracle(name, mask):
    """A list of plants (two in one warp) and fillers over the whole
    keyspace: the multi-target step's (index, target) hits equal the CPU
    oracle's sweep of the same list."""
    gen = MaskGenerator(mask)
    oracle = get_engine(name)
    rng = np.random.default_rng(len(name))
    plants = [0, 64, 65, int(rng.integers(66, gen.keyspace)),
              gen.keyspace - 1]
    digests = oracle.hash_batch([gen.candidate(p) for p in plants])
    digests += oracle.hash_batch([rng.bytes(gen.length + 1)
                                  for _ in range(200)])
    digests = [digests[i] for i in rng.permutation(len(digests))]
    targets = [oracle.parse_target(d.hex()) for d in digests]
    table = make_target_table(digests, False)
    step = cuda_keccak.make_cuda_multi_crack_step(name, gen, table,
                                                  gen.keyspace,
                                                  hit_capacity=16,
                                                  device="cpu")
    count, lanes, tpos, n_maybe = step(gen.digits(0), gen.keyspace)
    got = sorted((int(la), int(table.order[tp])) for la, tp in
                 zip(lanes[:int(count)].tolist(), tpos[:int(count)].tolist()))
    want = sorted((h.cand_index, h.target_index) for h in CpuWorker(
        oracle, gen, targets).process(WorkUnit(0, 0, gen.keyspace)))
    assert got == want
    assert len(want) == 5 and int(n_maybe) >= 5


def test_mask_lengths_at_the_rate_limit(tmp_path, capsys):
    """A 143-position sha3-224 mask takes the kernel's worker; 144
    positions is refused, naming --device cpu."""
    eng = get_engine("sha3-224", "cuda", torch_device="cpu")
    oracle = get_engine("sha3-224")
    targets = [oracle.parse_target(oracle.hash_batch([b"x"])[0].hex())]
    worker = eng.make_mask_worker(MaskGenerator("?d" * 143), targets,
                                  batch=64, hit_capacity=4, oracle=oracle)
    assert worker.step is not None
    with pytest.raises(ValueError, match="--device cpu"):
        eng.make_mask_worker(MaskGenerator("?d" * 144), targets, batch=64,
                             hit_capacity=4, oracle=oracle)
    hashfile = tmp_path / "h.txt"
    hashfile.write_text(targets[0].raw + "\n")
    assert port_main(["crack", "?d" * 144, str(hashfile), "--engine",
                      "sha3-224", "--device", "torch-cpu", "--no-potfile",
                      "-q"]) == 2
    assert "--device cpu" in capsys.readouterr().err


@pytest.mark.parametrize("name", sorted(SLICE_NAMES))
def test_wordlist_jobs_are_refused(name, tmp_path, capsys):
    """The slice's names were refused a wordlist (no rules core) until
    the rules kernel took the wide cores (csrc/rules_wide.cu): now
    kernel_rules_eligible is True and a wordlist job on torch-cpu (the
    kernel's plain version) exits 0 with its plant found."""
    gen = WordlistRulesGenerator([b"word"], [parser.parse_rule(":")],
                                 max_len=55)
    assert cuda_rules.kernel_rules_eligible(name, gen, 1)
    words = tmp_path / "w.txt"
    words.write_text("word\n")
    hashfile = tmp_path / "h.txt"
    digest = get_engine(name).hash_batch([b"word"])[0].hex()
    hashfile.write_text(digest + "\n")
    assert port_main(["crack", "-a", "wordlist", str(words), str(hashfile),
                      "--engine", name, "--device", "torch-cpu",
                      "--no-potfile", "-q"]) == 0
    assert capsys.readouterr().out == f"{digest}:word\n"


def test_engine_names_grow_by_the_slice():
    """The slice's 17 names on cuda and on the port's cpu, which list the
    same names; every one is a name of the reference's device engines.
    The count of all names lives in tests/test_torch_krb5.py."""
    cuda, cpu = set(engine_names("cuda")), set(engine_names("cpu"))
    assert cuda == cpu and len(SLICE_NAMES) == 17 and SLICE_NAMES <= cuda
    assert cuda <= set(ref_engine_names("jax"))


@pytest.mark.parametrize("engine", ["keccak-256", "sha3"])
def test_cli_matches_reference_cli(engine, tmp_path, capsys):
    """crack --device torch-cpu (the port) against the reference's crack
    --device cpu on the same hash file: the same found lines and
    potfile."""
    plains = [b"007", b"420", b"999"]
    oracle = get_engine(engine)
    lines = [d.hex() for d in oracle.hash_batch(plains)]
    lines.append(oracle.hash_batch([b"nope!"])[0].hex())
    hashfile = tmp_path / "h.txt"
    hashfile.write_text("\n".join(lines) + "\n")
    results = []
    for main, device in ((port_main, "torch-cpu"), (ref_main, "cpu")):
        pot = tmp_path / f"{device}.potfile"
        rc = main(["crack", "?d?d?d", str(hashfile), "--engine", engine,
                   "--device", device, "--potfile", str(pot), "-q"])
        out = sorted(capsys.readouterr().out.splitlines())
        results.append((rc, out, sorted(pot.read_text().splitlines())))
    assert results[0] == results[1]
    assert len(results[0][1]) == 3
