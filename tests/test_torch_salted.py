"""The salted fast hashes in the port (engines/device/salted.py,
ops/cuda_ext.py, the oracles and line parsers of engines/cpu/engines.py)
against the reference (pallas_ext.emulate_ext_kernel, the reference's
CPU engines, CpuWorker and CLI), on the same inputs made from numpy
seeds.  Exact equality throughout.

On the CPU the salted step runs the kernel's plain PyTorch version,
because its tensors lie on the CPU (what ``--device torch-cpu`` runs);
tests/test_torch_cuda.py holds the CUDA kernel against it on a card.
"""

import base64
import hashlib

import numpy as np
import pytest

from dprf_tpu.cli import main as ref_main
from dprf_tpu.engines import get_engine as ref_get_engine
from dprf_tpu.generators.mask import MaskGenerator as RefMaskGenerator
from dprf_tpu.ops import pallas_ext
from dprf_tpu.runtime.worker import CpuWorker as RefCpuWorker
from dprf_tpu.runtime.workunit import WorkUnit as RefWorkUnit
from dprf_tpu_torch.cli import main as port_main
from dprf_tpu_torch.engines import get_engine
from dprf_tpu_torch.generators.mask import MaskGenerator
from dprf_tpu_torch.generators.wordlist import WordlistRulesGenerator
from dprf_tpu_torch.ops import cuda_ext
from dprf_tpu_torch.ops.compare import digest_rows
from dprf_tpu_torch.rules.parser import parse_rule
from dprf_tpu_torch.runtime.workunit import WorkUnit

pytestmark = pytest.mark.smoke

MASK = "?l?l?l"
#: the emulator's tile (sub=8): one grid cell of 1024 lanes
SUB = 8
TILE = SUB * 128
SALT_LENS = (0, 1, 3, 4, 7, 32)


def _salt(rng, n: int) -> bytes:
    """n seeded salt bytes, NUL and ':' included."""
    return bytes(rng.integers(0, 256, n, dtype=np.uint8))


def _words(algo: str, digest: bytes) -> np.ndarray:
    return digest_rows([digest], algo == "md5")[0]


@pytest.mark.parametrize("variant", cuda_ext.SALTED_NAMES)
def test_salted_step_matches_emulated_kernel(variant):
    """A job of one target per salt length of SALT_LENS and one no
    candidate reaches, grouped as the worker groups them (every ps
    target in one group, sp by salt length): each group's step over a
    partial batch gives exactly the (lane, target) hits of the reference
    body run per target -- the plant at lane 0 for the empty salt, at
    the last valid lane for the longest, at a seeded lane otherwise."""
    algo, order = cuda_ext.split_salted(variant)
    rng = np.random.default_rng(sum(variant.encode()))
    gen, gen_ref = MaskGenerator(MASK), RefMaskGenerator(MASK)
    oracle = get_engine(variant)
    start = int(rng.integers(0, gen.keyspace // TILE - 1)) * TILE
    n_valid = TILE - int(rng.integers(1, 50))
    targets, want = [], set()
    for i, n in enumerate(SALT_LENS + (5,)):
        salt = _salt(rng, n)
        plant = {0: 0, 32: n_valid - 1}.get(n, int(rng.integers(0, n_valid)))
        plain = gen.candidate(start + plant) if i < len(SALT_LENS) else \
            b"not-in-the-mask"
        tw = _words(algo, oracle.hash_batch([plain],
                                            params={"salt": salt})[0])
        counts, lanes = pallas_ext.emulate_ext_kernel(
            algo, gen_ref, tw, TILE, gen.digits(start), n_valid, sub=SUB,
            order=order, salt=salt)
        if int(counts.sum()):
            assert int(counts[0, 0]) == 1
            want.add((int(lanes[0, 0]), i))
        targets.append((salt, [int(w) for w in tw]))
    assert len(want) == len(SALT_LENS)
    groups = cuda_ext.salted_groups(variant, [s for s, _ in targets])
    assert len(groups) == (1 if order == "ps" else len(set(SALT_LENS + (5,))))
    got = set()
    for idx in groups:
        step = cuda_ext.make_salted_crack_step(
            variant, gen, [targets[i] for i in idx], TILE, 8, device="cpu")
        count, lanes, tpos, tcount = step(gen.digits(start), n_valid)
        pairs = {(int(a), idx[int(b)]) for a, b in zip(lanes.tolist(),
                                                       tpos.tolist())
                 if a >= 0}
        assert int(count) == len(pairs) == int(tcount.sum())
        assert tcount.tolist() == [sum(1 for _, t in pairs if t == i)
                                   for i in idx]
        got |= pairs
    assert got == want


def test_salted_engines_hash_like_the_oracles():
    """The device engines' hash_batch with a target's params is the
    oracle's, at candidate + salt = 55 bytes too."""
    rng = np.random.default_rng(9)
    for variant in cuda_ext.SALTED_NAMES:
        dev = get_engine(variant, "cuda", torch_device="cpu")
        for n in (0, 4, 32):
            salt = _salt(rng, n)
            cands = [b"", b"a", bytes(rng.integers(32, 127, 55 - n,
                                                   dtype=np.uint8))]
            assert dev.hash_batch(cands, params={"salt": salt}) == \
                get_engine(variant).hash_batch(cands, params={"salt": salt})


def _lines():
    """Target lines of each new name, in the reference's formats."""
    md5 = hashlib.md5(b"pw" + b"s:a\0lt").hexdigest()
    ssha = base64.b64encode(hashlib.sha1(b"pw" + b"NaCl").digest()
                            + b"NaCl").decode()
    smd5 = base64.b64encode(hashlib.md5(b"pw" + b"xy").digest()
                            + b"xy").decode()
    ora = hashlib.sha1(b"pw" + bytes(range(10))).hexdigest().upper()
    return {
        "md5-ps": [f"{md5}:$HEX[{b's:a'.hex()}00{b'lt'.hex()}]",
                   f"{md5}:plain:salt:with:colons", f"{md5}:",
                   f"{md5}:{'x' * 33}", "zz:salt", f"{md5[:30]}:s"],
        "sha1-sp": [hashlib.sha1(b"abc").hexdigest() + ":$HEX[]",
                    hashlib.sha1(b"abc").hexdigest() + ":$HEX[3a00]"],
        "sha256-ps": [hashlib.sha256(b"abc").hexdigest() + ":" + "y" * 32],
        "postgres": [f"md5{md5}:admin", f"{md5}:$HEX[61646d696e00]",
                     f"md5{md5}"],
        "postgres-md5": [f"md5{md5}:root"],
        "ldap-ssha": ["{SSHA}" + ssha, "{ssha}" + ssha, "{SSHA}!!",
                      "{SMD5}" + smd5],
        "ssha": ["{SSHA}" + ssha],
        "ldap-smd5": ["{SMD5}" + smd5],
        "oracle11": [f"S:{ora}{bytes(range(10)).hex().upper()}",
                     f"{ora}:{bytes(range(10)).hex()}",
                     f"{ora}:0123456789", f"{ora}:short"],
        "oracle-11g": [f"s:{ora}{bytes(range(10)).hex()}"],
    }


@pytest.mark.parametrize("name", sorted(_lines()))
def test_parsers_match_reference(name):
    """The port's parse_target (CPU oracle and device engine) against
    the reference CPU engine's, line for line: the same digest and
    params, or both refuse."""
    ref = ref_get_engine(name)
    for line in _lines()[name]:
        try:
            want = ref.parse_target(line)
        except ValueError:
            want = None
        for eng in (get_engine(name),
                    get_engine(name, "cuda", torch_device="cpu")):
            if want is None:
                with pytest.raises(ValueError):
                    eng.parse_target(line)
                continue
            got = eng.parse_target(line)
            assert (got.raw, got.digest, got.params) == \
                (want.raw, want.digest, want.params), line


@pytest.mark.parametrize("variant,cap", [("md5-ps", 8), ("sha256-sp", 0)])
def test_worker_matches_reference_cpu_worker(variant, cap):
    """Three targets with salts of 0, 5 and 32 bytes, plants at the
    keyspace's first and last index and one target no candidate hits:
    the port's salted worker on CPU tensors gives the reference
    CpuWorker's hits, target indices included; a hit capacity of 0
    recovers them by the per-target oracle rescan."""
    rng = np.random.default_rng(5)
    gen, gen_ref = MaskGenerator(MASK), RefMaskGenerator(MASK)
    oracle, ref = get_engine(variant), ref_get_engine(variant)
    plants = [(gen.keyspace - 1, _salt(rng, 32)), (None, _salt(rng, 5)),
              (0, b"")]
    lines = []
    for p, salt in plants:
        plain = gen.candidate(p) if p is not None else b"not-in-the-mask"
        d = oracle.hash_batch([plain], params={"salt": salt})[0]
        lines.append(f"{d.hex()}:$HEX[{salt.hex()}]")
    unit = (100, gen.keyspace - 100)
    ref_t = [ref.parse_target(ln) for ln in lines]
    want = sorted((h.target_index, h.cand_index, h.plaintext) for h in
                  RefCpuWorker(ref, gen_ref, ref_t).process(
                      RefWorkUnit(0, 0, gen.keyspace)))
    assert [(t, i) for t, i, _ in want] == [(0, gen.keyspace - 1), (2, 0)]
    dev = get_engine(variant, "cuda", torch_device="cpu")
    w = dev.make_mask_worker(gen, [oracle.parse_target(ln) for ln in lines],
                             batch=4096, hit_capacity=cap, oracle=oracle)
    got = []
    for start, end in ((0, unit[0]), unit, (unit[1], gen.keyspace)):
        got += [(h.target_index, h.cand_index, h.plaintext) for h in
                w.process(WorkUnit(0, start, end - start))]
    assert sorted(got) == want
    # one launch a (group, batch): ps targets share a group, sp targets
    # of three salt lengths take three
    assert len(w.groups) == (1 if variant.endswith("ps") else 3)
    assert w.dispatched == len(w.groups) * (1 + 5 + 1)


def test_eligibility_and_length_checks():
    """salted_eligible is the reference's but for the two stated
    differences (sha256 off a TPU; any number of distinct salt
    lengths); L + S = 55 passes (23 + 32), 56 raises with the
    reference's text and names --device cpu; a wordlist job runs (the
    rules kernel's salted tail, its plain version on CPU tensors) and
    finds its plant, and one whose words plus salt pass the block raises
    with the reference's text."""
    gen, ref = MaskGenerator("?d" * 23), RefMaskGenerator("?d" * 23)
    for algo in ("md5", "sha1", "sha256", "sha512", "ntlm"):
        for order in ("ps", "sp", "xx"):
            for lens in ([0], [32], [1, 2, 3], list(range(9)), []):
                want = pallas_ext.salted_eligible(algo, order, ref, lens)
                if algo == "sha256" or len(set(lens)) > 8:
                    want = (algo in cuda_ext.SALTED_ALGOS and
                            order in ("ps", "sp") and bool(lens))
                assert cuda_ext.salted_eligible(algo, order, gen, lens) == \
                    want, (algo, order, lens)
    oracle = get_engine("sha1-ps")
    dev = get_engine("sha1-ps", "cuda", torch_device="cpu")
    ref_dev = ref_get_engine("sha1-ps", "jax")
    line = f"{'00' * 20}:{'s' * 32}"
    targets = [oracle.parse_target(line)]
    ref_t = [ref_dev.parse_target(line)]
    for length, ok in ((23, True), (24, False)):
        g = MaskGenerator("?d" * length)
        assert cuda_ext.salted_eligible("sha1", "ps", g, [32]) == ok
        if ok:
            ref_dev._check_lengths(length, ref_t)
            dev.make_mask_worker(g, targets, 1024, 8, oracle)
            continue
        with pytest.raises(ValueError) as want:
            ref_dev._check_lengths(length, ref_t)
        with pytest.raises(ValueError, match="--device cpu") as got:
            dev.make_mask_worker(g, targets, 1024, 8, oracle)
        assert str(got.value).startswith(str(want.value))
    words = WordlistRulesGenerator([b"alpha", b"bravo"],
                                   [parse_rule(":"), parse_rule("u")], 23)
    plant = [oracle.parse_target(
        f"{oracle.hash_batch([b'BRAVO'], params={'salt': b's' * 32})[0].hex()}"
        f":{'s' * 32}")]
    hits = dev.make_wordlist_worker(words, plant, 1024, 8, oracle).process(
        WorkUnit(0, 0, words.keyspace))
    assert [(h.target_index, h.cand_index, h.plaintext) for h in hits] == \
        [(0, 3, b"BRAVO")]
    long_words = WordlistRulesGenerator([b"alpha"], [parse_rule(":")], 24)
    with pytest.raises(ValueError) as want:
        ref_dev._check_lengths(long_words.max_len, ref_t)
    with pytest.raises(ValueError, match="--device cpu") as got:
        dev.make_wordlist_worker(long_words, targets, 1024, 8, oracle)
    assert str(got.value).startswith(str(want.value))


def _cli(main, hashfile, pot, engine, device, capsys):
    rc = main(["crack", MASK, str(hashfile), "--engine", engine, "--device",
               device, "--potfile", str(pot), "--batch", "4096", "-q"])
    return rc, sorted(capsys.readouterr().out.splitlines()), pot.read_text()


@pytest.mark.parametrize("variant", ["md5-ps", "sha1-sp"])
def test_cli_matches_reference(tmp_path, capsys, variant):
    """crack --device torch-cpu against the reference's crack --device
    cpu over a list of salted lines: the same found set and potfile."""
    rng = np.random.default_rng(13)
    gen = MaskGenerator(MASK)
    oracle = get_engine(variant)
    lines = []
    for i, p in enumerate([0, gen.keyspace - 1, 4321, None]):
        salt = _salt(rng, (0, 7, 32, 3)[i])
        plain = gen.candidate(p) if p is not None else b"\x01"
        d = oracle.hash_batch([plain], params={"salt": salt})[0]
        lines.append(f"{d.hex()}:$HEX[{salt.hex()}]")
    lines.append(f"{d.hex()}:plain-salt")
    hashfile = tmp_path / "h.txt"
    hashfile.write_text("\n".join(lines) + "\n")
    want = _cli(ref_main, hashfile, tmp_path / "ref.pot", variant, "cpu",
                capsys)
    got = _cli(port_main, hashfile, tmp_path / "port.pot", variant,
               "torch-cpu", capsys)
    assert got == want
    assert want[0] == 0 and len(want[1]) == 3


def test_device_cuda_refuses_what_the_kernel_does_not_take(tmp_path, capsys,
                                                          monkeypatch):
    """On --device cuda (torch made to report a card: the refusal comes
    before any launch) a salted job whose mask plus salt passes 55 bytes
    exits 2 naming --device cpu; a salted wordlist job over the same line
    runs on --device torch-cpu and finds its plant."""
    import torch
    digest = get_engine("md5-ps").hash_batch([b"alpha"],
                                             params={"salt": b"s" * 32})[0]
    hashfile = tmp_path / "h.txt"
    hashfile.write_text(f"{digest.hex()}:{'s' * 32}\n")
    words = tmp_path / "w.txt"
    words.write_text("alpha\n")
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        assert port_main(["crack", "?d" * 24, str(hashfile), "--engine",
                          "md5-ps", "--no-potfile"]) == 2
        err = capsys.readouterr().err
        assert "--device cpu" in err and "needs an NVIDIA card" not in err
    assert port_main(["crack", "-a", "wordlist", str(words), str(hashfile),
                      "--engine", "md5-ps", "--device", "torch-cpu",
                      "--no-potfile", "-q"]) == 0
    assert capsys.readouterr().out == f"{digest.hex()}:{'s' * 32}:alpha\n"
