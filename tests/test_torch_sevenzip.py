"""7-Zip (hashcat 11600) in the port (engines/cpu/sevenzip.py,
ops/cuda_7z.py, engines/device/sevenzip.py) against the reference (its
oracle, the KDF kernel's lane function ``pallas_7z._kdf_lanes``, the XLA
stream walker ``sevenzip_key_words``, ``make_state_check``, the CLI) and
hashlib, on the same inputs made from seeds.  Exact equality throughout.

``_kdf_lanes`` runs eagerly, with a Python loop standing in for its
``lax.fori_loop`` (its body calls ``.astype`` on the loop index, which
an eager fori_loop hands over as an int): under ``jax.jit`` XLA's CPU
compiler does not finish its group body within minutes.  On the CPU the
worker's step runs the KDF kernel's plain version;
tests/test_torch_cuda.py holds the kernel against it on a card.
"""

import re
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from dprf_tpu.cli import main as ref_main
from dprf_tpu.engines import engine_names as ref_engine_names
from dprf_tpu.engines.cpu import sevenzip as ref_cpu
from dprf_tpu.engines.device import sevenzip as ref_dev
from dprf_tpu.ops import pallas_7z
from dprf_tpu_torch.cli import main as port_main
from dprf_tpu_torch.engines import engine_names, get_engine
from dprf_tpu_torch.engines.base import TargetRefused
from dprf_tpu_torch.engines.cpu.sevenzip import (encrypt, parse_7z,
                                                 sevenzip_decrypt,
                                                 sevenzip_key)
from dprf_tpu_torch.engines.device import sevenzip as dev
from dprf_tpu_torch.generators.mask import MaskGenerator
from dprf_tpu_torch.ops import cuda_7z
from dprf_tpu_torch.runtime.workunit import WorkUnit

pytestmark = pytest.mark.smoke

#: the names of slice F3
SLICE_NAMES = {"7z", "sevenzip", "pdf"}


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _cands(gen, start: int, n: int) -> np.ndarray:
    return np.array([list(gen.candidate(start + i)) for i in range(n)],
                    np.uint32)


def test_oracle_and_parsing_match_reference():
    """The key, the CBC decrypt, a forward line (salted, an 8-byte IV)
    parsed and checked by both oracles; the parse errors."""
    rng = np.random.default_rng(1)
    salt, iv = bytes(rng.integers(0, 256, 4, dtype=np.uint8)), bytes(8)
    plain = bytes(rng.integers(0, 256, 50, dtype=np.uint8))
    line = encrypt(b"s3vn", plain, cycles=6, salt=salt, iv=iv)
    assert parse_7z(line) == ref_cpu.parse_7z(line)
    params = parse_7z(line)
    key = sevenzip_key(b"s3vn", salt, 6)
    assert key == ref_cpu.sevenzip_key(b"s3vn", salt, 6)
    assert sevenzip_decrypt(key, iv, params["data"])[:50] == plain
    eng, ref = get_engine("7z"), ref_cpu.SevenZipEngine()
    t, rt = eng.parse_target(line), ref.parse_target(line)
    assert (t.raw, t.digest, t.params) == (rt.raw, rt.digest, rt.params)
    assert eng.verify(b"s3vn", t) and ref.verify(b"s3vn", rt)
    assert not eng.verify(b"s3vX", t)
    assert type(get_engine("sevenzip")) is type(eng)
    for bad in ("$7z$1$19$0$$16$" + "00" * 16 + "$1$16$10$" + "00" * 16,
                "$zip$x", "$7z$0$25$0$$16$" + "00" * 16 + "$1$16$10$"
                + "00" * 16,
                "$7z$0$19$0$$16$" + "00" * 16 + "$1$15$10$" + "00" * 15):
        with pytest.raises(ValueError):
            ref_cpu.parse_7z(bad)
        with pytest.raises(ValueError):
            parse_7z(bad)


@pytest.mark.parametrize("mask,salt_len,cycles", [
    ("?l?d?l?d", 0, 6),           # unit 16: units align with the blocks
    ("?d?l?l?d?l?l", 4, 7),       # unit 24: units straddle the blocks
    ("?l?l?l?d", 16, 8)])         # unit 32
def test_kdf_plain_matches_reference_and_hashlib(mask, salt_len, cycles):
    """``sevenzip_kdf_plain`` at a partial batch against the reference's
    XLA stream walker and hashlib at the first and last lanes."""
    gen = MaskGenerator(mask)
    rng = np.random.default_rng(len(mask) * 100 + salt_len)
    salt = bytes(rng.integers(0, 256, salt_len, dtype=np.uint8))
    start = int(rng.integers(0, gen.keyspace - 16))
    got = _u32(cuda_7z.sevenzip_kdf(gen.charset_lut(), gen.radices,
                                    gen.digits(start), 13, salt, cycles, 16))
    assert got.shape == (13, 8)
    want = np.asarray(jax.jit(
        lambda c: ref_dev.sevenzip_key_words(c, gen.length, salt, cycles))(
        jnp.asarray(_cands(gen, start, 13))))
    assert (got == want).all()
    for lane in (0, 12):
        assert got[lane].astype(">u4").tobytes() == \
            sevenzip_key(gen.candidate(start + lane), salt, cycles)


def test_kdf_plain_matches_the_kernels_lane_function(monkeypatch):
    """``_kdf_lanes``, the TPU kernel's body, on candidate bytes laid out
    as its (sublane, lane) tiles, eagerly (see the module's docstring)."""
    def python_fori(lo, hi, body, carry):
        for i in range(lo, hi):
            carry = body(jnp.int32(i), carry)
        return carry

    gen, salt, cycles = MaskGenerator("?l?d?l?d"), b"", 6
    start = 1000
    cand = _cands(gen, start, 8).T.reshape(gen.length, 1, 8)
    with monkeypatch.context() as m:
        m.setattr(lax, "fori_loop", python_fori)
        words = pallas_7z._kdf_lanes([jnp.asarray(c) for c in cand],
                                     gen.length, salt, cycles, (1, 8))
    want = np.stack([np.asarray(w).reshape(8) for w in words], axis=1)
    got = _u32(cuda_7z.sevenzip_kdf(gen.charset_lut(), gen.radices,
                                    gen.digits(start), 8, salt, cycles, 8))
    assert (got == want).all()


def test_state_check_matches_reference():
    """The torch verdict (AES-256-CBC of the unpacked blocks, CRC32) on
    seeded key states against the reference's ``make_state_check``, and
    the true key's CRC against the stored one."""
    rng = np.random.default_rng(7)
    plain = bytes(rng.integers(0, 256, 70, dtype=np.uint8))
    line = encrypt(b"pw", plain, cycles=6, salt=b"ab",
                   iv=bytes(rng.integers(0, 256, 16, dtype=np.uint8)))
    params = parse_7z(line)
    true = np.frombuffer(sevenzip_key(b"pw", b"ab", 6), ">u4")
    states = rng.integers(0, 2 ** 32, (5, 8), dtype=np.uint64).astype(
        np.uint32)
    states[3] = true
    got = dev.make_state_check(params)(
        torch.as_tensor(states.view(np.int32))).numpy()
    want = np.asarray(ref_dev.make_state_check(params)(
        jnp.asarray(states)))[:, 0]
    assert (got == want.astype(np.int64)).all()
    assert got[3] == params["crc"] == struct.unpack(
        "<I", get_engine("7z").parse_target(line).digest)[0]


def _lines(gen, plants, cycles=6):
    rng = np.random.default_rng(11)
    out = []
    for i, idx in enumerate(plants):
        pw = gen.candidate(idx) if idx is not None else b"no-such"
        salt = bytes(rng.integers(0, 256, 4 * i, dtype=np.uint8))
        out.append(encrypt(pw, bytes(rng.integers(0, 256, 20 + 30 * i,
                                                  dtype=np.uint8)),
                           cycles=cycles + i % 2, salt=salt))
    return out


def test_worker_finds_planted_and_rescans_overflow():
    """Entries planted at the first, the last and a random index (salts
    of 0, 4 and 8 bytes, cycles 6 and 7); hit capacity 0 sends a hit
    batch to the oracle rescan."""
    gen = MaskGenerator("?d?d")
    last = gen.keyspace - 1
    rnd = int(np.random.default_rng(3).integers(1, last))
    eng = get_engine("7z")
    targets = [eng.parse_target(ln) for ln in _lines(gen, [0, last, rnd])]
    dev_eng = get_engine("7z", "cuda", torch_device="cpu")
    w = dev_eng.make_mask_worker(gen, targets, batch=50, hit_capacity=8,
                                 oracle=eng)
    hits = w.process(WorkUnit(0, 0, gen.keyspace))
    assert [(h.target_index, h.cand_index) for h in hits] == \
        sorted([(0, 0), (1, last), (2, rnd)], key=lambda x: x[1])
    assert all(h.plaintext == gen.candidate(h.cand_index) for h in hits)
    assert w.dispatched == 3 * 2 and w.n_maybe() is None
    w = dev_eng.make_mask_worker(gen, targets[:1], batch=50, hit_capacity=0,
                                 oracle=eng)
    hits = w.process(WorkUnit(0, 0, gen.keyspace))
    assert [(h.target_index, h.cand_index) for h in hits] == [(0, 0)]


def _tested(err: str) -> int:
    """tested= of a CLI's job summary."""
    return int(re.search(r"job finished .* tested=(\d+)", err).group(1))


def _crack(main, device, tmp_path, capsys, engine, lines, mask,
           extra=()):
    hashfile = tmp_path / "h.txt"
    hashfile.write_text("\n".join(lines) + "\n")
    pot = tmp_path / f"{device}.pot"
    rc = main(["crack", mask, str(hashfile), "--engine", engine,
               "--device", device, "--potfile", str(pot), *extra])
    out, err = capsys.readouterr()
    pots = sorted(pot.read_text().splitlines()) if pot.exists() else []
    return rc, sorted(out.splitlines()), pots, err


def test_cli_matches_reference_cli(tmp_path, capsys):
    """crack --device torch-cpu (the port) against the reference's crack
    --device cpu on the same hash file: the same found lines, potfile
    and tested count."""
    gen = MaskGenerator("?d?d")
    lines = _lines(gen, [5, 77, None])
    got = _crack(port_main, "torch-cpu", tmp_path, capsys, "7z", lines,
                 "?d?d", ["--batch", "512"])
    want = _crack(ref_main, "cpu", tmp_path, capsys, "sevenzip", lines,
                  "?d?d")
    assert got[:3] == want[:3] and got[0] == 0 and len(got[1]) == 2
    assert "rejected=0" in got[3]
    assert _tested(got[3]) == _tested(want[3]) == gen.keyspace


def test_refusals_name_device_cpu(tmp_path, capsys):
    """A payload over the cap, a salt over 16 bytes and 2^cycles units
    that do not tile whole blocks exit 2 naming the line and --device
    cpu (no CPU worker); so does a wordlist job and a mask past 27
    positions; the kernel's wrapper refuses CPU tensors."""
    gen = MaskGenerator("?d?l?d")
    good = encrypt(b"x", b"ok", cycles=6)
    bad = {"payload": encrypt(b"x", bytes(dev.DATA_CAP + 1), cycles=6),
           "salt": encrypt(b"x", b"ok", cycles=6, salt=bytes(17)),
           "tile": encrypt(b"x", b"ok", cycles=2)}
    for what, line in bad.items():
        rc, _, _, err = _crack(port_main, "torch-cpu", tmp_path, capsys,
                               "7z", [good, line], "?d?l?d")
        assert rc == 2 and "line 2" in err and "--device cpu" in err, what
    dev_eng = get_engine("7z", "cuda", torch_device="cpu")
    with pytest.raises(TargetRefused):
        dev_eng.make_mask_worker(gen, [dev_eng.parse_target(bad["payload"])],
                                 64, 8)
    words = tmp_path / "w.txt"
    words.write_text("x\n")
    rc, _, _, err = _crack(port_main, "torch-cpu", tmp_path, capsys, "7z",
                           [good], str(words), ["-a", "wordlist"])
    assert rc == 2 and "--device cpu" in err
    rc, _, _, err = _crack(port_main, "torch-cpu", tmp_path, capsys, "7z",
                           [good], "?d" * 28)
    assert rc == 2 and "--device cpu" in err
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_7z.sevenzip_kdf_kernel(gen.charset_lut(), gen.radices,
                                    gen.digits(0), 8, b"", 6, 8)
    assert cuda_7z.launches[cuda_7z.KERNEL] == 0
    for args in ((b"", 2), (bytes(17), 6), (b"", 25)):
        with pytest.raises(ValueError, match="no 7z KDF kernel"):
            cuda_7z.sevenzip_kdf(gen.charset_lut(), gen.radices,
                                 gen.digits(0), 8, *args, 8)


def test_batch_is_capped():
    """The worker's launch is at most BATCH candidates (whole resident
    waves on a card; the CLI's 2^24 default is cut)."""
    gen = MaskGenerator("?d?l")
    eng = get_engine("7z")
    w = get_engine("7z", "cuda", torch_device="cpu").make_mask_worker(
        gen, [eng.parse_target(_lines(gen, [1])[0])], 1 << 24, 8)
    assert w.batch == w.stride == dev.BATCH


@pytest.mark.parametrize("wave, want", [
    (168_960, 337_920),      # an H100's wave at L = 8: 1.55 waves -> 2
    (1 << 20, 1 << 20),      # a wave past the cap: one wave
    (100_000, 300_000)])     # 2.62 waves -> 3
def test_batch_rounds_to_whole_waves_on_a_card(monkeypatch, wave, want):
    """On a card the capped batch goes to the nearest whole number of
    resident waves, at least one (the wave size stands in for the
    occupancy query, which needs a card)."""
    monkeypatch.setattr(cuda_7z, "resident_lanes", lambda length, d: wave)
    gen = MaskGenerator("?l" * 8)
    assert dev.batch_for(gen, 1 << 24, torch.device("cuda")) == want
    assert dev.batch_for(gen, 1 << 24, torch.device("cpu")) == dev.BATCH


def test_engine_names_of_the_slice():
    """73 names on cuda and on the port's cpu (60 through slice K3, 13
    more since slice L), the same set, the three of slice F3 among them,
    every one a name of the reference's device engines."""
    cuda, cpu = set(engine_names("cuda")), set(engine_names("cpu"))
    assert cuda == cpu and len(cuda) == 73
    assert SLICE_NAMES <= cuda
    assert cuda <= set(ref_engine_names("jax"))
