"""Config 5 in miniature: the port's WPA2-PMKID path against the JAX
package and hashlib.  The plain HMAC/PBKDF2 ops (the PMKID kernel's
plain version) against dprf_tpu.ops.hmac_sha1 and against hashlib with
RFC 6070's vectors; the plain step against the reference kernel's own
lane function (``pmkid_lanes``, run eagerly); the kernel worker on CPU
tensors on planted targets; the CLI on ``torch-cpu`` against ``cpu``.
Iterations are lowered, as the reference's tests lower them.  Exact
equality throughout."""

import hashlib
import hmac

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dprf_tpu.engines.cpu.engines import Pmkid2Engine as RefPmkid2Engine
from dprf_tpu.generators.mask import MaskGenerator as RefMaskGenerator
from dprf_tpu.ops import hmac_sha1 as ref_hmac
from dprf_tpu.ops.pallas_pbkdf2 import pmkid_lanes
from dprf_tpu_torch import cli
from dprf_tpu_torch.engines import get_engine
from dprf_tpu_torch.engines.cpu.engines import Pmkid2Engine
from dprf_tpu_torch.generators.mask import MaskGenerator
from dprf_tpu_torch.ops import cuda_pbkdf2, hmac_sha1
from dprf_tpu_torch.runtime.workunit import WorkUnit

pytestmark = pytest.mark.smoke

ESSID = b"TinyNet"
AP, STA = bytes.fromhex("aabbccddeeff"), bytes.fromhex("112233445566")


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _line(plain, essid, ap, sta, iterations):
    pmk = hashlib.pbkdf2_hmac("sha1", plain, essid, iterations, 32)
    pmkid = hmac.new(pmk, b"PMK Name" + ap + sta, hashlib.sha1).digest()
    return f"{pmkid[:16].hex()}*{ap.hex()}*{sta.hex()}*{essid.hex()}"


def _key_blocks(rng, n):
    """n random passphrases of 1..63 bytes as zero-padded key blocks."""
    cands = [bytes(rng.integers(32, 127, int(k), dtype=np.uint8))
             for k in rng.integers(1, 64, n)]
    buf = np.zeros((n, 64), np.uint8)
    for i, c in enumerate(cands):
        buf[i, :len(c)] = np.frombuffer(c, np.uint8)
    return cands, buf.view(">u4").astype(np.uint32)


def test_hmac_ops_match_reference():
    """The key states, one PBKDF2 block at 3 iterations (U1 and two
    HMAC rounds) and the salt blocks against the reference; the PMKID
    HMAC against hashlib's hmac."""
    iterations = 3
    rng = np.random.default_rng(1)
    _, kw = _key_blocks(rng, 4)
    ist, ost = hmac_sha1.hmac_key_states(torch.as_tensor(kw.view(np.int32)))
    rist, rost = ref_hmac.hmac_key_states(jnp.asarray(kw))
    assert (_u32(ist) == np.asarray(rist)).all()
    assert (_u32(ost) == np.asarray(rost)).all()
    got = hmac_sha1.pbkdf2_sha1_block(ist, ost, ESSID, 2, iterations)
    with jax.disable_jit():
        want = ref_hmac.pbkdf2_sha1_block(rist, rost, ESSID, 2, iterations)
    assert (_u32(got) == np.asarray(want)).all()
    for essid in (b"a", ESSID, b"x" * 32, b"y" * 51):
        for i in (1, 2):
            assert (hmac_sha1.salt_block(essid, i)
                    == ref_hmac.salt_block(essid, i)).all()
    with pytest.raises(ValueError):
        hmac_sha1.salt_block(b"z" * 52, 1)
    pmk = rng.integers(0, 2 ** 32, (2, 8), dtype=np.uint64).astype(np.uint32)
    got = hmac_sha1.pmkid_from_pmk(torch.as_tensor(pmk.view(np.int32)), AP,
                                   STA)
    for row, key in zip(_u32(got), pmk):
        want = hmac.new(key.astype(">u4").tobytes(), b"PMK Name" + AP + STA,
                        hashlib.sha1).digest()[:16]
        assert row.astype(">u4").tobytes() == want


@pytest.mark.parametrize("password,salt,iterations,dk", [
    (b"password", b"salt", 1, "0c60c80f961f0e71f3a9b524af6012062fe037a6"),
    (b"password", b"salt", 2, "ea6c014dc72d6f8ccd1ed92ace1d41f0d8de8957"),
])
def test_pbkdf2_rfc6070_and_hashlib(password, salt, iterations, dk):
    """RFC 6070's vectors (20-byte DK = T1), and the 32-byte PMK against
    hashlib for random passphrases."""
    buf = np.zeros((1, 64), np.uint8)
    buf[0, :len(password)] = np.frombuffer(password, np.uint8)
    key = torch.as_tensor(buf.view(">u4").astype(np.uint32).view(np.int32))
    pmk = hmac_sha1.pbkdf2_sha1_pmk(key, salt, iterations)
    raw = _u32(pmk).astype(">u4").tobytes()
    assert raw[:20].hex() == dk
    assert raw == hashlib.pbkdf2_hmac("sha1", password, salt, iterations, 32)
    rng = np.random.default_rng(iterations)
    cands, kw = _key_blocks(rng, 3)
    pmk = hmac_sha1.pbkdf2_sha1_pmk(torch.as_tensor(kw.view(np.int32)),
                                    ESSID, iterations)
    for c, row in zip(cands, _u32(pmk)):
        assert row.astype(">u4").tobytes() == \
            hashlib.pbkdf2_hmac("sha1", c, ESSID, iterations, 32)


def test_plain_step_matches_pmkid_lanes():
    """The plain step finds exactly the lanes whose PMKID the reference
    kernel's lane function gives for a target, over lanes of a mask from
    a random base, at 1 iteration (the iteration loop is held to the
    reference above); a planted lane past n_valid does not count.  (Four
    lanes: the reference runs op by op here.)"""
    iters, batch = 1, 4
    ref_gen, gen = RefMaskGenerator("?d?l?u?s"), MaskGenerator("?d?l?u?s")
    start = 123457
    cands = [ref_gen.candidate(start + i) for i in range(batch)]
    byts = [jnp.asarray(np.array([c[p] for c in cands], np.uint32))
            for p in range(gen.length)]
    msg = [int(x) for x in np.frombuffer(b"PMK Name" + AP + STA, ">u4")]
    with jax.disable_jit():
        out = pmkid_lanes(byts, list(ESSID), len(ESSID), msg,
                          jnp.int32(iters), (batch,))
    words = np.stack([np.asarray(w) for w in out], axis=1)
    eng = get_engine("wpa2-pmkid")
    plants = [0, 2, 3]
    lines = [f"{words[i].astype('>u4').tobytes().hex()}*{AP.hex()}*"
             f"{STA.hex()}*{ESSID.hex()}" for i in plants]
    assert lines[1] == _line(cands[2], ESSID, AP, STA, iters)
    table = cuda_pbkdf2.target_table([eng.parse_target(ln) for ln in lines],
                                     "cpu")
    count, lanes, tidx = cuda_pbkdf2.pmkid_plain(
        gen.charset_lut(), gen.radices, gen.digits(start), batch - 1, ESSID,
        iters, table, 8, batch)
    hits = sorted((a, b) for a, b in zip(lanes.tolist(), tidx.tolist())
                  if a >= 0)
    assert int(count) == 2 and hits == [(0, 0), (2, 1)]    # lane 3 invalid


@pytest.fixture
def low_iterations(monkeypatch):
    monkeypatch.setattr(Pmkid2Engine, "iterations", 2)
    monkeypatch.setattr(RefPmkid2Engine, "iterations", 2)
    return 2


def test_worker_on_cpu_tensors_finds_planted(low_iterations):
    """First, last and a random index; two targets of one ESSID; one
    lane that matches two targets; a second ESSID; hit capacity 1 with
    two hits in a batch sends it to the oracle rescan."""
    gen = MaskGenerator("?l?d")
    last, rnd = gen.keyspace - 1, 123
    other = (bytes(range(6)), bytes(range(6, 12)))
    spec = [(0, ESSID, AP, STA), (last, ESSID, AP, STA),
            (rnd, ESSID, *other), (rnd, ESSID, AP, STA),
            (rnd, b"OtherNet", AP, STA), (last, b"OtherNet", *other)]
    eng = get_engine("wpa2-pmkid")
    targets = [eng.parse_target(_line(gen.candidate(i), e, a, s,
                                      low_iterations))
               for i, e, a, s in spec]
    want = sorted((i, ti) for ti, (i, *_) in enumerate(spec))
    for cap in (64, 1):
        dev = get_engine("wpa2-pmkid", "cuda", torch_device="cpu")
        w = dev.make_mask_worker(gen, targets, batch=2048, hit_capacity=cap,
                                 oracle=eng)
        hits = w.process(WorkUnit(0, 0, gen.keyspace))
        assert sorted((h.cand_index, h.target_index) for h in hits) == want
        assert all(h.plaintext == gen.candidate(h.cand_index) for h in hits)
        assert w.dispatched == 2                # one batch per ESSID


def _crack(tmp_path, capsys, device, lines, extra=(), mask="?l?l"):
    hashfile = tmp_path / "h.txt"
    hashfile.write_text("\n".join(lines) + "\n")
    pot = tmp_path / f"{device}.pot"
    rc = cli.main(["crack", mask, str(hashfile), "--engine", "wpa2-pmkid",
                   "--device", device, "--potfile", str(pot), *extra])
    out, err = capsys.readouterr()
    return rc, sorted(out.splitlines()), sorted(
        pot.read_text().splitlines()), err


def test_cli_torch_cpu_matches_cpu(tmp_path, capsys, low_iterations):
    gen = MaskGenerator("?l?l")
    lines = [_line(gen.candidate(i), ESSID, AP, STA, low_iterations)
             for i in (0, 675)] + \
        [_line(b"zz", b"OtherNet", AP, STA, low_iterations),
         _line(b"toolong", ESSID, AP, STA, low_iterations)]
    got = _crack(tmp_path, capsys, "torch-cpu", lines, ["--batch", "512"])
    want = _crack(tmp_path, capsys, "cpu", lines)
    assert got[:3] == want[:3]
    assert got[0] == 0 and len(got[1]) == 3
    assert "rejected=0" in got[3]


def test_unit_follows_the_workers_batch(tmp_path, capsys, low_iterations,
                                        monkeypatch):
    """The engine caps its batch; the unit is UNIT_BATCHES of the
    worker's batch, not of --batch."""
    from dprf_tpu_torch.engines.device import pmkid
    monkeypatch.setattr(pmkid, "BATCH", 128)
    line = _line(b"q", ESSID, AP, STA, low_iterations)
    rc, out, _, err = _crack(tmp_path, capsys, "torch-cpu", [line],
                             ["--batch", str(1 << 24)], mask="?l")
    assert rc == 0 and out == [f"{line}:q"]
    assert f"batch=128 unit_size={cli.UNIT_BATCHES * 128}" in err


def test_eligibility_and_refusals():
    gen = MaskGenerator("?l" * 63)
    assert cuda_pbkdf2.pmkid_kernel_eligible(gen, [1, 32])
    assert not cuda_pbkdf2.pmkid_kernel_eligible(gen, [33])
    assert not cuda_pbkdf2.pmkid_kernel_eligible(gen, [0])
    assert not cuda_pbkdf2.pmkid_kernel_eligible(MaskGenerator("?l" * 64),
                                                 [8])
    eng = get_engine("pmkid")
    t = eng.parse_target(_line(b"x", b"e" * 33, AP, STA, 1))
    dev = get_engine("pmkid", "cuda", torch_device="cpu")
    with pytest.raises(ValueError, match="--device cpu"):
        dev.make_mask_worker(MaskGenerator("?l"), [t], 64, 8)
    with pytest.raises(ValueError, match="--device cpu"):
        dev.make_wordlist_worker(None, [t], 64, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_pbkdf2.pmkid_kernel(
            MaskGenerator("?l").charset_lut(), (26,), [0], 1, ESSID, 2,
            cuda_pbkdf2.target_table([t], "cpu"), 4, 8)
