"""Kerberos etype 23 (krb5tgs 13100 / krb5asrep 18200) in the port
(ops/rc4.py, ops/hmac_md5.py, engines/cpu/krb5.py, ops/cuda_krb5.py,
engines/device/krb5.py) against the reference (dprf_tpu's RC4, HMAC
helpers, DER filter, filter batch, XLA mask step, kernel arguments,
oracle and CLI) on the same inputs made from seeds.  Exact equality
throughout: all of it is integer arithmetic.

On the CPU the worker's step runs the kernel's plain PyTorch version,
because its tensors lie on the CPU (what ``--device torch-cpu`` runs);
tests/test_torch_cuda.py holds the CUDA kernel against it on a card.
The reference's own tests hold its XLA step equal to its Pallas kernel,
so no interpret mode runs here.
"""

import hmac
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dprf_tpu.cli import main as ref_main
from dprf_tpu.engines import engine_names as ref_engine_names
from dprf_tpu.engines.cpu import krb5 as ref_krb5
from dprf_tpu.engines.device import krb5 as ref_dkrb5
from dprf_tpu.engines.device.netntlmv2 import (_hmac_md5_const_msg,
                                               hmac_msg_blocks)
from dprf_tpu.generators.mask import MaskGenerator as RefMaskGenerator
from dprf_tpu.ops import pallas_krb5
from dprf_tpu.ops.rc4 import rc4_keystream_words as ref_rc4_words
from dprf_tpu_torch.cli import main as port_main
from dprf_tpu_torch.engines import engine_names, get_engine
from dprf_tpu_torch.engines.cpu.krb5 import (ASREP_MSG_TYPE, TGS_MSG_TYPE,
                                             der, encrypt, krb5_rc4_checksum,
                                             parse_krb5asrep, parse_krb5tgs,
                                             rc4)
from dprf_tpu_torch.engines.device.krb5 import der_filter_words
from dprf_tpu_torch.generators.mask import MaskGenerator
from dprf_tpu_torch.ops import cuda_krb5, hmac_md5
from dprf_tpu_torch.ops.rc4 import (rc4_keystream_words,
                                    rc4_keystream_words_reference)
from dprf_tpu_torch.runtime.workunit import WorkUnit

pytestmark = pytest.mark.smoke

#: the 11 names of slice F2
SLICE_NAMES = {"krb5tgs", "krb5asrep", "krb5tgs17", "krb5tgs18",
               "krb5tgs-aes", "krb5pa17", "krb5pa18", "krb5pa",
               "krb5asrep17", "krb5asrep18", "krb5asrep-aes"}


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _ticket(password: bytes, msg_type: int, body_len: int, tag: int,
            seed: int = 0):
    """A valid (checksum, edata2, plaintext): RFC 4757 run forward over
    an 8-byte confounder and a DER ticket, as a KDC makes one."""
    rng = random.Random(seed * 1000 + body_len)
    body = bytes(rng.randrange(256) for _ in range(body_len))
    plain = bytes(rng.randrange(256) for _ in range(8)) + \
        der(tag, der(0x30, body))
    return (*encrypt(password, msg_type, plain), plain)


def _tgs(password: bytes, body_len: int = 60, seed: int = 0) -> str:
    chk, edata, _ = _ticket(password, TGS_MSG_TYPE, body_len, 0x63, seed)
    return f"$krb5tgs$23$*svc$EX.COM$http/web*${chk.hex()}${edata.hex()}"


def _asrep(password: bytes, body_len: int = 60, seed: int = 0,
           tag: int = 0x79) -> str:
    chk, edata, _ = _ticket(password, ASREP_MSG_TYPE, body_len, tag, seed)
    return f"$krb5asrep$23$user@EX.COM:{chk.hex()}${edata.hex()}"


def test_rc4_vectors_and_reference():
    """The published vectors, then the keystream words of random keys
    against the reference's batch RC4 and its scalar oracle."""
    assert rc4(b"Key", b"Plaintext").hex() == "bbf316e8d940af0ad3"
    key = bytes.fromhex("0102030405060708090a0b0c0d0e0f10")
    assert rc4(key, bytes(16)).hex() == "9ac7cc9a609d1ef7b2932899cde41b97"
    rng = np.random.default_rng(3)
    key4 = rng.integers(0, 2 ** 32, (6, 4), dtype=np.uint64).astype(np.uint32)
    got = _u32(rc4_keystream_words(torch.as_tensor(key4.view(np.int32)), 3))
    assert (got == np.asarray(ref_rc4_words(jnp.asarray(key4), 3))).all()
    for row, k in zip(got, key4):
        assert list(row) == rc4_keystream_words_reference(k.tobytes(), 3)


def test_hmac_md5_matches_reference_and_hmac():
    rng = np.random.default_rng(4)
    key4 = rng.integers(0, 2 ** 32, (3, 4), dtype=np.uint64).astype(np.uint32)
    keys = torch.as_tensor(key4.view(np.int32))
    for msg in (TGS_MSG_TYPE.to_bytes(4, "little"), bytes(range(16))):
        blocks, n = hmac_msg_blocks(msg, 1)
        mine, mine_n = hmac_md5.hmac_msg_blocks(msg, 1)
        assert n == mine_n and (mine == np.asarray(blocks)).all()
        ref = np.asarray(_hmac_md5_const_msg(jnp.asarray(key4),
                                             jnp.asarray(blocks), n))
        const = _u32(hmac_md5.hmac_md5_const_msg(keys, mine, n))
        short = _u32(hmac_md5.hmac_md5(keys, np.frombuffer(msg, "<u4"),
                                       len(msg)))
        assert (const == ref).all() and (short == ref).all()
        for row, k in zip(const, key4):
            assert row.tobytes() == hmac.new(k.tobytes(), msg,
                                             "md5").digest()
    with pytest.raises(ValueError):
        hmac_md5.hmac_msg_blocks(bytes(60), 1)


def test_oracle_and_parsing_match_reference():
    line = _tgs(b"Winter2024", 300)
    chk, edata = parse_krb5tgs(line)
    assert (chk, edata) == ref_krb5.parse_krb5tgs(line)
    assert krb5_rc4_checksum(b"Winter2024", TGS_MSG_TYPE, chk, edata) == chk
    assert krb5_rc4_checksum(b"Winter2024", TGS_MSG_TYPE, chk, edata) == \
        ref_krb5.krb5_rc4_checksum(b"Winter2024", TGS_MSG_TYPE, chk, edata)
    bare = f"$krb5tgs$23${chk.hex()}${edata.hex()}"
    assert parse_krb5tgs(bare) == (chk, edata)
    chk2, edata2, _ = _ticket(b"x", ASREP_MSG_TYPE, 80, 0x79)
    digit = bytes.fromhex("12" * 16)
    for text in (f"$krb5asrep$23${chk2.hex()}${edata2.hex()}",
                 f"$krb5asrep${digit.hex()}${edata2.hex()}",
                 _asrep(b"y")):
        assert parse_krb5asrep(text) == ref_krb5.parse_krb5asrep(text)
    for bad in ("$krb5tgs$18$aes$00", "not-a-line",
                f"$krb5tgs$23$*open${chk.hex()}${edata.hex()}",
                f"$krb5tgs$23${chk.hex()}${edata[:20].hex()}",
                f"$krb5asrep$17$u@R:{chk2.hex()}${edata2.hex()}"):
        parse = parse_krb5asrep if "asrep" in bad else parse_krb5tgs
        ref = ref_krb5.parse_krb5asrep if "asrep" in bad \
            else ref_krb5.parse_krb5tgs
        with pytest.raises(ValueError):
            ref(bad)
        with pytest.raises(ValueError):
            parse(bad)
    for name in ("krb5tgs", "krb5asrep"):
        eng, ref = get_engine(name), ref_krb5.Krb5TgsEngine() \
            if name == "krb5tgs" else ref_krb5.Krb5AsRepEngine()
        text = _tgs(b"pw") if name == "krb5tgs" else _asrep(b"pw")
        t, rt = eng.parse_target(text), ref.parse_target(text)
        assert (t.raw, t.digest, t.params) == (rt.raw, rt.digest, rt.params)
        assert eng.verify(b"pw", t) and not eng.verify(b"pX", t)


@pytest.mark.parametrize("body_len", [20, 60, 124, 125, 180, 252, 253,
                                      400, 65530, 70_000])
def test_der_filter_words_every_form(body_len):
    """Every DER length form (and its edges) for TGS, AS-REP 0x79 and
    AS-REP 0x7A: the reference's words, and the true plaintext matches."""
    for msg_type, tag in ((TGS_MSG_TYPE, 0x63), (ASREP_MSG_TYPE, 0x79),
                          (ASREP_MSG_TYPE, 0x7A)):
        _, edata, plain = _ticket(b"pw", msg_type, body_len, tag)
        got = der_filter_words(len(edata), msg_type)
        assert got == ref_dkrb5.der_filter_words(len(edata), msg_type)
        expected, mask = got
        assert int.from_bytes(plain[8:12], "little") & mask == expected
    with pytest.raises(ValueError, match="--device cpu"):
        der_filter_words(8 + (1 << 24) + 6, TGS_MSG_TYPE)


def test_kernel_args_match_target_scalars_and_targs():
    """Each ticket's launch parameters against the reference kernel's
    ``target_scalars`` and the reference step's ``_targs``."""
    ref_eng = ref_krb5.Krb5AsRepEngine()
    for text in (_tgs(b"a", 300), _asrep(b"b", 180, tag=0x7A)):
        t = get_engine(text[1:text.index("$", 1)]).parse_target(text)
        tgt = cuda_krb5.target_kernel_args(t)
        rt = (ref_krb5.Krb5TgsEngine() if "tgs" in text
              else ref_eng).parse_target(text)
        type_w, chk, cipher, mask, expected = (
            np.asarray(x).view(np.uint32)
            for x in pallas_krb5.target_scalars(rt))
        assert [tgt.msg_type, tgt.cipher, tgt.mask, tgt.expected] == \
            [int(type_w[0]), int(cipher[0]), int(mask[0]), int(expected[0])]
        assert np.frombuffer(tgt.checksum, "<u4").tolist() == chk.tolist()
        tw, tn, cw, cn, c4, mk, ex = ref_dkrb5._targs([rt])[0]
        assert (int(c4[0]), int(mk[0]), int(ex[0])) == \
            (tgt.cipher, tgt.mask, tgt.expected)
        mine_t = hmac_md5.hmac_msg_blocks(tgt.msg_type.to_bytes(4, "little"),
                                          1)
        mine_c = hmac_md5.hmac_msg_blocks(tgt.checksum, 1)
        assert (mine_t[0] == np.asarray(tw)).all() and mine_t[1] == int(tn)
        assert (mine_c[0] == np.asarray(cw)).all() and mine_c[1] == int(cn)


def test_filter_batch_and_step_match_reference():
    """The plain filter against the reference's ``krb5_filter_batch`` on
    seeded candidates; the plain grouped step against
    ``make_krb5_mask_step`` over one batch with a planted hit (count and
    lanes), the ticket a group of one."""
    rng = np.random.default_rng(5)
    cand = rng.integers(32, 127, (16, 9), dtype=np.uint8)
    lens = rng.integers(1, 10, 16).astype(np.int32)
    cand[np.arange(9)[None, :] >= lens[:, None]] = 0
    rt = ref_krb5.Krb5TgsEngine().parse_target(_tgs(b"q", 300))
    tw, tn, cw, cn, c4, mk, ex = ref_dkrb5._targs([rt])[0]
    want = np.asarray(ref_dkrb5.krb5_filter_batch(
        jnp.asarray(cand), jnp.asarray(lens), tw, tn, cw, cn, c4, mk))
    got = cuda_krb5.krb5_filter_batch(
        torch.as_tensor(cand), torch.as_tensor(lens), np.asarray(tw),
        int(tn), np.asarray(cw), int(cn), int(c4[0]), int(mk[0]))
    assert (_u32(got) == want).all()

    gen, rgen = MaskGenerator("?l?d?d"), RefMaskGenerator("?l?d?d")
    batch, start, plant = 64, 1024, 1024 + 37
    rt = ref_krb5.Krb5AsRepEngine().parse_target(
        _asrep(gen.candidate(plant), 180))
    ref_step = ref_dkrb5.make_krb5_mask_step(rgen, batch, 8)
    r_count, r_lanes, _ = ref_step(
        jnp.asarray(rgen.digits(start), jnp.int32), jnp.int32(batch - 3),
        *ref_dkrb5._targs([rt])[0])
    step = cuda_krb5.make_krb5_step(gen, [cuda_krb5.target_kernel_args(rt)],
                                    batch, 8, device="cpu")
    count, lanes, tpos, tcount = step(gen.digits(start), batch - 3)
    assert int(count[0]) == int(r_count) == int(tcount[0]) == 1
    assert sorted(x for x in lanes.tolist() if x >= 0) == \
        sorted(int(x) for x in np.asarray(r_lanes) if x >= 0) == [37]
    assert [x for x in tpos.tolist() if x >= 0] == [0]


def test_worker_finds_planted_and_rescans_overflow():
    """Targets at the first, the last and a middle index, TGS and
    AS-REP; hit capacity 0 sends each hit batch to the oracle rescan."""
    gen = MaskGenerator("?d?d?l")
    last = gen.keyspace - 1
    tgs, asrep = get_engine("krb5tgs"), get_engine("krb5asrep")
    for eng, make in ((tgs, _tgs), (asrep, _asrep)):
        targets = [eng.parse_target(make(gen.candidate(i), 60 + i % 3, i))
                   for i in (0, last, 1517)]
        for cap in (8, 0):
            dev = get_engine(eng.name, "cuda", torch_device="cpu")
            w = dev.make_mask_worker(gen, targets, batch=1000,
                                     hit_capacity=cap, oracle=eng)
            hits = w.process(WorkUnit(0, 0, gen.keyspace))
            assert [(h.target_index, h.cand_index) for h in hits] == \
                sorted([(0, 0), (2, 1517), (1, last)],
                       key=lambda x: (x[1], x[0]))
            assert all(h.plaintext == gen.candidate(h.cand_index)
                       for h in hits)
            # the three tickets of one msg_type are one group: one
            # launch a batch
            assert len(w.groups) == 1
            assert w.dispatched == 3 and w.n_maybe() == 0


def test_maybes_are_confirmed_and_counted(monkeypatch):
    """A prefilter that passes every lane: the oracle drops each false
    lane and counts it; only the planted candidate becomes a hit."""
    gen = MaskGenerator("?d?d")
    eng = get_engine("krb5tgs")
    t = eng.parse_target(_tgs(gen.candidate(42)))
    dev = get_engine("krb5tgs", "cuda", torch_device="cpu")
    w = dev.make_mask_worker(gen, [t], batch=100, hit_capacity=100,
                             oracle=eng)

    def always(base_digits, n_valid):
        return (torch.tensor([n_valid], dtype=torch.int32),
                torch.arange(100, dtype=torch.int32),
                torch.zeros(100, dtype=torch.int32),
                torch.tensor([n_valid], dtype=torch.int32))

    monkeypatch.setattr(w, "groups", [(w.groups[0][0], always)])
    hits = w.process(WorkUnit(0, 0, 100))
    assert [(h.cand_index, h.plaintext) for h in hits] == [(42, b"42")]
    assert w.n_maybe() == 99 and w.rejected_maybes == 99


def _crack(main, device, tmp_path, capsys, engine, lines, mask="?d?d?d",
           extra=()):
    hashfile = tmp_path / "h.txt"
    hashfile.write_text("\n".join(lines) + "\n")
    pot = tmp_path / f"{device}.pot"
    rc = main(["crack", mask, str(hashfile), "--engine", engine,
               "--device", device, "--potfile", str(pot), *extra])
    out, err = capsys.readouterr()
    pots = sorted(pot.read_text().splitlines()) if pot.exists() else []
    return rc, sorted(out.splitlines()), pots, err


@pytest.mark.parametrize("engine", ["krb5tgs", "krb5asrep"])
def test_cli_matches_reference_cli(engine, tmp_path, capsys):
    """crack --device torch-cpu (the port) against the reference's crack
    --device cpu on the same hash file: the same found lines and
    potfile; the port's summary counts its maybes."""
    make = _tgs if engine == "krb5tgs" else _asrep
    lines = [make(b"007", 60, 1), make(b"420", 61, 2), make(b"999", 62, 3),
             make(b"nope", 63, 4)]
    got = _crack(port_main, "torch-cpu", tmp_path, capsys, engine, lines,
                 extra=["--batch", "512"])
    want = _crack(ref_main, "cpu", tmp_path, capsys, engine, lines,
                  extra=["-q"])
    assert got[:3] == want[:3] and got[0] == 0 and len(got[1]) == 3
    assert "rejected=0" in got[3] and "maybes=0" in got[3]


def test_refusals_name_device_cpu(tmp_path, capsys):
    """A mask past 27 positions exits 2 naming --device cpu; a wordlist
    job runs (the rules kernel's Kerberos tail, its plain version on CPU
    tensors) and finds its plant; the kernel's wrapper refuses CPU
    tensors."""
    line = _tgs(b"x")
    rc, _, _, err = _crack(port_main, "torch-cpu", tmp_path, capsys,
                           "krb5tgs", [line], mask="?d" * 28)
    assert rc == 2 and "--device cpu" in err
    words = tmp_path / "w.txt"
    words.write_text("x\n")
    asrep = _asrep(b"x")
    rc, out, pots, err = _crack(port_main, "torch-cpu", tmp_path, capsys,
                                "krb5asrep", [asrep], mask=str(words),
                                extra=["-a", "wordlist"])
    assert (rc, out, pots) == (0, [f"{asrep}:x"], [f"{asrep}:x"])
    assert "rejected=0" in err and "maybes=0" in err
    gen = MaskGenerator("?l")
    tgt = cuda_krb5.target_kernel_args(get_engine("krb5tgs")
                                       .parse_target(line))
    rows = torch.as_tensor(cuda_krb5.ticket_rows([tgt]).view(np.int32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_krb5.krb5_kernel(gen.charset_lut(), gen.radices, [0], 1,
                              tgt.msg_type, rows, 4, 8)


def test_engine_names_of_the_slice():
    """The same names on cuda and on the port's cpu, the 11 Kerberos
    names among them, every one a name of the reference's device engines
    (the count is the newest slice's test's)."""
    cuda, cpu = set(engine_names("cuda")), set(engine_names("cpu"))
    assert cuda == cpu
    assert SLICE_NAMES <= cuda
    assert cuda <= set(ref_engine_names("jax"))
