"""PDF RC4 (hashcat 10400 / 10500) in the port (engines/cpu/pdf.py,
ops/cuda_pdf.py, engines/device/pdf.py) against the reference (its
oracle and parser, ``pallas_pdf.target_scalars``, the XLA filters
``make_pdf2_filter`` / ``make_pdf3_u`` over ``pdf_key_words``, the CLI)
on the same inputs made from seeds.  Exact equality throughout.

On the CPU the worker's step runs the kernel's plain version, because
its tensors lie on the CPU (what ``--device torch-cpu`` runs);
tests/test_torch_cuda.py holds the CUDA kernel against it on a card.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dprf_tpu.cli import main as ref_main
from dprf_tpu.engines.cpu import pdf as ref_cpu
from dprf_tpu.engines.device import pdf as ref_dev
from dprf_tpu.ops import pallas_pdf
from dprf_tpu_torch.cli import main as port_main
from dprf_tpu_torch.engines import get_engine
from dprf_tpu_torch.engines.cpu.pdf import (make_line, parse_pdf,
                                            pdf_user_check)
from dprf_tpu_torch.generators.mask import MaskGenerator
from dprf_tpu_torch.ops import cuda_pdf
from dprf_tpu_torch.runtime.workunit import WorkUnit

pytestmark = pytest.mark.smoke

#: the four document kinds: (revision, key bits, metadata encrypted)
DOCS = [(2, 40, True), (3, 40, True), (3, 128, True), (4, 128, False)]


def _doc(password: bytes, rev: int, bits: int, meta: bool,
         seed: int = 0) -> str:
    """A $pdf$ line for ``password``: seeded O and ID, U run forward."""
    rng = np.random.default_rng(seed * 10 + rev)
    o = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
    doc_id = bytes(rng.integers(0, 256, 16, dtype=np.uint8))
    return make_line(password, rev, bits, o, -3904, doc_id, meta)


def test_oracle_and_parsing_match_reference():
    """Forward lines of every kind parsed and checked by both oracles;
    the parse errors."""
    eng, ref = get_engine("pdf"), ref_cpu.PdfEngine()
    for rev, bits, meta in DOCS:
        line = _doc(b"s3cret", rev, bits, meta)
        assert parse_pdf(line) == ref_cpu.parse_pdf(line)
        p = parse_pdf(line)
        assert pdf_user_check(b"s3cret", p["o"], p["p"], p["id"], rev,
                              bits // 8, meta) == ref_cpu.pdf_user_check(
            b"s3cret", p["o"], p["p"], p["id"], rev, bits // 8, meta)
        t, rt = eng.parse_target(line), ref.parse_target(line)
        assert (t.raw, t.digest, t.params) == (rt.raw, rt.digest, rt.params)
        assert eng.verify(b"s3cret", t) and ref.verify(b"s3cret", rt)
        assert not eng.verify(b"s3creT", t)
    o = "00" * 32
    for bad in ("$pdf$5*5*256*-4*1*16*" + "00" * 16 + "*48*" + "00" * 48
                + "*48*" + "00" * 48, "$pdf$1*2*128*-4*1*1*00*32*"
                + "00" * 32 + "*32*" + o, "not-a-line"):
        with pytest.raises(ValueError):
            ref_cpu.parse_pdf(bad)
        with pytest.raises(ValueError):
            parse_pdf(bad)


def test_target_args_match_target_scalars():
    """Each document's launch words against the reference kernel's
    ``target_scalars`` marshalling."""
    for rev, bits, meta in DOCS:
        line = _doc(b"x", rev, bits, meta, seed=3)
        kind, tgt = cuda_pdf.target_kernel_args(
            get_engine("pdf").parse_target(line))
        o, b2, x0, u = (np.asarray(a).view(np.uint32).tolist()
                        for a in pallas_pdf.target_scalars(
            ref_cpu.PdfEngine().parse_target(line)))
        assert kind == (2 if rev == 2 else 3, bits // 8)
        assert (list(tgt.o), list(tgt.block2), list(tgt.x0), list(tgt.u)) \
            == (o, b2, x0, u)
        assert list(cuda_pdf.block2_words(parse_pdf(line))) == \
            ref_dev._block2_words(parse_pdf(line)).tolist()


@pytest.mark.parametrize("rev,bits,meta", DOCS)
def test_plain_matches_reference_filters(rev, bits, meta):
    """``pdf_u_words`` on seeded candidates against the reference's XLA
    filter of the kind (R2: its keystream word), then ``pdf_plain`` over
    a partial batch with a planted document: count and lanes."""
    gen = MaskGenerator("?l?d?l?d?d")
    rng = np.random.default_rng(rev * 1000 + bits)
    start = int(rng.integers(0, gen.keyspace - 64))
    plant = start + int(rng.integers(0, 60))
    line = _doc(gen.candidate(plant), rev, bits, meta, seed=5)
    kind, tgt = cuda_pdf.target_kernel_args(get_engine("pdf")
                                            .parse_target(line))
    cand = np.array([list(gen.candidate(start + i)) for i in range(8)],
                    np.uint8)
    got = cuda_pdf.pdf_u_words(kind, torch.as_tensor(cand), tgt).numpy() \
        .view(np.uint32)
    p = ref_cpu.parse_pdf(line)
    rargs, _ = ref_dev._target_args(ref_cpu.PdfEngine().parse_target(line))
    lens = jnp.full((8,), gen.length, jnp.int32)
    if rev == 2:
        want = np.asarray(ref_dev.make_pdf2_filter(5)(
            jnp.asarray(cand), lens, *rargs))
        assert (got[:, 0] == want[:, 0]).all() and not got[:, 1:].any()
    else:
        want = np.asarray(ref_dev.make_pdf3_u(p["key_len"])(
            jnp.asarray(cand), lens, *rargs))
        assert (got == want).all()
    count, lanes = cuda_pdf.pdf_plain(kind, gen.charset_lut(), gen.radices,
                                      gen.digits(start), 61, tgt, 8, 64)
    assert int(count[0]) == 1 and lanes.tolist() == [plant - start] + [-1] * 7


def test_worker_finds_planted_mixed_kinds_and_rescans():
    """A hashlist of every kind, planted at the first, the last and two
    random indices; hit capacity 0 sends a hit batch to the oracle
    rescan."""
    gen = MaskGenerator("?d?d?l")
    rng = np.random.default_rng(9)
    plants = [0, gen.keyspace - 1, *(int(x) for x in
                                     rng.integers(1, gen.keyspace - 1, 2))]
    eng = get_engine("pdf")
    targets = [eng.parse_target(_doc(gen.candidate(i), *d, seed=i))
               for i, d in zip(plants, DOCS)]
    dev = get_engine("pdf", "cuda", torch_device="cpu")
    w = dev.make_mask_worker(gen, targets, batch=1300, hit_capacity=8,
                             oracle=eng)
    hits = w.process(WorkUnit(0, 0, gen.keyspace))
    assert [(h.target_index, h.cand_index) for h in hits] == \
        sorted(((ti, i) for ti, i in enumerate(plants)),
               key=lambda x: (x[1], x[0]))
    assert all(h.plaintext == gen.candidate(h.cand_index) for h in hits)
    assert w.dispatched == 4 * 2 and w.n_maybe() == 0
    w = dev.make_mask_worker(gen, targets[:1], batch=1300, hit_capacity=0,
                             oracle=eng)
    hits = w.process(WorkUnit(0, 0, gen.keyspace))
    assert [(h.target_index, h.cand_index) for h in hits] == [(0, 0)]


def test_maybes_are_confirmed_and_counted(monkeypatch):
    """A step that passes every lane: the oracle drops each false lane
    and counts it; only the planted candidate becomes a hit."""
    gen = MaskGenerator("?d?d")
    eng = get_engine("pdf")
    t = eng.parse_target(_doc(gen.candidate(42), 2, 40, True))
    w = get_engine("pdf", "cuda", torch_device="cpu").make_mask_worker(
        gen, [t], batch=100, hit_capacity=100, oracle=eng)

    def always(base_digits, n_valid):
        return (torch.tensor([n_valid], dtype=torch.int32),
                torch.arange(100, dtype=torch.int32), None)

    monkeypatch.setattr(w, "groups", [([0], always)])
    hits = w.process(WorkUnit(0, 0, 100))
    assert [(h.cand_index, h.plaintext) for h in hits] == [(42, b"42")]
    assert w.n_maybe() == 99


def _tested(err: str) -> int:
    """tested= of a CLI's job summary."""
    return int(re.search(r"job finished .* tested=(\d+)", err).group(1))


def _crack(main, device, tmp_path, capsys, lines, mask, extra=()):
    hashfile = tmp_path / "h.txt"
    hashfile.write_text("\n".join(lines) + "\n")
    pot = tmp_path / f"{device}.pot"
    rc = main(["crack", mask, str(hashfile), "--engine", "pdf", "--device",
               device, "--potfile", str(pot), *extra])
    out, err = capsys.readouterr()
    pots = sorted(pot.read_text().splitlines()) if pot.exists() else []
    return rc, sorted(out.splitlines()), pots, err


def test_cli_matches_reference_cli(tmp_path, capsys):
    """crack --device torch-cpu (the port) against the reference's crack
    --device cpu on a hashlist of every kind and a document no candidate
    opens: the same found lines, potfile and tested count."""
    gen = MaskGenerator("?d?l")
    lines = [_doc(gen.candidate(i), *d, seed=i)
             for i, d in zip((3, 101, 200, 259), DOCS)]
    lines.append(_doc(b"nope", 3, 128, True, seed=7))
    got = _crack(port_main, "torch-cpu", tmp_path, capsys, lines, "?d?l",
                 ["--batch", "512"])
    want = _crack(ref_main, "cpu", tmp_path, capsys, lines, "?d?l")
    assert got[:3] == want[:3] and got[0] == 0 and len(got[1]) == 4
    assert "rejected=0" in got[3] and "maybes=0" in got[3]
    assert _tested(got[3]) == _tested(want[3]) == gen.keyspace


def test_refusals_name_device_cpu(tmp_path, capsys):
    """A wordlist job and a mask past 32 positions exit 2 naming
    --device cpu; the kernel's wrapper refuses CPU tensors and counts no
    launch; the dispatcher checks the kind."""
    line = _doc(b"x", 3, 128, True)
    words = tmp_path / "w.txt"
    words.write_text("x\n")
    rc, _, _, err = _crack(port_main, "torch-cpu", tmp_path, capsys, [line],
                           str(words), ["-a", "wordlist"])
    assert rc == 2 and "--device cpu" in err
    rc, _, _, err = _crack(port_main, "torch-cpu", tmp_path, capsys, [line],
                           "?d" * 33)
    assert rc == 2 and "--device cpu" in err
    gen = MaskGenerator("?l")
    kind, tgt = cuda_pdf.target_kernel_args(get_engine("pdf")
                                            .parse_target(line))
    before = dict(cuda_pdf.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_pdf.pdf_kernel(kind, gen.charset_lut(), gen.radices, [0], 1,
                            tgt, 4, 8)
    assert cuda_pdf.launches == before
    with pytest.raises(ValueError, match="kind"):
        cuda_pdf.pdf_crack((2, 16), gen.charset_lut(), gen.radices, [0], 1,
                           tgt, 4, 8)
