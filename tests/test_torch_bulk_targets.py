"""Bulk target lists on the port, held against the reference on the CPU:
the probe table's bitmap and geometry (targets/probe.py), the bulk
compare's plain version (``cuda_mask.bulk_plain``) against the
reference's ``bloom_maybe`` and ``probe_hits`` on the same digests, the
host-verify degrade, ``TargetStore``'s report and fingerprint, the
hashlist's ingest report, and ``crack --targets-file`` end to end.
Digests are made from a seed with numpy; only plain versions run."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dprf_tpu import get_engine as ref_get_engine
from dprf_tpu.cli import main as ref_main
from dprf_tpu.targets import TargetStore as RefTargetStore
from dprf_tpu.targets import probe as ref_probe
from dprf_tpu.utils.hashlist import parse_lines as ref_parse_lines
from dprf_tpu_torch import get_engine
from dprf_tpu_torch.cli import main as port_main
from dprf_tpu_torch.engines.base import Target
from dprf_tpu_torch.generators.mask import MaskGenerator
from dprf_tpu_torch.ops import compare as cmp_ops
from dprf_tpu_torch.ops import cuda_mask, opcount
from dprf_tpu_torch.runtime.worker import CpuWorker, CudaMaskWorker
from dprf_tpu_torch.runtime.workunit import WorkUnit
from dprf_tpu_torch.targets import TargetStore, probe
from dprf_tpu_torch.utils.hashlist import parse_lines

MASK = "?l?l?l"
#: no cap: the reference's byte budget would read its device stats
NO_CAP = 1 << 40


def _rows(n: int, words: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 1 << 32, (n, words), dtype=np.uint32)


@pytest.mark.parametrize("n", [10 ** 4, 10 ** 5])
def test_probe_table_matches_reference(n):
    """The bitmap, its geometry, k and fp_est equal the reference's
    build_probe_table at the default budget, and sort order and table
    equal its make_target_table's."""
    rows = _rows(n, 4, n)
    rows[7] = rows[3]                      # a duplicate digest
    digests = [r.tobytes() for r in rows]
    got = probe.build_probe_table(digests, max_bytes=NO_CAP)
    want = ref_probe.build_probe_table(digests, max_bytes=NO_CAP)
    assert (got.mode, got.block_bits, got.k, got.nbytes) == \
        (want.mode, want.block_bits, want.k, want.nbytes)
    assert got.fp_est == want.fp_est
    assert (got.bits == np.asarray(want.bits)).all()
    assert (got.order == want.order).all()
    assert (got.table.words == np.asarray(want.table.words)).all()
    assert (cmp_ops.sort_order(rows) == np.lexsort(rows.T[::-1])).all()


@pytest.mark.parametrize("words", [2, 5])
def test_bloom_fill_matches_reference(words):
    """Every layout the cores give (2 words: mysql323; 5: sha1) and a
    small bitmap of one block."""
    rows = _rows(3000, words, words)
    for m_bits, k in ((1 << 15, 8), (512, 3)):
        assert (probe.bloom_fill(rows, m_bits, k)
                == ref_probe.bloom_fill(rows, m_bits, k)).all()


def test_host_verify_degrade_matches_reference():
    """Past max_bytes the table is shed and the bitmap halved: the same
    layout, geometry and bits as the reference's."""
    digests = [r.tobytes() for r in _rows(20000, 4, 9)]
    for budget in (100_000, 5_000):
        got = probe.build_probe_table(digests, max_bytes=budget)
        want = ref_probe.build_probe_table(digests, max_bytes=budget)
        assert got.mode == want.mode == probe.MODE_HOST_VERIFY
        assert got.table is None and want.table is None
        assert (got.block_bits, got.k, got.fp_est, got.nbytes) == \
            (want.block_bits, want.k, want.fp_est, want.nbytes)
        assert (got.bits == np.asarray(want.bits)).all()
    assert probe.byte_budget("cpu") is None


def _plain_digests(engine: str, gen, batch: int):
    eng = get_engine(engine, "cuda", torch_device="cpu")
    lut = gen.charset_lut("cpu")
    return lut, cuda_mask._digest_plain(eng, lut, gen.radices,
                                        gen.digits(0), batch, 0)


@pytest.mark.parametrize("engine", ["md5", "sha1", "sha512", "mysql323"])
def test_bulk_plain_matches_reference_probe_hits(engine):
    """The bulk compare's plain version on ?l?l?d (planted lanes, a
    generous fp budget so false survivors abound; the cores' digest
    layouts: 4 words little-endian, 5 and 16 big-endian, 2): its maybes are the
    reference's bloom_maybe, and its (count, lanes, tpos) the
    reference's probe_hits, in the device layout and the host-verify
    one."""
    gen = MaskGenerator("?l?l?d")
    batch = gen.keyspace
    lut, digest = _plain_digests(engine, gen, batch)
    dig = digest.numpy().view(np.uint32)
    eng = get_engine(engine, "cpu")
    le = get_engine(engine, "cuda", torch_device="cpu").little_endian
    plants = [0, 1, 4000, batch - 1]
    rng = np.random.default_rng(len(engine))
    fillers = rng.integers(0, 1 << 32, (5000, dig.shape[1]), dtype=np.uint32)
    if engine == "mysql323":
        fillers &= np.uint32(0x7FFFFFFF)
    rows = np.concatenate([dig[plants], fillers])
    dt = "<u4" if le else ">u4"
    digests = [r.astype(dt).tobytes() for r in rows]
    assert eng.hash_batch([gen.candidate(4000)])[0] == digests[2]
    valid = np.ones(batch, bool)
    valid[-1] = False                       # the last lane is not valid
    for budget in (NO_CAP, 4096):
        got = probe.build_probe_table(digests, le, fp_budget=0.05,
                                      max_bytes=budget)
        want = ref_probe.build_probe_table(digests, le, fp_budget=0.05,
                                           max_bytes=budget)
        words, block_bits, k, table = cuda_mask.probe_tensors(got, "cpu")
        maybe = cuda_mask.probe_found(digest, words, block_bits, k,
                                      torch.as_tensor(valid))
        ref_maybe = np.asarray(ref_probe.bloom_maybe(jnp.asarray(dig), want))
        assert (maybe.numpy() == (ref_maybe & valid)).all()
        assert 30 < int(maybe.sum()) < batch // 2
        count, lanes, tpos, n_maybe = cuda_mask.bulk_plain(
            get_engine(engine, "cuda", torch_device="cpu"), lut, gen.radices,
            gen.digits(0), batch - 1, words, block_bits, k, table, 4096,
            batch)
        rc, rl, rt = ref_probe.probe_hits(jnp.asarray(dig), want,
                                          jnp.asarray(valid), 4096, 8192)
        ref_pairs = [(int(a), int(b)) for a, b in zip(np.asarray(rl),
                                                      np.asarray(rt))
                     if a >= 0]
        pairs = [(int(a), int(b)) for a, b in zip(lanes, tpos) if a >= 0]
        assert (int(count), pairs) == (int(rc), ref_pairs)
        assert int(n_maybe) == int(maybe.sum())
        if table is None:
            assert int(count) == int(n_maybe) and all(b == -1 for _, b
                                                      in pairs)
        else:
            assert [got.order[b] for _, b in pairs] == [0, 1, 2]


def test_bulk_kernel_wrapper_refuses_cpu_tensors():
    gen = MaskGenerator(MASK)
    pt = probe.build_probe_table([bytes(16)] * 2 + [b"\1" * 16])
    words, block_bits, k, table = cuda_mask.probe_tensors(pt, "cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_mask.mask_bulk_kernel("md5", gen.charset_lut("cpu"),
                                   gen.radices, gen.digits(0), 64, words,
                                   block_bits, k, table, 8, 64)


def _ntlm_lines(n: int, planted, seed: int, extra=()):
    """n NTLM lines: the planted words' digests and random ones, in a
    seeded order, then ``extra`` lines."""
    ntlm = get_engine("ntlm", "cpu")
    rng = np.random.default_rng(seed)
    lines = [d.hex() for d in ntlm.hash_batch(planted)]
    lines += [r.tobytes().hex() for r in rng.integers(
        0, 1 << 32, (n - len(planted), 4), dtype=np.uint32)]
    rng.shuffle(lines)
    return lines + list(extra)


def test_target_store_and_ingest_report_match_reference():
    """The report (targets, duplicates, malformed lines with their
    numbers) and the fingerprint of the same lines, and parse_lines'
    skipped, duplicate and line-number report."""
    lines = _ntlm_lines(3000, [b"abc"], 1, extra=(
        "# comment", "", "zz", "ABCD", "0" * 31 + "g"))
    lines.insert(10, lines[20].upper())     # a duplicate in another case
    lines.insert(5, "12" * 15)              # short
    for name in ("ntlm", "md5"):
        store = TargetStore.from_lines(get_engine(name, "cpu"), lines,
                                       source="list.txt")
        ref = RefTargetStore.from_lines(ref_get_engine(name, "cpu"), lines,
                                        source="list.txt")
        assert store.report() == ref.report()
        assert store.fingerprint == ref.fingerprint
        assert store.lines() == ref.lines()
    got = parse_lines(get_engine("ntlm", "cpu"), lines)
    want = ref_parse_lines(ref_get_engine("ntlm", "cpu"), lines)
    assert (got.skipped, got.duplicates, [t.raw for t in got.targets]) == \
        (want.skipped, want.duplicates, [t.raw for t in want.targets])
    assert got.line_numbers == [lines.index(t.raw) + 1
                                for t in got.targets]


def _crack(main, argv, pot, capsys):
    rc = main(["crack", *argv, "--potfile", str(pot)])
    cap = capsys.readouterr()
    found = sorted(ln for ln in cap.out.splitlines() if ":" in ln)
    return rc, found, sorted(pot.read_text().splitlines()), cap.err


def test_targets_file_matches_reference(tmp_path, capsys):
    """crack --device torch-cpu --targets-file over 10^4 NTLM lines (the
    bulk probe) and ?l?l?l: the reference CLI's --device cpu found set
    and potfile, and its TargetStore fingerprint in the log."""
    planted = [b"abc", b"zzz", b"qrs", b"aaa", b"mmm"]
    lines = _ntlm_lines(10 ** 4, planted, 2, extra=("nothex",))
    path = tmp_path / "ntlm10k.txt"
    path.write_text("\n".join(lines) + "\n")
    argv = [MASK, "--targets-file", str(path), "--engine", "ntlm"]
    want = _crack(ref_main, [*argv, "--device", "cpu"], tmp_path / "r.pot",
                  capsys)
    got = _crack(port_main, [*argv, "--device", "torch-cpu", "--batch",
                             "8192"], tmp_path / "p.pot", capsys)
    assert got[:3] == want[:3]
    assert want[0] == 0 and len(want[1]) == len(planted)
    fingerprint = RefTargetStore.from_lines(ref_get_engine("ntlm", "cpu"),
                                            lines).fingerprint
    assert f"fingerprint={fingerprint}" in got[3]
    assert "mode=device" in got[3] and "rejected=0" in got[3]
    assert "relaunches=0" in got[3]


def test_targets_file_either_or(tmp_path, capsys):
    """A hashfile and --targets-file together, or neither, exit 2 as the
    reference does."""
    path = tmp_path / "h.txt"
    path.write_text(hashlib.md5(b"abc").hexdigest() + "\n")
    for argv, msg in (([MASK, str(path), "--targets-file", str(path)],
                       "not both"), ([MASK], "no target hashes")):
        for main in (port_main, ref_main):
            rc = main(["crack", *argv, "--engine", "md5", "--device", "cpu",
                       "--no-potfile"])
            assert rc == 2 and msg in capsys.readouterr().err


def test_bulk_list_on_several_devices_is_refused(tmp_path, capsys):
    """A bulk list runs on one card: --devices 2 exits 2 naming
    --devices 1."""
    path = tmp_path / "h.txt"
    path.write_text("\n".join(_ntlm_lines(8193, [b"abc"], 3)) + "\n")
    rc = port_main(["crack", MASK, "--targets-file", str(path), "--engine",
                    "ntlm", "--device", "torch-cpu", "--devices", "2",
                    "--no-potfile"])
    err = capsys.readouterr().err
    assert rc == 2 and "--devices 1" in err


def test_host_verify_worker_confirms_survivors(monkeypatch):
    """A worker whose probe table degrades (the byte budget forced
    small): every survivor comes back at tpos -1, the oracle confirms
    the real hits and drops the false ones, and the found set is the
    oracle's; an overflowing batch is relaunched, not rescanned."""
    gen = MaskGenerator(MASK)
    planted = [b"abc", b"zzz", b"mno"]
    md5 = get_engine("md5", "cpu")
    rng = np.random.default_rng(4)
    targets = [md5.parse_target(d.hex()) for d in md5.hash_batch(planted)]
    targets += [Target(r.tobytes().hex(), r.tobytes()) for r in
                rng.integers(0, 1 << 32, (5000, 4), dtype=np.uint32)]
    monkeypatch.setattr(probe, "byte_budget", lambda device=None: 9000)
    w = CudaMaskWorker(get_engine("md5", "cuda", torch_device="cpu"), gen,
                       targets, batch=4096, hit_capacity=8, oracle=md5,
                       device="cpu")
    assert w.probe_table.mode == probe.MODE_HOST_VERIFY
    unit = WorkUnit(0, 0, gen.keyspace)
    hits = sorted((h.cand_index, h.target_index, h.plaintext)
                  for h in w.process(unit))
    want = sorted((h.cand_index, h.target_index, h.plaintext)
                  for h in CpuWorker(md5, gen, targets).process(unit))
    assert hits == want and len(hits) == 3
    assert w.n_maybe() == len(hits) + w.rejected_survivors
    assert w.rejected_survivors > 8 and w.relaunches > 0
    assert w.rescans == 0


def test_bulk_ops_and_bytes():
    """The bulk compare's bound counts as the probe's; its bytes are the
    bitmap and, but in the host-verify layout, the table."""
    assert opcount.bulk_ops("ntlm", 7, 0.2, 8, 1e-4, 10 ** 6) == \
        opcount.probe_ops("ntlm", 7, 0.2, 8, 1e-4, 10 ** 6)
    assert opcount.bulk_bytes(10 ** 6, 4, 16) == 64 * 2 ** 16 + 16 * 10 ** 6
    assert opcount.bulk_bytes(10 ** 6, 4, 16, host_verify=True) == \
        64 * 2 ** 16
