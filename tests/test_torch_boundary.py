"""The port's boundaries: it imports neither jax nor anything of
dprf_tpu; ``--device cuda`` without a card fails; the CUDA kernels'
wrappers refuse CPU tensors."""

import os
import subprocess
import sys

import pytest
import torch

from dprf_tpu_torch import cli
from dprf_tpu_torch.generators.mask import MaskGenerator
from dprf_tpu_torch.ops import cuda_mask, cuda_rules

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["dprf_tpu"] = None
import dprf_tpu_torch
names = ["dprf_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(dprf_tpu_torch.__path__,
                                          "dprf_tpu_torch.")
    if not m.name.endswith(".__main__")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
bad = sorted(n for n, m in sys.modules.items() if m is not None
             and n.split(".")[0] in ("jax", "dprf_tpu"))
slices = {"dprf_tpu_torch.ops.hmac_sha1", "dprf_tpu_torch.ops.blowfish",
          "dprf_tpu_torch.ops.cuda_pbkdf2", "dprf_tpu_torch.ops.cuda_bcrypt",
          "dprf_tpu_torch.engines.cpu.bcrypt",
          "dprf_tpu_torch.engines.device.pmkid",
          "dprf_tpu_torch.engines.device.bcrypt",
          "dprf_tpu_torch.ops.cuda_ext",
          "dprf_tpu_torch.engines.device.nested",
          "dprf_tpu_torch.engines.device.salted",
          "dprf_tpu_torch.ops.sha512", "dprf_tpu_torch.ops.keccak",
          "dprf_tpu_torch.ops.cuda_keccak",
          "dprf_tpu_torch.engines.device.sha3",
          "dprf_tpu_torch.tools.bench_word64",
          "dprf_tpu_torch.ops.cuda_7z", "dprf_tpu_torch.ops.cuda_pdf",
          "dprf_tpu_torch.engines.cpu.sevenzip",
          "dprf_tpu_torch.engines.cpu.pdf",
          "dprf_tpu_torch.engines.device.sevenzip",
          "dprf_tpu_torch.engines.device.pdf",
          "dprf_tpu_torch.targets.probe", "dprf_tpu_torch.ops.superstep",
          "dprf_tpu_torch.targets.store",
          "dprf_tpu_torch.tools.bench_ingest",
          "dprf_tpu_torch.parallel", "dprf_tpu_torch.parallel.mesh",
          "dprf_tpu_torch.parallel.sharded",
          "dprf_tpu_torch.parallel.worker"}
print(len(names), sorted(slices - set(names)), bad)
"""


def test_port_imports_without_jax_or_reference():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    n, rest = proc.stdout.split(" ", 1)
    assert int(n) >= 30 and rest.strip() == "[] []", proc.stdout


def test_device_cuda_without_card_fails(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hashfile = tmp_path / "h.txt"
    hashfile.write_text("5f4dcc3b5aa765d61d8327deb882cf99\n")
    pmkid = tmp_path / "pmkid.txt"
    pmkid.write_text("00" * 16 + "*" + "0a" * 6 + "*" + "a0" * 6 + "*"
                     + b"net".hex() + "\n")
    salted = tmp_path / "salted.txt"
    salted.write_text("5f4dcc3b5aa765d61d8327deb882cf99:salt\n")
    bcrypt = tmp_path / "bcrypt.txt"
    bcrypt.write_text("$2a$05$CCCCCCCCCCCCCCCCCCCCC.E5YPO9kmyuRGyh0XouQYb4YMJ"
                      "KvyOeW\n")
    for argv in (["crack", "?l?l", str(hashfile), "--engine", "md5",
                  "--no-potfile"],
                 ["crack", "?l?l", str(hashfile), "--engine", "md5",
                  "--device", "cuda", "--no-potfile"],
                 ["crack", "?l?l", str(pmkid), "--engine", "wpa2-pmkid",
                  "--no-potfile"],
                 ["crack", "?l?l", str(bcrypt), "--engine", "bcrypt",
                  "--no-potfile"],
                 ["crack", "?l?l", str(hashfile), "--engine", "md5(md5)",
                  "--no-potfile"],
                 ["crack", "?l?l", str(salted), "--engine", "md5-ps",
                  "--no-potfile"],
                 ["crack", "?l?l", str(hashfile), "--engine", "sha512",
                  "--no-potfile"],
                 ["crack", "?l?l", str(hashfile), "--engine", "keccak-256",
                  "--no-potfile"],
                 ["bench", "--mask", "?l?l", "--seconds", "0.1"]):
        assert cli.main(argv) == 2
        captured = capsys.readouterr()
        assert "--device cuda needs an NVIDIA card" in captured.err
        assert captured.out == ""


def test_kernel_wrapper_refuses_cpu_tensors():
    gen = MaskGenerator("?l?l?l")
    launches = dict(cuda_mask.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_mask.mask_kernel("md5", gen.charset_lut("cpu"), gen.radices,
                              gen.digits(0), 64, [0, 0, 0, 0], 4, 64)
    words = torch.zeros((1, 4), dtype=torch.int32)
    rows = torch.zeros((8, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_mask.mask_multi_kernel("ntlm", gen.charset_lut("cpu"),
                                    gen.radices, gen.digits(0), 64, rows,
                                    words, 4, 64)
    assert cuda_mask.launches == launches


def test_slice_f1_kernels_refuse_cpu_tensors():
    """The sha512/384 and Keccak wrappers launch on CUDA tensors only
    and count no launch otherwise; the dispatchers take the plain
    version for CPU tensors and check the job."""
    from dprf_tpu_torch.ops import cuda_keccak
    gen = MaskGenerator("?l?l?l")
    lut = gen.charset_lut("cpu")
    launches = (dict(cuda_mask.launches), dict(cuda_keccak.launches))
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_mask.mask_kernel("sha512", lut, gen.radices, gen.digits(0), 64,
                              [0] * 16, 4, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_keccak.keccak_mask_kernel("sha3-224", lut, gen.radices,
                                       gen.digits(0), 64, [0] * 7, 4, 64)
    words = torch.zeros((1, 8), dtype=torch.int32)
    rows = torch.zeros((8, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_keccak.keccak_mask_multi_kernel("keccak256", lut, gen.radices,
                                             gen.digits(0), 64, rows, words,
                                             4, 64)
    assert (cuda_mask.launches, cuda_keccak.launches) == launches
    count, lanes = cuda_keccak.keccak_crack("sha3", lut, gen.radices,
                                            gen.digits(0), 64, [0] * 8, 4,
                                            64)
    assert int(count) == 0 and lanes.tolist() == [-1] * 4
    for bad in ([0] * 7, [0] * 9):
        with pytest.raises(ValueError, match="target words"):
            cuda_keccak.keccak_crack("sha3-256", lut, gen.radices,
                                     gen.digits(0), 64, bad, 4, 64)
    with pytest.raises(ValueError):
        cuda_keccak.keccak_crack("sha512", lut, gen.radices, gen.digits(0),
                                 64, [0] * 16, 4, 64)


def test_rules_kernel_refuses_cpu_tensors():
    from dprf_tpu_torch.rules import load_rules
    words = torch.zeros((64, 55), dtype=torch.uint8)
    lens = torch.full((64,), 8, dtype=torch.int32)
    bytecode, n_ops = cuda_rules.rule_tables(load_rules("best64"))
    launches = dict(cuda_rules.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_rules.rules_kernel("sha256", words, lens, bytecode, n_ops, 0,
                                64, [0] * 8, 4, 64)
    assert cuda_rules.launches == launches
    # the dispatcher takes the plain version for them, and checks the job
    count, lanes = cuda_rules.rules_crack("sha256", words, lens, bytecode,
                                          n_ops, 0, 64, [0] * 8, 4, 64)
    assert int(count) == 0 and lanes.tolist() == [-1] * 4
    for bad in ((1, 64), (0, 65), (0, 96)):        # past the table / batch
        with pytest.raises(ValueError, match="window"):
            cuda_rules.rules_crack("sha256", words, lens, bytecode, n_ops,
                                   *bad, [0] * 8, 4, 96 if bad[1] == 96
                                   else 64)
    with pytest.raises(ValueError, match="multiple of 32"):
        cuda_rules.rules_crack("sha256", words, lens, bytecode, n_ops, 0,
                               8, [0] * 8, 4, 48)
    with pytest.raises(ValueError, match="max_len"):
        cuda_rules.rules_crack("ntlm", words, lens, bytecode, n_ops, 0,
                               8, [0] * 4, 4, 64)


def test_slice_e_kernels_refuse_cpu_tensors():
    """The PMKID and bcrypt wrappers launch on CUDA tensors only and
    count no launch otherwise; the dispatchers take the plain version
    for CPU tensors."""
    from dprf_tpu_torch.ops import cuda_bcrypt, cuda_pbkdf2
    gen = MaskGenerator("?l?l?l")
    table = torch.zeros((1, cuda_pbkdf2.TARGET_WORDS), dtype=torch.int32)
    launches = dict(cuda_pbkdf2.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_pbkdf2.pmkid_kernel(gen.charset_lut("cpu"), gen.radices,
                                 gen.digits(0), 8, b"net", 2, table, 4, 8)
    assert cuda_pbkdf2.launches == launches
    count, lanes, tidx = cuda_pbkdf2.pmkid_crack(
        gen.charset_lut("cpu"), gen.radices, gen.digits(0), 8, b"net", 1,
        table, 4, 8)
    assert int(count) == 0 and lanes.tolist() == tidx.tolist() == [-1] * 4
    for bad in ((b"", 1), (b"x" * 33, 1), (b"net", 0)):
        with pytest.raises(ValueError):
            cuda_pbkdf2.pmkid_crack(gen.charset_lut("cpu"), gen.radices,
                                    gen.digits(0), 8, *bad, table, 4, 8)
    key = torch.zeros((2, 18), dtype=torch.int32)
    P = torch.zeros((2, 18), dtype=torch.int32)
    S = torch.zeros((2, 1024), dtype=torch.int32)
    launches = dict(cuda_bcrypt.launches)
    for call in (lambda: cuda_bcrypt.setup_kernel(key, [0] * 4),
                 lambda: cuda_bcrypt.advance_kernel(P, S, key, [0] * 18, 1),
                 lambda: cuda_bcrypt.finish_kernel(P, S, None, 2, [0] * 6,
                                                   4)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
    assert cuda_bcrypt.launches == launches
    with pytest.raises(ValueError, match="int32"):
        cuda_bcrypt.eks_advance(P, S[:1], key, [0] * 18, 1)


def test_ext_kernels_refuse_cpu_tensors():
    """The nested and salted wrappers launch on CUDA tensors only and
    count no launch otherwise; the dispatchers take the plain version
    for CPU tensors and check the job (a salt past 32 bytes or past the
    block, an unknown chain)."""
    from dprf_tpu_torch.ops import cuda_ext
    gen = MaskGenerator("?l?l?l")
    lut = gen.charset_lut("cpu")
    base = (gen.radices, gen.digits(0), 64)
    launches = dict(cuda_ext.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_ext.nested_kernel("md5(md5)", lut, *base, [0] * 4, 4, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_ext.nested_multi_kernel(
            "mysql41", lut, *base, torch.zeros((8, 128), dtype=torch.int32),
            torch.zeros((1, 5), dtype=torch.int32), 4, 64)
    rows, shift = cuda_ext.salted_table("sha1-sp", 3, [(b"salt", [0] * 5)],
                                        "cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_ext.salted_kernel("sha1-sp", lut, *base, shift, rows, 4, 64)
    assert cuda_ext.launches == launches
    rows, _ = cuda_ext.salted_table("md5-ps", 3, [(b"s", [0] * 4)], "cpu")
    count, lanes, tpos, tcount = cuda_ext.salted_crack("md5-ps", lut, *base,
                                                       0, rows, 4, 64)
    assert int(count) == 0 and lanes.tolist() == [-1] * 4
    assert tpos.tolist() == [-1] * 4 and tcount.tolist() == [0]
    for salt in (b"x" * 33, b"x" * 53):
        with pytest.raises(ValueError, match="salt"):
            cuda_ext.salted_table("md5-ps", 3, [(salt, [0] * 4)], "cpu")
    for shift in (33, 53):
        with pytest.raises(ValueError, match="salt"):
            cuda_ext.salted_crack("md5-sp", lut, *base, shift, rows, 4, 64)
    with pytest.raises(ValueError):
        cuda_ext.salted_crack("sha512-ps", lut, *base, 0, rows, 4, 64)
    with pytest.raises(ValueError):
        cuda_ext.nested_crack("md5(sha256)", lut, *base, [0] * 4, 4, 64)


def test_kernel_job_checks():
    gen = MaskGenerator("?l?l?l")
    lut = gen.charset_lut("cpu")
    good = (lut, gen.radices, gen.digits(0), 64, [0, 0, 0, 0], 4, 64)
    cuda_mask.mask_crack("md5", *good)
    for i, bad in [(0, lut.to(torch.int32)), (1, gen.radices[:2]),
                   (2, [26, 0, 0]), (3, 65), (4, [0, 0, 0]), (5, -1),
                   (6, 1 << 31)]:
        args = list(good)
        args[i] = bad
        with pytest.raises(ValueError):
            cuda_mask.mask_crack("md5", *args)
    with pytest.raises(ValueError):
        cuda_mask.mask_crack("md5crypt", *good)
    # sha512 is a core: its 16-word target runs (the plain version here),
    # a 4-word one is refused
    count, lanes = cuda_mask.mask_crack("sha512", *good[:4], [0] * 16,
                                        *good[5:])
    assert int(count) == 0 and lanes.tolist() == [-1] * 4
    with pytest.raises(ValueError):
        cuda_mask.mask_crack("sha512", *good)


def test_build_hash_covers_included_headers(tmp_path, monkeypatch):
    """An edit to a header the source includes changes the library's
    hash, so a stale library is never loaded; an unrelated file does
    not."""
    from dprf_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    (tmp_path / "k.cu").write_text('#include "sub/a.cuh"\nint k;\n')
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "a.cuh").write_text('#include "b.cuh"\n')
    (tmp_path / "sub" / "b.cuh").write_text("// v1\n")
    (tmp_path / "other.cuh").write_text("// v1\n")
    src = str(tmp_path / "k.cu")
    assert sorted(os.path.relpath(p, tmp_path)
                  for p in _build.source_files(src)) == \
        ["k.cu", "sub/a.cuh", "sub/b.cuh"]
    before = _build.source_hash(src)
    (tmp_path / "other.cuh").write_text("// v2\n")
    assert _build.source_hash(src) == before
    (tmp_path / "sub" / "b.cuh").write_text("// v2\n")
    assert _build.source_hash(src) != before
