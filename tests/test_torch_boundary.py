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
print(len(names), bad)
"""


def test_port_imports_without_jax_or_reference():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    n, bad = proc.stdout.split(" ", 1)
    assert int(n) >= 20 and bad.strip() == "[]", proc.stdout


def test_device_cuda_without_card_fails(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hashfile = tmp_path / "h.txt"
    hashfile.write_text("5f4dcc3b5aa765d61d8327deb882cf99\n")
    for argv in (["crack", "?l?l", str(hashfile), "--engine", "md5",
                  "--no-potfile"],
                 ["crack", "?l?l", str(hashfile), "--engine", "md5",
                  "--device", "cuda", "--no-potfile"],
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
