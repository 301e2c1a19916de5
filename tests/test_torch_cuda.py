"""The port on an NVIDIA card: the CUDA mask kernel against its plain
PyTorch version, the kernel worker and the CLI.  Every test here carries
the ``cuda`` marker and skips without a card, deciding inside the test.

This file imports neither jax nor dprf_tpu, so it also runs where only
the port is installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py``.
"""

import hashlib

import numpy as np
import pytest
import torch

from dprf_tpu_torch import cli
from dprf_tpu_torch.engines.base import Target
from dprf_tpu_torch.engines.cpu.engines import Md5Engine
from dprf_tpu_torch.engines.device.engines import TorchMd5Engine
from dprf_tpu_torch.generators.mask import MaskGenerator
from dprf_tpu_torch.ops import cuda_mask
from dprf_tpu_torch.runtime.worker import CudaMaskWorker
from dprf_tpu_torch.runtime.workunit import WorkUnit

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() "
                    "is False)")


def _words(plain: bytes) -> list:
    return [int(w) for w in np.frombuffer(hashlib.md5(plain).digest(),
                                          "<u4")]


def _hit_set(count, lanes):
    return (int(count.item()),
            sorted(int(x) for x in lanes.cpu().tolist() if x >= 0))


def test_kernel_matches_plain_on_card():
    """Count and sorted lanes equal at the main path's shapes (?l^6, a
    batch of 2^24) and for ?a^8 from a random base."""
    _need_card()
    batch = 1 << 24
    rng = np.random.default_rng(5)
    g6, g8 = MaskGenerator("?l?l?l?l?l?l"), MaskGenerator("?a" * 8)
    s8 = int(rng.integers(0, g8.keyspace - batch))
    cases = [(g6, 0, batch, 0),
             (g6, batch * 18, g6.keyspace - batch * 18, g6.keyspace - 1),
             (g6, batch * 3, batch, batch * 3 + int(rng.integers(0, batch))),
             (g8, s8, batch, s8 + int(rng.integers(0, batch)))]
    for gen, start, n_valid, plant in cases:
        args = (gen.charset_lut("cuda"), gen.radices, gen.digits(start),
                n_valid, _words(gen.candidate(plant)), 64, batch)
        launches = cuda_mask.mask_md5_kernel.launches
        kc, kl = cuda_mask.mask_md5_kernel(*args)
        pc, pl = cuda_mask.mask_crack_plain(*args)
        torch.cuda.synchronize()
        assert cuda_mask.mask_md5_kernel.launches == launches + 1
        assert _hit_set(kc, kl) == _hit_set(pc, pl) == (1, [plant - start])


def test_kernel_worker_rescans_overflow_on_card():
    _need_card()
    gen = MaskGenerator("?l?l?l?l")
    plant = 3 * 4096 + 11
    d = hashlib.md5(gen.candidate(plant)).digest()
    for cap in (0, 8):
        w = CudaMaskWorker(TorchMd5Engine(), gen, [Target(d.hex(), d)],
                           batch=4096, hit_capacity=cap,
                           oracle=Md5Engine())
        hits = w.process(WorkUnit(0, 0, 5 * 4096))
        assert [(h.cand_index, h.plaintext) for h in hits] == \
            [(plant, gen.candidate(plant))]
        assert w.dispatched == 5


def test_cli_crack_on_card(tmp_path, capsys):
    _need_card()
    digest = hashlib.md5(b"zzzz").hexdigest()
    hashfile = tmp_path / "h.txt"
    hashfile.write_text(digest + "\n")
    pot = tmp_path / "p.pot"
    launches = cuda_mask.mask_md5_kernel.launches
    rc = cli.main(["crack", "?l?l?l?l", str(hashfile), "--engine", "md5",
                   "--potfile", str(pot), "--batch", "65536"])
    captured = capsys.readouterr()
    assert rc == 0
    assert captured.out.splitlines() == [f"{digest}:zzzz"]
    assert pot.read_text() == f"{digest}:zzzz\n"
    assert "rejected=0" in captured.err
    # 26^4 = 456,976 candidates in batches of 65,536
    assert cuda_mask.mask_md5_kernel.launches - launches == 7
