"""The port on an NVIDIA card: the CUDA mask kernel against its plain
PyTorch version for every core and compare mode, the kernel worker and
the CLI.  Every test here carries the ``cuda`` marker and skips without
a card, deciding inside the test.

This file imports neither jax nor dprf_tpu, so it also runs where only
the port is installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py``.
"""

import hashlib

import numpy as np
import pytest
import torch

from dprf_tpu_torch import cli
from dprf_tpu_torch.engines import get_engine
from dprf_tpu_torch.engines.base import Target
from dprf_tpu_torch.engines.cpu.engines import Md5Engine
from dprf_tpu_torch.engines.device.engines import TorchMd5Engine
from dprf_tpu_torch.generators.mask import MaskGenerator
from dprf_tpu_torch.ops import bloom, cuda_mask
from dprf_tpu_torch.ops.compare import make_target_table
from dprf_tpu_torch.runtime.worker import CudaMaskWorker
from dprf_tpu_torch.runtime.workunit import WorkUnit

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() "
                    "is False)")


def _words(engine: str, plain: bytes) -> list:
    oracle = get_engine(engine)
    dt = ">u4" if engine.startswith("sha") else "<u4"
    return [int(w) for w in
            np.frombuffer(oracle.hash_batch([plain])[0], dt)]


def _hit_set(count, lanes):
    return (int(count.item()),
            sorted(int(x) for x in lanes.cpu().tolist() if x >= 0))


def test_kernel_matches_plain_on_card():
    """md5, one target: count and sorted lanes equal at the main path's
    shapes (?l^6, a batch of 2^24) and for ?a^8 from a random base."""
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
        args = ("md5", gen.charset_lut("cuda"), gen.radices,
                gen.digits(start), n_valid, _words("md5", gen.candidate(plant)),
                64, batch)
        launches = cuda_mask.launches["md5_mask"]
        kc, kl = cuda_mask.mask_kernel(*args)
        pc, pl = cuda_mask.mask_plain(*args)
        torch.cuda.synchronize()
        assert cuda_mask.launches["md5_mask"] == launches + 1
        assert _hit_set(kc, kl) == _hit_set(pc, pl) == (1, [plant - start])


@pytest.mark.parametrize("engine", ["md5", "ntlm", "sha1", "sha256"])
@pytest.mark.parametrize("multi", [False, True])
def test_every_core_and_mode_matches_plain(engine, multi):
    """One case per core and compare mode at batch 2^20 on ?a^5: hits
    at the first lane and two in one warp, a partial batch; the multi
    mode holds tpos and n_maybe too, over 1,000 targets."""
    _need_card()
    batch, gen = 1 << 20, MaskGenerator("?a" * 5)
    start = 7 * batch
    plants = [start, start + 100, start + 101]
    lut = gen.charset_lut("cuda")
    base = (gen.radices, gen.digits(start), batch - 5)
    if not multi:
        args = (engine, lut, *base, _words(engine, gen.candidate(plants[1])),
                64, batch)
        kc, kl = cuda_mask.mask_kernel(*args)
        pc, pl = cuda_mask.mask_plain(*args)
        torch.cuda.synchronize()
        assert _hit_set(kc, kl) == _hit_set(pc, pl) == (1, [100])
        return
    rng = np.random.default_rng(11)
    fill = [bytes(rng.integers(33, 127, 8, dtype=np.uint8)) for _ in
            range(997)]
    oracle = get_engine(engine)
    digests = oracle.hash_batch([gen.candidate(p) for p in plants] + fill)
    table = make_target_table(digests, not engine.startswith("sha"))
    rows = torch.as_tensor(
        bloom.bloom_tables(table.original_words()).view(np.int32),
        device="cuda")
    words = table.tensor("cuda")
    args = (engine, lut, *base, rows, words, 64, batch)
    k = cuda_mask.mask_multi_kernel(*args)
    p = cuda_mask.mask_multi_plain(*args)
    torch.cuda.synchronize()

    def pairs(count, lanes, tpos, n_maybe):
        got = sorted((int(a), int(b)) for a, b in
                     zip(lanes.tolist(), tpos.tolist()) if a >= 0)
        return int(count.item()), got, int(n_maybe.item())

    assert pairs(*k) == pairs(*p)
    count, got, _ = pairs(*k)
    assert count == 3
    assert [table.order[t] for _, t in got] == [0, 1, 2]


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
    launches = cuda_mask.launches["md5_mask"]
    rc = cli.main(["crack", "?l?l?l?l", str(hashfile), "--engine", "md5",
                   "--potfile", str(pot), "--batch", "65536"])
    captured = capsys.readouterr()
    assert rc == 0
    assert captured.out.splitlines() == [f"{digest}:zzzz"]
    assert pot.read_text() == f"{digest}:zzzz\n"
    assert "rejected=0" in captured.err
    # 26^4 = 456,976 candidates in batches of 65,536
    assert cuda_mask.launches["md5_mask"] - launches == 7


@pytest.mark.parametrize("engine", ["md5", "ntlm", "sha1", "sha256"])
def test_rules_kernel_matches_plain(engine):
    """Each rule-kernel core against its plain version: 2,000 words x
    best64 in windows of 1,024 words, hits planted at the first word
    under the first rule, at the last word of a partial window under the
    8-op rule, and both lanes of the "'7" / "]" pair."""
    _need_card()
    from dprf_tpu_torch.generators.wordlist import WordlistRulesGenerator
    from dprf_tpu_torch.ops import cuda_rules
    from dprf_tpu_torch.rules import load_rules
    rng = np.random.default_rng(17)
    words = [bytes(rng.integers(97, 123, int(n), dtype=np.uint8))
             for n in rng.integers(1, 13, 2000)]
    words[1500] = b"abcdefgh"
    max_len = 27 if engine == "ntlm" else 55
    gen = WordlistRulesGenerator(words, load_rules("best64"), max_len)
    buf, lens = gen.packed_words()
    tables = (torch.as_tensor(buf, device="cuda"),
              torch.as_tensor(lens, device="cuda"),
              *cuda_rules.rule_tables(gen.rules, "cuda"))
    B = 1024
    for ws, nv, plants in ((0, B, [0]),
                           (1000, 1000, [gen.index_of(1999, 56)]),
                           (975, B, [gen.index_of(1500, 46),
                                     gen.index_of(1500, 52)])):
        plain = gen.candidate(plants[0])
        args = (engine, *tables, ws, nv, _words(engine, plain), 64, B)
        launches = cuda_rules.launches[f"{engine}_rules"]
        kc, kl = cuda_rules.rules_kernel(*args)
        pc, pl = cuda_rules.rules_plain(*args)
        torch.cuda.synchronize()
        assert cuda_rules.launches[f"{engine}_rules"] == launches + 1
        assert _hit_set(kc, kl) == _hit_set(pc, pl)
        got = [(ws + x % B) * 64 + x // B for x in _hit_set(kc, kl)[1]]
        assert all(p in got for p in plants)
        assert all(gen.candidate(g) == plain for g in got)


def test_cli_wordlist_on_card(tmp_path, capsys):
    _need_card()
    from dprf_tpu_torch.ops import cuda_rules
    words = tmp_path / "words.txt"
    words.write_bytes(b"".join(b"w%05d\n" % i for i in range(5000)))
    digest = hashlib.sha256(b"04999w").hexdigest()     # "w04999" under "{"
    hashfile = tmp_path / "h.txt"
    hashfile.write_text(digest + "\n")
    launches = cuda_rules.launches["sha256_rules"]
    rc = cli.main(["crack", "-a", "wordlist", str(words), str(hashfile),
                   "--engine", "sha256", "--rules", "best64",
                   "--no-potfile", "--batch", str(1024 * 64)])
    captured = capsys.readouterr()
    assert rc == 0 and captured.out.splitlines() == [f"{digest}:04999w"]
    assert "rejected=0" in captured.err
    # 5,000 words in windows of 1,024
    assert cuda_rules.launches["sha256_rules"] - launches == 5
