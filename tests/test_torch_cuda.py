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
        # one loop window of 5 batches; at capacity 0 it overflows and
        # its batches run again one by one before the rescan
        assert w.dispatched == (10 if cap == 0 else 5)


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


def _pmkid_line(plain, essid, ap, sta, iterations):
    import hmac
    pmk = hashlib.pbkdf2_hmac("sha1", plain, essid, iterations, 32)
    pmkid = hmac.new(pmk, b"PMK Name" + ap + sta, hashlib.sha1).digest()
    return f"{pmkid[:16].hex()}*{ap.hex()}*{sta.hex()}*{essid.hex()}"


def test_pmkid_kernel_matches_plain():
    """16 iterations over 2^14 lanes of ?l^8: hits at lane 0, at the
    last valid lane of a partial batch, and one lane on two targets."""
    _need_card()
    from dprf_tpu_torch.ops import cuda_pbkdf2
    gen, batch, essid = MaskGenerator("?l" * 8), 1 << 14, b"benchnet"
    start, nv = 77 * batch, batch - 9
    ap, sta, other = b"\x0a" * 6, b"\xa0" * 6, b"\x01" * 6
    eng = get_engine("wpa2-pmkid")
    spec = [(0, ap, sta), (nv - 1, ap, sta), (500, ap, sta),
            (500, other, sta), (nv, ap, sta)]
    targets = [eng.parse_target(_pmkid_line(gen.candidate(start + x),
                                            essid, a, s, 16))
               for x, a, s in spec]
    args = (gen.charset_lut("cuda"), gen.radices, gen.digits(start), nv,
            essid, 16, cuda_pbkdf2.target_table(targets, "cuda"), 64, batch)
    launches = cuda_pbkdf2.launches["pmkid"]
    k = cuda_pbkdf2.pmkid_kernel(*args)
    p = cuda_pbkdf2.pmkid_plain(*args)
    torch.cuda.synchronize()
    assert cuda_pbkdf2.launches["pmkid"] == launches + 1

    def pairs(count, lanes, tidx):
        return int(count.item()), sorted(
            (a, b) for a, b in zip(lanes.tolist(), tidx.tolist()) if a >= 0)

    assert pairs(*k) == pairs(*p) == (4, [(0, 0), (500, 2), (500, 3),
                                          (nv - 1, 1)])


def test_bcrypt_kernels_match_plain_and_oracle():
    """setup + advance(1) + finish against the plain version on 64
    candidates, exact; the kernels' chain against the oracle at cost
    4."""
    _need_card()
    from dprf_tpu_torch.engines.cpu.bcrypt import bcrypt_raw
    from dprf_tpu_torch.ops import blowfish, cuda_bcrypt
    rng = np.random.default_rng(3)
    B = 64
    cand = torch.as_tensor(rng.integers(1, 256, (B, 72), dtype=np.uint8),
                           device="cuda")
    lens = torch.as_tensor(rng.integers(0, 73, B).astype(np.int32),
                           device="cuda")
    key = blowfish.key_words_from_candidates(cand, lens)
    sw = blowfish.salt_to_words(bytes(range(16)))
    s18 = blowfish.salt18_words(sw)
    P, S = cuda_bcrypt.setup_kernel(key, sw)
    Pp, Sp = cuda_bcrypt.setup_plain(key, sw)
    assert torch.equal(P, Pp) and torch.equal(S, Sp)
    P, S = cuda_bcrypt.advance_kernel(P, S, key, s18, 1)
    Pp, Sp = cuda_bcrypt.advance_plain(Pp, Sp, key, s18, 1)
    assert torch.equal(P, Pp) and torch.equal(S, Sp)
    _, _, d = cuda_bcrypt.finish_kernel(P, S, None, B, [0] * 6, 0)
    tgt = blowfish.digest_to_words(blowfish.words_to_digests(
        d[9:10].cpu().numpy())[0])
    k = cuda_bcrypt.finish_kernel(P, S, None, B - 1, tgt, 8)
    p = cuda_bcrypt.finish_plain(Pp, Sp, None, B - 1, tgt, 8)
    torch.cuda.synchronize()
    assert torch.equal(k[2], p[2])
    assert _hit_set(k[0], k[1]) == _hit_set(p[0], p[1]) == (1, [9])
    eng = get_engine("bcrypt", "cuda")
    words = [b"", b"hunter2", bytes(range(1, 73))]
    salt = bytes(rng.integers(0, 256, 16, dtype=np.uint8))
    assert eng.hash_batch(words, params={"salt": salt, "cost": 4}) == \
        [bcrypt_raw(w, salt, 4) for w in words]


def test_cli_pmkid_and_bcrypt_on_card(tmp_path, capsys, monkeypatch):
    _need_card()
    from dprf_tpu_torch.engines.cpu.bcrypt import bcrypt_hash
    from dprf_tpu_torch.engines.cpu.engines import Pmkid2Engine
    from dprf_tpu_torch.ops import cuda_bcrypt, cuda_pbkdf2
    monkeypatch.setattr(Pmkid2Engine, "iterations", 64)
    line = _pmkid_line(b"zzzz", b"net", b"\x01" * 6, b"\x02" * 6, 64)
    hashfile = tmp_path / "p.txt"
    hashfile.write_text(line + "\n")
    launches = cuda_pbkdf2.launches["pmkid"]
    rc = cli.main(["crack", "?l?l?l?l", str(hashfile), "--engine",
                   "wpa2-pmkid", "--no-potfile", "--batch", "65536"])
    captured = capsys.readouterr()
    assert rc == 0 and captured.out.splitlines() == [f"{line}:zzzz"]
    assert "rejected=0" in captured.err
    assert cuda_pbkdf2.launches["pmkid"] - launches == 7
    words = tmp_path / "w.txt"
    words.write_text("alpha\nbeta\ngamma\n")
    line = bcrypt_hash(b"Gamma", bytes(range(16)), 4)
    hashfile.write_text(line + "\n")
    cuda_bcrypt.reset_launches()
    rc = cli.main(["crack", "-a", "wordlist", str(words), str(hashfile),
                   "--engine", "bcrypt", "--rules", "toggle",
                   "--no-potfile"])
    captured = capsys.readouterr()
    assert rc == 0 and captured.out.splitlines() == [f"{line}:Gamma"]
    assert cuda_bcrypt.launches["bcrypt_setup"] == 1
    assert cuda_bcrypt.advanced_rounds == 16


def test_cli_bcrypt_mask_on_card(tmp_path, capsys):
    """A cost-4 ?l?l?l mask crack: targets at the first index and at the
    last (the last valid lane of a partial batch), each target swept in
    its own batches."""
    _need_card()
    from dprf_tpu_torch.engines.cpu.bcrypt import bcrypt_hash
    from dprf_tpu_torch.ops import cuda_bcrypt
    lines = [bcrypt_hash(p, bytes(range(16)), 4) for p in (b"aaa", b"zzz")]
    hashfile = tmp_path / "b.txt"
    hashfile.write_text("".join(ln + "\n" for ln in lines))
    cuda_bcrypt.reset_launches()
    rc = cli.main(["crack", "?l?l?l", str(hashfile), "--engine", "bcrypt",
                   "--no-potfile"])
    captured = capsys.readouterr()
    assert rc == 0 and sorted(captured.out.splitlines()) == \
        sorted([f"{lines[0]}:aaa", f"{lines[1]}:zzz"])
    assert "rejected=0" in captured.err and "tested=17576" in captured.err
    batches = 2 * -(-26 ** 3 // cuda_bcrypt.resident_batch("cuda"))
    assert cuda_bcrypt.launches["bcrypt_setup"] == batches
    assert cuda_bcrypt.launches["bcrypt_finish"] == batches
    assert cuda_bcrypt.advanced_rounds == 16 * batches


def _ext_hits(result):
    count, lanes = result[:2]
    return int(count.item()), sorted(int(x) for x in lanes.cpu().tolist()
                                     if x >= 0)


@pytest.mark.parametrize("name", ["md5(md5)", "sha1(sha1)", "md5(sha1)",
                                  "sha1(md5)", "sha256(md5)",
                                  "sha256(sha1)", "mysql41"])
def test_nested_kernel_matches_plain(name):
    """Each nested chain on ?a^5 at batch 2^20, one target and 1,000:
    hits at the first lane, two in one warp and the last valid lane of a
    partial batch; the multi mode holds tpos and n_maybe too."""
    _need_card()
    from dprf_tpu_torch.ops import cuda_ext
    batch, gen = 1 << 20, MaskGenerator("?a" * 5)
    start, n_valid = 3 * batch, batch - 7
    lut = gen.charset_lut("cuda")
    base = (gen.radices, gen.digits(start), n_valid)
    oracle = get_engine(name)
    little = name.startswith("md5")
    plants = [0, 40, 41, n_valid - 1, n_valid]
    digests = oracle.hash_batch([gen.candidate(start + p) for p in plants])
    for p, d in zip(plants, digests):
        args = (name, lut, *base, [int(w) for w in np.frombuffer(
            d, "<u4" if little else ">u4")], 64, batch)
        k = cuda_ext.nested_kernel(*args)
        assert _ext_hits(k) == _ext_hits(cuda_ext.nested_plain(*args)) == \
            ((1, [p]) if p < n_valid else (0, []))
    rng = np.random.default_rng(21)
    digests += oracle.hash_batch([bytes(rng.integers(33, 127, 8,
                                                     dtype=np.uint8))
                                  for _ in range(995)])
    table = make_target_table(digests, little)
    rows = torch.as_tensor(
        bloom.bloom_tables(table.original_words()).view(np.int32),
        device="cuda")
    args = (name, lut, *base, rows, table.tensor("cuda"), 64, batch)
    k = cuda_ext.nested_multi_kernel(*args)
    p = cuda_ext.nested_multi_plain(*args)
    torch.cuda.synchronize()

    def pairs(count, lanes, tpos, n_maybe):
        got = sorted((int(a), int(table.order[b])) for a, b in
                     zip(lanes.tolist(), tpos.tolist()) if a >= 0)
        return int(count.item()), got, int(n_maybe.item())

    assert pairs(*k) == pairs(*p)
    assert pairs(*k)[1] == [(x, i) for i, x in enumerate(plants[:4])]


def _group_hits(result, idx):
    """A grouped kernel's (count, (lane, job target) pairs, tcount)."""
    count, lanes, tpos, tcount = result
    pairs = sorted((int(a), idx[int(b)]) for a, b in
                   zip(lanes.cpu().tolist(), tpos.cpu().tolist()) if a >= 0)
    return int(count.item()), pairs, tcount.cpu().tolist()


@pytest.mark.parametrize("variant", ["md5-ps", "md5-sp", "sha1-ps",
                                     "sha1-sp", "sha256-ps", "sha256-sp"])
def test_salted_kernel_matches_plain(variant):
    """Each salted core on ?l^5 at batch 2^20, its targets grouped as the
    worker groups them (salts of 0, 3, 4, 7 and 32 bytes, two targets a
    length): for each group a partial batch with hits at the first lane
    and the last valid lane and one just past it, count, (lane, target)
    pairs and per-target counts equal to the plain version's."""
    _need_card()
    from dprf_tpu_torch.ops import cuda_ext
    algo, _ = cuda_ext.split_salted(variant)
    batch, gen = 1 << 20, MaskGenerator("?l" * 5)
    lut = gen.charset_lut("cuda")
    oracle = get_engine(variant)
    rng = np.random.default_rng(23)
    start, n_valid = batch, batch - 9
    targets, want = [], []
    for n in (0, 3, 4, 7, 32):
        salt = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        for lane in (0, n_valid - 1, n_valid):
            d = oracle.hash_batch([gen.candidate(start + lane)],
                                  params={"salt": salt})[0]
            if lane < n_valid:
                want.append((lane, len(targets)))
            targets.append((salt, [int(w) for w in np.frombuffer(
                d, "<u4" if algo == "md5" else ">u4")]))
    got = []
    for idx in cuda_ext.salted_groups(variant, [t[0] for t in targets]):
        rows, shift = cuda_ext.salted_table(
            variant, 5, [targets[i] for i in idx], "cuda")
        args = (variant, lut, gen.radices, gen.digits(start), n_valid, shift,
                rows, 64, batch)
        launches = cuda_ext.launches[f"{variant}_group"]
        k = _group_hits(cuda_ext.salted_kernel(*args), idx)
        p = _group_hits(cuda_ext.salted_plain(*args), idx)
        torch.cuda.synchronize()
        assert cuda_ext.launches[f"{variant}_group"] == launches + 1
        assert k == p
        got += k[1]
    assert sorted(got) == sorted(want)


def test_cli_nested_and_salted_on_card(tmp_path, capsys):
    """crack --device cuda for md5(md5) over a 1,000-target list and
    for sha1-sp over three salted targets: every plant found, launches
    once per batch (per group of one salt length for salted)."""
    _need_card()
    from dprf_tpu_torch.ops import cuda_ext
    gen = MaskGenerator("?l?l?l?l")
    rng = np.random.default_rng(29)
    oracle = get_engine("md5(md5)")
    plants = [b"aaaa", b"zzzz", b"qwer"]
    digests = oracle.hash_batch(plants + [
        bytes(rng.integers(33, 127, 8, dtype=np.uint8)) for _ in range(997)])
    hashfile = tmp_path / "n.txt"
    hashfile.write_text("".join(d.hex() + "\n" for d in digests))
    cuda_ext.reset_launches()
    rc = cli.main(["crack", "?l?l?l?l", str(hashfile), "--engine",
                   "md5(md5)", "--no-potfile", "--batch", "65536"])
    captured = capsys.readouterr()
    assert rc == 0 and len(captured.out.splitlines()) == 3
    assert "rejected=0" in captured.err
    assert cuda_ext.launches["md5(md5)_mask_multi"] == 7
    oracle = get_engine("sha1-sp")
    lines = []
    for plain, salt in ((b"aaaa", b""), (b"zzzz", b"x" * 32),
                        (b"mnop", b"12345")):
        d = oracle.hash_batch([plain], params={"salt": salt})[0]
        lines.append(f"{d.hex()}:{salt.decode()}")
    hashfile.write_text("\n".join(lines) + "\n")
    cuda_ext.reset_launches()
    rc = cli.main(["crack", "?l?l?l?l", str(hashfile), "--engine",
                   "sha1-sp", "--no-potfile", "--batch", "65536"])
    captured = capsys.readouterr()
    assert rc == 0 and len(captured.out.splitlines()) == 3
    assert "rejected=0" in captured.err
    # three salt lengths: three groups, one launch a (group, batch)
    assert cuda_ext.launches["sha1-sp_group"] == 3 * 7


#: slice F1's instantiations: (engine driving it, multi target)
F1_CASES = [(e, m) for e in ("sha512", "sha384", "sha3-224", "keccak-256",
                             "sha3-384", "keccak512") for m in (False, True)]


def _f1_fns(engine: str, multi: bool):
    from dprf_tpu_torch.ops import cuda_keccak
    if engine in cuda_keccak.NAMES:
        return (cuda_keccak.keccak_mask_multi_kernel,
                cuda_keccak.keccak_mask_multi_plain) if multi else \
            (cuda_keccak.keccak_mask_kernel, cuda_keccak.keccak_mask_plain)
    return (cuda_mask.mask_multi_kernel, cuda_mask.mask_multi_plain) \
        if multi else (cuda_mask.mask_kernel, cuda_mask.mask_plain)


@pytest.mark.parametrize("engine,multi", F1_CASES)
def test_wide_core_kernels_match_plain(engine, multi):
    """sha512/384 and the Keccak widths at batch 2^20: one target at the
    first lane and at the last valid lane; a list of 1,000 with two hits
    in one warp and one at the last valid lane, and 8,192 targets at the
    longest mask the core takes (past 48 KB of shared memory)."""
    _need_card()
    batch = 1 << 20
    kernel, plain = _f1_fns(engine, multi)
    eng = get_engine(engine, "cuda")
    oracle = get_engine(engine)
    rng = np.random.default_rng(len(engine) + multi)
    gen = MaskGenerator("?a" * 5)
    if not multi:
        for start, n_valid, lane in ((0, batch, 0),
                                     (batch, batch - 5, batch - 6)):
            target = [int(w) for w in np.frombuffer(oracle.hash_batch(
                [gen.candidate(start + lane)])[0], ">u4")]
            args = (engine, gen.charset_lut("cuda"), gen.radices,
                    gen.digits(start), n_valid, target, 64, batch)
            k, p = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            assert _hit_set(*k) == _hit_set(*p) == (1, [lane])
        return
    for gen, n_targets in ((gen, 1000), (MaskGenerator(
            "?a?l" + "?d" * (eng.max_candidate_len - 2)), 8192)):
        start = int(rng.integers(0, min(1 << 40,
                                        gen.keyspace // batch - 1))) * batch
        plants = [0, 40, 41, batch - 9]
        digests = oracle.hash_batch([gen.candidate(start + p)
                                     for p in plants])
        digests += oracle.hash_batch([rng.bytes(9)
                                      for _ in range(n_targets - 4)])
        table = make_target_table(digests, False)
        rows = torch.as_tensor(
            bloom.bloom_tables(table.original_words()).view(np.int32),
            device="cuda")
        args = (engine, gen.charset_lut("cuda"), gen.radices,
                gen.digits(start), batch - 8, rows, table.tensor("cuda"), 64,
                batch)
        k, p = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        got = [sorted(zip(r[1].tolist(), r[2].tolist())) for r in (k, p)]
        assert got[0] == got[1]
        assert [int(r[0]) for r in (k, p)] == [4, 4]
        assert int(k[3]) == int(p[3])
        assert sorted(table.order[t] for la, t in got[0] if la >= 0) == \
            [0, 1, 2, 3]


def test_cli_sha512_and_keccak_on_card(tmp_path, capsys):
    """crack --device cuda for sha512 and keccak-256 over ?l^4: every
    plant found, only the engine's instantiation launched, once per
    batch."""
    _need_card()
    from dprf_tpu_torch.ops import cuda_keccak
    for engine, key, mod in (("sha512", "sha512_mask_multi", cuda_mask),
                             ("keccak-256", "keccak256_mask_multi",
                              cuda_keccak)):
        oracle = get_engine(engine)
        digests = oracle.hash_batch([b"aaaa", b"zzzz", b"qwer", b"!!"])
        hashfile = tmp_path / "h.txt"
        hashfile.write_text("".join(d.hex() + "\n" for d in digests))
        cuda_mask.reset_launches()
        cuda_keccak.reset_launches()
        rc = cli.main(["crack", "?l?l?l?l", str(hashfile), "--engine",
                       engine, "--no-potfile", "--batch", "65536"])
        captured = capsys.readouterr()
        assert rc == 0 and len(captured.out.splitlines()) == 3
        assert "rejected=0" in captured.err
        assert mod.launches[key] == 7
        assert sum(cuda_mask.launches.values()) + \
            sum(cuda_keccak.launches.values()) == 7


def _krb5_line(password: bytes, asrep: bool, body_len: int,
               tag: int = None) -> str:
    """A valid etype-23 line: RFC 4757 run forward over an 8-byte
    confounder and a DER ticket of ``body_len`` content bytes."""
    import random

    from dprf_tpu_torch.engines.cpu.krb5 import der, encrypt

    rng = random.Random(body_len)
    tag = tag if tag is not None else (0x79 if asrep else 0x63)
    plain = bytes(rng.randrange(256) for _ in range(8)) + der(
        tag, der(0x30, bytes(rng.randrange(256) for _ in range(body_len))))
    chk, edata = encrypt(password, 8 if asrep else 2, plain)
    return (f"$krb5asrep$23$u@R:{chk.hex()}${edata.hex()}" if asrep else
            f"$krb5tgs$23$*u$R$s*${chk.hex()}${edata.hex()}")


def test_krb5_kernel_matches_plain():
    """2^20 lanes of ?a^8, a partial batch, tickets grouped by msg_type:
    a TGS group with hits at lane 0 and at the last valid lane, each DER
    form and a ticket no candidate opens; an AS-REP group with the
    relaxed 0x7A tag; then hit capacity 0.  Count, (lane, ticket) pairs
    and per-ticket counts equal."""
    _need_card()
    from dprf_tpu_torch.ops import cuda_krb5
    gen, batch = MaskGenerator("?a" * 8), 1 << 20
    lut = gen.charset_lut("cuda")
    start, nv = 987 * batch, batch - 7
    cases = [(False, 300, None, 0), (False, 60, None, nv - 1),
             (True, 180, 0x7A, 4242), (True, 70_000, None, 99),
             (False, 300, None, None), (False, 200, None, 5)]
    tgts, want = [], []
    for i, (asrep, body, tag, lane) in enumerate(cases):
        plain = gen.candidate(start + lane) if lane is not None else b"-"
        line = _krb5_line(plain, asrep, body, tag)
        eng = get_engine("krb5asrep" if asrep else "krb5tgs")
        tgts.append(cuda_krb5.target_kernel_args(eng.parse_target(line)))
        if lane is not None:
            want.append((lane, i))
    groups = cuda_krb5.krb5_groups(tgts)
    assert len(groups) == 2
    got = []
    for cap in (64, 0):
        for idx in groups:
            rows = torch.as_tensor(cuda_krb5.ticket_rows(
                [tgts[i] for i in idx]).view(np.int32), device="cuda")
            args = (lut, gen.radices, gen.digits(start), nv,
                    tgts[idx[0]].msg_type, rows, cap, batch)
            k = _group_hits(cuda_krb5.krb5_kernel(*args), idx)
            p = _group_hits(cuda_krb5.krb5_plain(*args), idx)
            torch.cuda.synchronize()
            assert k == p
            if cap:
                got += k[1]
            else:
                assert k[1] == [] and k[0] == sum(k[2])
    assert sorted(got) == sorted(want)


def test_kdf_kernel_matches_plain_and_hashlib():
    """16 iterations over 2^14 lanes of ?l^8: 4 and 8 words, salts of 1,
    20 and 51 bytes, every word equal; one lane against hashlib."""
    _need_card()
    from dprf_tpu_torch.ops import cuda_pbkdf2
    gen, batch = MaskGenerator("?l" * 8), 1 << 14
    lut = gen.charset_lut("cuda")
    start, nv = 31 * batch, batch - 3
    for n_words in (4, 8):
        for salt in (b"s", b"EXAMPLE.COMsvc123456", b"r" * 51):
            args = (lut, gen.radices, gen.digits(start), nv, salt, 16,
                    n_words, batch)
            launches = cuda_pbkdf2.launches["pbkdf2_kdf"]
            k = cuda_pbkdf2.kdf_kernel(*args)
            p = cuda_pbkdf2.kdf_plain(*args)
            torch.cuda.synchronize()
            assert cuda_pbkdf2.launches["pbkdf2_kdf"] == launches + 1
            assert k.shape == (nv, n_words) and torch.equal(k, p)
            want = hashlib.pbkdf2_hmac("sha1", gen.candidate(start + nv - 1),
                                       salt, 16, 4 * n_words)
            assert k[nv - 1].cpu().numpy().view(np.uint32).astype(
                ">u4").tobytes() == want


def test_cli_krb5_on_card(tmp_path, capsys):
    """crack --device cuda for krb5tgs and krb5asrep over ?l^4: every
    plant found, only the krb5 kernel launched, once per batch for the
    three tickets of one msg_type."""
    _need_card()
    from dprf_tpu_torch.ops import cuda_krb5
    for engine, asrep in (("krb5tgs", False), ("krb5asrep", True)):
        lines = [_krb5_line(p, asrep, 300 + i)
                 for i, p in enumerate((b"aaaa", b"zzzz", b"!!"))]
        hashfile = tmp_path / "h.txt"
        hashfile.write_text("".join(ln + "\n" for ln in lines))
        cuda_krb5.reset_launches()
        cuda_mask.reset_launches()
        rc = cli.main(["crack", "?l?l?l?l", str(hashfile), "--engine",
                       engine, "--no-potfile", "--batch", "65536"])
        captured = capsys.readouterr()
        assert rc == 0 and len(captured.out.splitlines()) == 2
        assert "rejected=0" in captured.err and "maybes=" in captured.err
        assert cuda_krb5.launches["krb5_group"] == 7
        assert sum(cuda_mask.launches.values()) == 0


@pytest.mark.parametrize("mask,salt_len,cycles", [("?b?b?b", 0, 8),
                                                  ("?l" * 8, 16, 8),
                                                  ("?l?d" * 4, 4, 7)])
def test_sevenzip_kernel_matches_plain_and_hashlib(mask, salt_len, cycles):
    """2^15 lanes, the last three invalid: every key word equal to the
    plain version's, lanes 0 and the last valid one to hashlib."""
    _need_card()
    from dprf_tpu_torch.engines.cpu.sevenzip import sevenzip_key
    from dprf_tpu_torch.ops import cuda_7z
    gen, batch = MaskGenerator(mask), 1 << 15
    salt = bytes(range(7, 7 + salt_len))
    start = 3 * batch
    args = (gen.charset_lut("cuda"), gen.radices, gen.digits(start),
            batch - 3, salt, cycles, batch)
    launches = cuda_7z.launches[cuda_7z.KERNEL]
    k = cuda_7z.sevenzip_kdf_kernel(*args)
    p = cuda_7z.sevenzip_kdf_plain(*args)
    torch.cuda.synchronize()
    assert cuda_7z.launches[cuda_7z.KERNEL] == launches + 1
    assert torch.equal(k, p) and k.shape == (batch - 3, 8)
    kk = k.cpu().numpy()
    for lane in (0, batch - 4):
        assert kk[lane].view(np.uint32).astype(">u4").tobytes() == \
            sevenzip_key(gen.candidate(start + lane), salt, cycles)


def test_pdf_kernel_matches_plain():
    """2^14 lanes of ?a^5 for each kind (R4 without metadata encryption
    on the R3/128 instantiation): a hit at lane 0, at the last valid lane
    of a partial batch, hit capacity 0; count and sorted lanes equal."""
    _need_card()
    from dprf_tpu_torch.engines.cpu.pdf import make_line
    from dprf_tpu_torch.ops import cuda_pdf
    gen, batch = MaskGenerator("?a" * 5), 1 << 14
    lut = gen.charset_lut("cuda")
    start = 77 * batch
    o, doc_id = bytes(range(32)), bytes(range(100, 116))
    for rev, bits, meta in ((2, 40, True), (3, 40, True), (3, 128, True),
                            (4, 128, False)):
        for lane, nv, cap in ((0, batch, 8), (batch - 10, batch - 9, 8),
                              (99, batch, 0)):
            line = make_line(gen.candidate(start + lane), rev, bits, o, -4,
                             doc_id, meta)
            kind, tgt = cuda_pdf.target_kernel_args(
                get_engine("pdf").parse_target(line))
            args = (kind, lut, gen.radices, gen.digits(start), nv, tgt, cap,
                    batch)
            k = cuda_pdf.pdf_kernel(*args)
            p = cuda_pdf.pdf_plain(*args)
            torch.cuda.synchronize()
            assert _hit_set(*k) == _hit_set(*p) == (1, [lane] if cap else [])


@pytest.mark.parametrize("engine", ["md5", "ntlm", "sha1", "sha256", "sha512",
                                    "sha384"])
def test_probe_kernel_matches_plain(engine):
    """The blocked probe at a window offset, 2^20 lanes of ?a^5, 1,000
    targets: hits at the window's first lane, two in one warp and its
    last valid lane; count, (lane, table position) pairs and n_maybe
    equal, and the launch counted under ``<core>_mask_probe``."""
    _need_card()
    batch, gen = 1 << 20, MaskGenerator("?a" * 5)
    offset, n_valid = 3 * batch, 4 * batch - 5
    plants = [offset, offset + 100, offset + 101, n_valid - 1]
    rng = np.random.default_rng(13)
    fill = [bytes(rng.integers(33, 127, 8, dtype=np.uint8))
            for _ in range(996)]
    digests = get_engine(engine).hash_batch(
        [gen.candidate(p) for p in plants] + fill)
    table = make_target_table(digests, not engine.startswith("sha"))
    rows, block_bits, k = cuda_mask.probe_rows(table.words)
    words = torch.as_tensor(rows.view(np.int32), device="cuda")
    args = (engine, gen.charset_lut("cuda"), gen.radices, gen.digits(0),
            n_valid, words, block_bits, k, table.tensor("cuda"), 64, batch)
    name = cuda_mask.kernel_name(engine, cuda_mask.PROBE)
    launches = cuda_mask.launches[name]
    got = cuda_mask.mask_probe_kernel(*args, offset=offset)
    want = cuda_mask.mask_probe_plain(*args, offset=offset)
    torch.cuda.synchronize()
    assert cuda_mask.launches[name] == launches + 1

    def flat(count, lanes, tpos, n_maybe):
        return (int(count.item()), sorted(
            (int(a), int(table.order[b])) for a, b in
            zip(lanes.tolist(), tpos.tolist()) if a >= 0),
            int(n_maybe.item()))

    assert flat(*got) == flat(*want)
    assert flat(*got)[:2] == (4, [(p, i) for i, p in enumerate(plants)])


@pytest.mark.parametrize("multi", [False, True])
def test_window_launches_match_plain(multi):
    """Four md5 launches at offsets i * 2^20 into one set of window
    buffers, the last one partial: the kernel's window equals the plain
    version's (count, sorted lanes, positions, n_maybe)."""
    _need_card()
    from dprf_tpu_torch.ops.superstep import loop_super_step
    batch, inner, gen = 1 << 20, 4, MaskGenerator("?a" * 5)
    n_valid = inner * batch - 7
    plants = [0, batch - 1, batch, 3 * batch + 5, n_valid - 1]
    digests = get_engine("md5").hash_batch([gen.candidate(p)
                                            for p in plants])
    results = []
    for device in ("cuda", "cpu"):
        if multi:
            step = cuda_mask.make_cuda_multi_crack_step(
                "md5", gen, make_target_table(digests), batch, 8, device)
        else:
            step = cuda_mask.make_cuda_mask_crack_step(
                "md5", gen, _words("md5", gen.candidate(plants[3])), batch,
                8, device)
        out = loop_super_step(step, batch, gen.digits(0), n_valid,
                              cuda_mask.hit_buffers(multi, 32, device))
        torch.cuda.synchronize()
        pairs = sorted(zip(out[1].tolist(), out[2].tolist()))
        results.append((int(out[0]), pairs,
                        int(out[3]) if multi else None))
    assert results[0] == results[1]
    assert [a for a, _ in results[0][1] if a >= 0] == \
        (plants if multi else [plants[3]])


@pytest.mark.parametrize("n_shards", [1, 4])
def test_sharded_worker_on_card(n_shards):
    """The sharded worker over a mesh of the card (4 shards on one card
    or a mesh of 1), 1,000 md5 targets over ?l^5 in 2^14-lane shards:
    the single-device worker's found set, and only the probe
    instantiation launched."""
    _need_card()
    from dprf_tpu_torch.parallel import make_mesh
    from dprf_tpu_torch.parallel.worker import ShardedMaskWorker
    gen = MaskGenerator("?l" * 5)
    plants = [0, 16383, 16384, 4 * 16384 * 8 - 1, gen.keyspace - 1]
    rng = np.random.default_rng(17)
    fill = [bytes(rng.integers(33, 127, 8, dtype=np.uint8))
            for _ in range(995)]
    digests = Md5Engine().hash_batch([gen.candidate(p) for p in plants]
                                     + fill)
    targets = [Target(d.hex(), d) for d in digests]
    unit = WorkUnit(0, 0, gen.keyspace)
    mesh = make_mesh(devices=["cuda:0"] * n_shards)
    cuda_mask.reset_launches()
    w = ShardedMaskWorker(TorchMd5Engine(), gen, targets, mesh,
                          batch_per_device=1 << 14, hit_capacity=16,
                          oracle=Md5Engine())
    got = sorted((h.target_index, h.cand_index) for h in w.process(unit))
    assert cuda_mask.launches["md5_mask_probe"] == \
        sum(cuda_mask.launches.values()) == w.dispatched * n_shards
    single = CudaMaskWorker(TorchMd5Engine(), gen, targets, batch=1 << 14,
                            hit_capacity=16, oracle=Md5Engine())
    assert got == sorted((h.target_index, h.cand_index)
                         for h in single.process(unit)) == \
        [(i, p) for i, p in enumerate(plants)]


def test_sharded_worker_across_cards(tmp_path, capsys):
    """On a machine with several cards, the sharded worker over all of
    them (each shard's launches on its own card, the gather onto the
    first) and ``crack --devices N`` find the single-device worker's set
    over ?l^6 at 1,000 md5 targets; every card's launches counted.
    Skips with fewer than two cards."""
    _need_card()
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs several cards, torch finds {n}")
    from dprf_tpu_torch.parallel import make_mesh
    from dprf_tpu_torch.parallel.worker import ShardedMaskWorker
    gen = MaskGenerator("?l" * 6)
    plants = [0, (1 << 24) - 1, 1 << 24, 5 * (1 << 24) + 7, gen.keyspace - 1]
    rng = np.random.default_rng(19)
    fill = [bytes(rng.integers(33, 127, 8, dtype=np.uint8))
            for _ in range(995)]
    digests = Md5Engine().hash_batch([gen.candidate(p) for p in plants]
                                     + fill)
    targets = [Target(d.hex(), d) for d in digests]
    unit = WorkUnit(0, 0, gen.keyspace)
    cuda_mask.reset_launches()
    w = ShardedMaskWorker(TorchMd5Engine(), gen, targets, make_mesh(n),
                          batch_per_device=1 << 24, hit_capacity=16,
                          oracle=Md5Engine())
    got = sorted((h.target_index, h.cand_index) for h in w.process(unit))
    assert got == [(i, p) for i, p in enumerate(plants)]
    assert cuda_mask.launches["md5_mask_probe"] == w.dispatched * n
    hashfile = tmp_path / "h.txt"
    hashfile.write_text("".join(d.hex() + "\n" for d in digests))
    assert cli.main(["crack", "?l" * 6, str(hashfile), "--engine", "md5",
                     "--devices", str(n), "--no-potfile"]) == 0
    captured = capsys.readouterr()
    assert sorted(captured.out.splitlines()) == sorted(
        f"{digests[i].hex()}:{gen.candidate(p).decode()}"
        for i, p in enumerate(plants))
    assert f"shards={n}" in captured.err and "rejected=0" in captured.err


@pytest.mark.parametrize("engine, mode", [("sha224", 0), ("sha224", 1),
                                          ("sha224", 2), ("mysql323", 0),
                                          ("mysql323", 2)])
def test_slice_l_mask_cores_match_plain(engine, mode):
    """sha224 and mysql323, the mask template's slice L cores, at batch
    2^20 over ?a^5 (spaces included: a mysql323 plant's other
    arrangements collide, counted alike): one target, the Bloom sets or
    the blocked probe (mysql323 has no sets) over 1,000 targets, hits at
    the first lane and the last valid lane of a partial batch."""
    _need_card()
    batch, gen = 1 << 20, MaskGenerator("?a" * 5)
    lut = gen.charset_lut("cuda")
    rng = np.random.default_rng(len(engine) + mode)
    start = int(rng.integers(0, gen.keyspace // batch - 1)) * batch
    n_valid = batch - 13
    plants = [start, start + n_valid - 1]
    oracle = get_engine(engine)
    head = (engine, lut, gen.radices, gen.digits(start), n_valid)
    le = False
    if mode == 0:
        target = [int(w) for w in np.frombuffer(
            oracle.hash_batch([gen.candidate(plants[1])])[0], ">u4")]
        args = (*head, target, 4096, batch)
        kernel, plain = cuda_mask.mask_kernel, cuda_mask.mask_plain
    else:
        digests = oracle.hash_batch([gen.candidate(p) for p in plants]
                                    + [b"%09d" % i for i in range(998)])
        table = make_target_table(digests, le)
        words = table.tensor("cuda")
        if mode == 1:
            rows = torch.as_tensor(bloom.bloom_tables(
                table.original_words()).view(np.int32), device="cuda")
            args = (*head, rows, words, 4096, batch)
            kernel, plain = cuda_mask.mask_multi_kernel, \
                cuda_mask.mask_multi_plain
        else:
            bits, block_bits, k = cuda_mask.probe_rows(table.words)
            args = (*head, torch.as_tensor(bits.view(np.int32),
                                           device="cuda"),
                    block_bits, k, words, 4096, batch)
            kernel, plain = cuda_mask.mask_probe_kernel, \
                cuda_mask.mask_probe_plain
    key = cuda_mask.kernel_name(engine, mode)
    launches = cuda_mask.launches[key]
    got, want = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    assert cuda_mask.launches[key] == launches + 1

    def flat(out):
        tpos = out[2].tolist() if mode else [0] * out[1].shape[0]
        return (int(out[0].item()), sorted(
            (int(a), int(b)) for a, b in zip(out[1].tolist(), tpos)
            if a >= 0), int(out[3].item()) if mode else 0)

    assert flat(got) == flat(want)
    assert n_valid - 1 in [lane for lane, _ in flat(got)[1]]


@pytest.mark.parametrize("variant, engine", [
    ("sha512-ps", "sha512-ps"), ("sha512-sp", "sha512-sp"),
    ("sha1-ps-utf16", "mssql2005"), ("sha1-ps-utf16", "mssql2000"),
    ("sha512-ps-utf16", "mssql2012")])
def test_slice_l_salted_variants_match_plain(variant, engine):
    """The salted kernel's wide and UTF-16LE variants on ?l^5 at batch
    2^18 (mssql2000 on uppercase-mapped charset tables), grouped as the
    worker groups them (sha512 salts of 0, 4 and 32 bytes; MSSQL's 4):
    hits at the first lane and the last valid lane and one just past
    it, count, (lane, target) pairs and per-target counts equal to the
    plain version's and to the plants."""
    _need_card()
    from dprf_tpu_torch.ops import cuda_ext
    batch, gen = 1 << 18, MaskGenerator("?l" * 5)
    dev = get_engine(engine, "cuda")
    lut = cuda_ext.mapped_lut(gen, "cuda", dev.byte_map)
    oracle = get_engine(engine)
    rng = np.random.default_rng(31)
    start, n_valid = batch, batch - 9
    targets, want = [], []
    for n in ((4,) if dev.widen else (0, 4, 32)):
        for lane in (0, n_valid - 1, n_valid):
            salt = bytes(rng.integers(0, 256, n, dtype=np.uint8))
            d = oracle.hash_batch([gen.candidate(start + lane)],
                                  params={"salt": salt})[0]
            if lane < n_valid:
                want.append((lane, len(targets)))
            targets.append((salt, [int(w) for w in np.frombuffer(d, ">u4")]))
    got = []
    for idx in cuda_ext.salted_groups(variant, [t[0] for t in targets]):
        rows, shift = cuda_ext.salted_table(
            variant, 5, [targets[i] for i in idx], "cuda")
        args = (variant, lut, gen.radices, gen.digits(start), n_valid, shift,
                rows, 64, batch)
        launches = cuda_ext.launches[f"{variant}_group"]
        k = _group_hits(cuda_ext.salted_kernel(*args), idx)
        p = _group_hits(cuda_ext.salted_plain(*args), idx)
        torch.cuda.synchronize()
        assert cuda_ext.launches[f"{variant}_group"] == launches + 1
        assert k == p
        got += k[1]
    assert sorted(got) == sorted(want)
