"""The rules kernel's multi-target compare on the CPU: csrc/rules.cu's list
instantiations (the shared-memory probe, the bulk probe, the bulk
host-verify layout) built with g++ as tests/test_torch_rules_host.py
builds it, held against their plain version (``rules_list_plain``); and
``crack -a wordlist --rules best64 --device torch-cpu`` against lists of
1,000 and 10^4 targets, whose found set and potfile equal the reference
CLI's, with the relaunch of an overflowing word window (``--hit-cap
1``).  Digests from a seed with numpy; no interpret mode."""

import ctypes
import hashlib

import numpy as np
import pytest
import torch

from dprf_tpu.cli import main as ref_main
from dprf_tpu_torch.cli import main as port_main
from dprf_tpu_torch.engines import get_engine
from dprf_tpu_torch.generators.wordlist import WordlistRulesGenerator
from dprf_tpu_torch.ops import compare as cmp_ops
from dprf_tpu_torch.ops import cuda_mask, cuda_rules
from dprf_tpu_torch.ops.cuda_mask import BULK, PROBE
from dprf_tpu_torch.rules import load_rules
from dprf_tpu_torch.targets import probe

from test_torch_rules_host import _all_ops_job, lib  # noqa: F401

#: (engine, max_len, mode, host-verify)
HOST_CASES = [("md5", 27, PROBE, False), ("sha1", 16, PROBE, False),
              ("ntlm", 27, BULK, False), ("sha256", 16, BULK, False),
              ("md5", 16, BULK, True)]


def _list_state(job, engine, mode, host_verify, seed):
    """A list of 5 planted candidates of the job and 1,000 random
    digests: (the planted candidates, bitmap int32, block_bits, k, sorted
    table int32 or None, order)."""
    eng = get_engine(engine)
    le = get_engine(engine, "cuda", torch_device="cpu").little_endian
    rng = np.random.default_rng(seed)
    pool = sorted(set(job.want.values()))
    plants = [pool[int(i)] for i in rng.choice(len(pool), 5, replace=False)]
    digests = eng.hash_batch(plants) + [
        rng.bytes(eng.digest_size) for _ in range(1000)]
    if mode == PROBE:
        table = cmp_ops.make_target_table(digests, le)
        bits, block_bits, k = cuda_mask.probe_rows(table.words)
        return (plants, torch.as_tensor(bits.view(np.int32)), block_bits,
                k, table.tensor("cpu"), table.order)
    pt = probe.build_probe_table(digests, le, fp_budget=0.02,
                                 max_bytes=1024 if host_verify else None)
    assert (pt.table is None) == host_verify
    return (plants, *cuda_mask.probe_tensors(pt, "cpu"), pt.order)


@pytest.mark.parametrize("engine,max_len,mode,host_verify", HOST_CASES)
def test_host_built_list_kernel_matches_plain(lib, engine, max_len, mode,  # noqa: F811
                                              host_verify):
    """Every (word, rule) candidate of the all-ops job under a list: the
    kernel's count, (lane, table position) pairs and n_maybe equal its
    plain version's, every planted candidate's lanes among them."""
    job = _all_ops_job(max_len)
    plants, words, block_bits, k, table, order = _list_state(
        job, engine, mode, host_verify, max_len + mode)
    cap = job.wb * len(job.rules)
    count = np.zeros(1, np.int32)
    lanes = np.full(cap, -1, np.int32)
    tpos = np.full(cap, -1, np.int32)
    n_maybe = np.zeros(1, np.int32)
    run = 7
    args = cuda_rules._RulesArgs(job.max_len, len(job.rules), job.wb, job.ws,
                                 job.nv, (ctypes.c_uint32 * 8)(), run)
    bits = np.ascontiguousarray(words.numpy())
    tab = None if table is None else np.ascontiguousarray(table.numpy())
    margs = cuda_mask.MultiArgs(
        bits.ctypes.data, None if tab is None else tab.ctypes.data, 0,
        0 if tab is None else tab.shape[0], block_bits, k)
    smem = ctypes.c_int(0)
    assert lib.dprf_rules_shared_bytes(cuda_rules.KERNEL_CORES[engine],
                                       ctypes.byref(smem)) == 0
    smem = smem.value + (64 << block_bits if mode == PROBE else 0)
    assert smem <= lib.emu_smem_bytes()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dprf_rules_list_launch.argtypes = [
        i32, i32, i32, ptr, ptr, ptr, ptr, ctypes.POINTER(cuda_rules._RulesArgs),
        ctypes.POINTER(cuda_mask.MultiArgs), ptr, ptr, ptr, ptr, i32, i32,
        i32, i32, ptr]
    assert lib.dprf_rules_list_launch(
        cuda_rules.KERNEL_CORES[engine], mode, 0, job.table.ctypes.data,
        job.lens.ctypes.data, job.bc.ctypes.data, job.n_ops.ctypes.data,
        ctypes.byref(args), ctypes.byref(margs), count.ctypes.data,
        lanes.ctypes.data, tpos.ctypes.data, n_maybe.ctypes.data, cap,
        cuda_rules.launch_grid(job.nv, len(job.rules), run),
        cuda_rules.THREADS, smem, None) == 0
    recs = np.zeros((lib.emu_records(), 16), np.int32)
    lib.emu_take(recs.ctypes.data)          # each candidate, at its marker
    assert len(recs) == len(job.want)
    gen = WordlistRulesGenerator(job.words, job.rules, max_len)
    buf, lens = gen.packed_words()
    bc, n_ops = cuda_rules.rule_tables(job.rules)
    pc, pl, pt, pm = cuda_rules.rules_list_plain(
        engine, mode, torch.as_tensor(buf), torch.as_tensor(lens), bc, n_ops,
        job.ws, job.nv, words, block_bits, k, table, cap, job.wb)
    got = sorted((int(a), int(b)) for a, b in zip(lanes, tpos) if a >= 0)
    want = sorted((int(a), int(b)) for a, b in zip(pl, pt) if a >= 0)
    assert (int(count[0]), got, int(n_maybe[0])) == \
        (int(pc), want, int(pm))
    hit_lanes = sorted(lane for lane, c in job.want.items()
                       if c in set(plants))
    if host_verify:
        assert int(pm) == int(pc) and all(t == -1 for _, t in got)
        assert set(hit_lanes) <= {lane for lane, _ in got}
    else:
        assert [lane for lane, _ in got] == hit_lanes
        assert {int(order[t]) for _, t in got} == set(range(5))


@pytest.fixture(scope="module")
def words3(tmp_path_factory):
    """300 words of 1-10 letters and digits, and 12 candidates under
    best64 to plant, two of them in one word window with --batch 4096
    (words 0-63)."""
    rng = np.random.default_rng(7)
    alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz0123456789",
                             np.uint8)
    words = [bytes(rng.choice(alphabet, int(rng.integers(1, 11))))
             for _ in range(300)]
    path = tmp_path_factory.mktemp("rules_multi") / "words.txt"
    path.write_bytes(b"\n".join(words) + b"\n")
    gen = WordlistRulesGenerator(words, load_rules("best64"))
    idx = [(3, 0), (5, 17), (40, 63)] + [
        (int(w), int(r)) for w, r in zip(rng.integers(64, 300, 9),
                                         rng.integers(0, 64, 9))]
    planted = sorted({gen.candidate(gen.index_of(w, r)) for w, r in idx})
    return path, planted


def _crack(main, words, hashfile, pot, device, capsys, extra=()):
    rc = main(["crack", "--engine", "sha256", "-a", "wordlist", str(words),
               "--targets-file", str(hashfile), "--rules", "best64",
               "--device", device, "--potfile", str(pot), *extra])
    cap = capsys.readouterr()
    return (rc, sorted(cap.out.splitlines()),
            sorted(pot.read_text().splitlines())), cap.err


@pytest.mark.parametrize("n_targets", [1000, 10 ** 4])
def test_wordlist_list_matches_reference(tmp_path, capsys, words3,
                                         n_targets):
    """sha256 x best64 against a list (1,000: the shared-memory probe;
    10^4: the bulk probe): the reference CLI's --device cpu found set
    and potfile; with --hit-cap 1 the overflowing word windows are
    relaunched on the device, never rescanned."""
    words, planted = words3
    rng = np.random.default_rng(n_targets)
    lines = [hashlib.sha256(p).hexdigest() for p in planted]
    lines += [rng.bytes(32).hex() for _ in range(n_targets - len(lines))]
    rng.shuffle(lines)
    hashfile = tmp_path / "h.txt"
    hashfile.write_text("\n".join(lines) + "\n")
    want, _ = _crack(ref_main, words, hashfile, tmp_path / "r.pot", "cpu",
                     capsys)
    assert want[0] == 0 and len(want[1]) == len(planted)
    for extra in ((), ("--hit-cap", "1", "--batch", "4096")):
        got, err = _crack(port_main, words, hashfile,
                          tmp_path / f"p{len(extra)}.pot", "torch-cpu",
                          capsys, extra)
        assert got == want
        summary = [ln for ln in err.splitlines() if "job finished" in ln][0]
        assert "rejected=0" in summary and "rescans=0" in summary
        assert extra == () or "relaunches=0" not in summary, summary
    assert ("probe table" in err) == (n_targets > cuda_mask.N_BULK)
