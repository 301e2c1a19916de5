"""The sharded mask runtime against the reference's CpuWorker oracle, on
the CPU: ShardedMaskWorker over a mesh of 8 CPU shards, then 4 (the
counterpart of the reference's 8 virtual CPU devices), in the
reference's kernel-compute scenarios (tests/test_a_shard_kernel.py):
one target at the last index, a list planted at shard and window edges
(the blocked probe), an overflowed shard redriven exactly, and a sweep
resumed on another shard count.  Then the CLI's ``--devices N``.
"""

import hashlib

import pytest
import torch

from dprf_tpu.cli import main as ref_main
from dprf_tpu.engines import get_engine as ref_get_engine
from dprf_tpu.generators.mask import MaskGenerator as RefMaskGenerator
from dprf_tpu.ops import pallas_mask  # noqa: F401  (the kernel it ports)
from dprf_tpu.runtime.worker import CpuWorker as RefCpuWorker
from dprf_tpu.runtime.workunit import WorkUnit as RefWorkUnit
from dprf_tpu_torch.cli import main as port_main
from dprf_tpu_torch.engines import get_engine
from dprf_tpu_torch.engines.base import Target
from dprf_tpu_torch.generators.mask import MaskGenerator
from dprf_tpu_torch.parallel import make_mesh
from dprf_tpu_torch.parallel.worker import ShardedMaskWorker
from dprf_tpu_torch.runtime.workunit import WorkUnit

pytestmark = pytest.mark.smoke

MASK = "?d?d?d?d?d"          # 100,000
TILE = 4096


def _targets(gen, idxs):
    return [Target(str(i), hashlib.md5(gen.candidate(i)).digest())
            for i in idxs]


def _oracle(targets, unit):
    ref_targets = [ref_get_engine("md5").parse_target(t.digest.hex())
                   for t in targets]
    return sorted((h.target_index, h.cand_index, h.plaintext)
                  for h in RefCpuWorker(ref_get_engine("md5"),
                                        RefMaskGenerator(MASK), ref_targets)
                  .process(RefWorkUnit(0, unit.start, unit.length)))


def _worker(gen, targets, n_dev, batch, cap, oracle=True):
    eng = get_engine("md5", device="cuda", torch_device="cpu")
    return ShardedMaskWorker(eng, gen, targets,
                             make_mesh(devices=["cpu"] * n_dev),
                             batch_per_device=batch, hit_capacity=cap,
                             oracle=get_engine("md5") if oracle else None)


def _hits(hits):
    return sorted((h.target_index, h.cand_index, h.plaintext) for h in hits)


def test_make_mesh():
    assert make_mesh(devices=["cpu"] * 8, n_devices=4) == \
        [torch.device("cpu")] * 4
    with pytest.raises(ValueError, match="requested 9 devices"):
        make_mesh(9, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="index"):
        make_mesh(devices=["cuda"])


@pytest.mark.parametrize("n_dev", [8, 4])
def test_sharded_single_target_parity(n_dev):
    """One target, the exact compare, no oracle: a plant at the last
    keyspace index survives the n_valid of the final partial stride."""
    gen = MaskGenerator(MASK)
    targets = _targets(gen, [gen.keyspace - 1])
    w = _worker(gen, targets, n_dev, TILE, 16, oracle=False)
    unit = WorkUnit(0, 0, gen.keyspace)
    got = _hits(w.process(unit))
    assert got == _oracle(targets, unit)
    assert got[0][1] == gen.keyspace - 1
    assert w.stride == n_dev * TILE


@pytest.mark.parametrize("n_dev", [8, 4])
def test_sharded_multi_probe_boundaries(n_dev):
    """A list (the blocked probe, verified on the card's plain version)
    planted at shard edges, the window's edge and the last index: the
    unit goes out as sharded windows (of 8 or 16 strides here, the rest
    a second), and the hit set is the oracle's, nothing more, nothing
    less."""
    gen = MaskGenerator(MASK)
    B = 1024
    stride = n_dev * B
    # 12 or 24 strides: windows of 8 or 16 of them
    window = stride << ((gen.keyspace // stride).bit_length() - 1)
    plant = [0, B - 1, B, stride - 1, stride, window - 1, window,
             gen.keyspace - 1]
    targets = _targets(gen, plant)
    w = _worker(gen, targets, n_dev, B, 16)
    assert w.window_batches == 256
    w.window_batches = window // stride
    unit = WorkUnit(0, 0, gen.keyspace)
    pending = w.submit(unit)
    assert [start for start, _ in pending.queued] == \
        [(0, window), (window, gen.keyspace - window)]
    assert w.windows == 2
    got = _hits(pending.resolve())
    assert got == _oracle(targets, unit)
    assert [g[1] for g in got] == plant
    assert w.n_maybe() == len(plant)


@pytest.mark.parametrize("n_dev", [8, 4])
def test_sharded_overflow_redrives_exactly(n_dev):
    """Six hits in shard 0 over a hit capacity of 2: the buffer
    truncates, the count does not, and every hit comes back once."""
    gen = MaskGenerator(MASK)
    plant = [0, 1, 2, 3, 4, 5, gen.keyspace - 1]
    targets = _targets(gen, plant)
    w = _worker(gen, targets, n_dev, TILE, 2)
    hits = w.process(WorkUnit(0, 0, gen.keyspace))
    assert sorted(h.cand_index for h in hits) == plant
    assert len(hits) == len({h.cand_index for h in hits})


def test_sharded_resume_resplit():
    """A sweep cut mid-stride on 8 shards resumes on 4: the two parts
    find the plants once each."""
    gen = MaskGenerator(MASK)
    cut = 8 * TILE + 517
    plant = [0, cut - 1, cut, cut + 1, gen.keyspace - 1]
    targets = _targets(gen, plant)
    first = _worker(gen, targets, 8, TILE, 16).process(WorkUnit(0, 0, cut))
    rest = _worker(gen, targets, 4, TILE, 16).process(
        WorkUnit(0, cut, gen.keyspace - cut))
    assert sorted(h.cand_index for h in first + rest) == plant


def _crack(main, tmp_path, capsys, engine, lines, extra, tag):
    hashfile = tmp_path / f"{tag}.txt"
    hashfile.write_text("".join(ln + "\n" for ln in lines))
    pot = tmp_path / f"{tag}.pot"
    rc = main(["crack", "?l?l?l", str(hashfile), "--engine", engine,
               "--potfile", str(pot), *extra])
    captured = capsys.readouterr()
    found = sorted(ln for ln in captured.out.splitlines() if ":" in ln)
    return rc, found, pot.read_text() if pot.exists() else "", captured.err


def test_cli_devices_matches_cpu(tmp_path, capsys):
    """``crack --device torch-cpu --devices 4`` finds the set and writes
    the potfile of the port's and the reference's ``--device cpu``."""
    words = [b"aaa", b"kkk", b"zzy", b"zzz"]
    lines = [hashlib.md5(w).hexdigest() for w in words] + ["00" * 16]
    got = _crack(port_main, tmp_path, capsys, "md5", lines,
                 ["--device", "torch-cpu", "--devices", "4", "--batch",
                  "512"], "sharded")
    assert "ShardedMaskWorker" in got[3] and "shards=4" in got[3]
    assert "windows=1" in got[3] and "rejected=0" in got[3]
    want = _crack(port_main, tmp_path, capsys, "md5", lines,
                  ["--device", "cpu"], "cpu")
    ref = _crack(ref_main, tmp_path, capsys, "md5", lines,
                 ["--device", "cpu"], "ref")
    assert got[:3] == want[:3] == ref[:3]
    assert got[0] == 0 and len(got[1]) == 4


@pytest.mark.parametrize("engine,line,extra", [
    ("md5-ps", "5f4dcc3b5aa765d61d8327deb882cf99:salt", ()),
    ("md5(md5)", "00" * 16, ()),
    ("md5", "00" * 16, ("-a", "wordlist", "--rules", "best64")),
])
def test_cli_devices_without_a_sharded_path_exits_2(tmp_path, capsys,
                                                    engine, line, extra):
    """An engine or attack without the sharded path is refused with
    ``--devices 4``, naming the engine, never run on one device."""
    hashfile = tmp_path / "h.txt"
    hashfile.write_text(line + "\n")
    attack_arg = "?l?l"
    if extra:
        attack_arg = str(tmp_path / "words.txt")
        (tmp_path / "words.txt").write_text("abc\n")
    rc = port_main(["crack", attack_arg, str(hashfile), "--engine", engine,
                    "--device", "torch-cpu", "--devices", "4",
                    "--no-potfile", *extra])
    err = capsys.readouterr().err
    assert rc == 2 and engine in err and "--devices 1" in err
