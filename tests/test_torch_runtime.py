"""The port's dispatcher, potfile and hashlist parser against the
reference's on the same inputs: the same unit sequence and covered
intervals, the same potfile text, the same parsed targets."""

import hashlib

import pytest

from dprf_tpu.engines.cpu.engines import Md5Engine as RefMd5Engine
from dprf_tpu.runtime import potfile as ref_potfile
from dprf_tpu.runtime.dispatcher import Dispatcher as RefDispatcher
from dprf_tpu.utils.hashlist import parse_lines as ref_parse_lines
from dprf_tpu_torch.engines import engine_class, get_engine
from dprf_tpu_torch.engines.device.engines import TorchMd5Engine
from dprf_tpu_torch.runtime import potfile
from dprf_tpu_torch.runtime.dispatcher import Dispatcher
from dprf_tpu_torch.utils.hashlist import parse_lines


def _sweep(d):
    units = []
    while (u := d.lease()) is not None:
        units.append((u.start, u.length))
        d.complete(u.unit_id)
    return units


@pytest.mark.parametrize("keyspace,unit,completed", [
    (17576, 4096, []),
    (17576, 4096, [(0, 5000)]),                       # --skip
    (17576, 1000, [(0, 100), (12100, 17576)]),        # --skip --limit
    (10, 3, [(2, 4), (7, 8)]),                        # gaps below the frontier
])
def test_dispatcher_matches_reference(keyspace, unit, completed):
    if completed:
        ours = Dispatcher.from_completed(keyspace, unit, completed)
        ref = RefDispatcher.from_completed(keyspace, unit, completed)
    else:
        ours, ref = Dispatcher(keyspace, unit), RefDispatcher(keyspace, unit)
    assert ours.progress() == ref.progress()
    assert _sweep(ours) == _sweep(ref)
    assert ours.completed_intervals() == ref.completed_intervals() == \
        [(0, keyspace)]
    assert ours.exhausted() and ref.exhausted()
    assert ours.lease() is None
    assert not ours.complete(0)          # a second completion is a no-op


@pytest.mark.parametrize("plain", [b"abc", b"a:b", b"\x00\xff", b"",
                                   b"$HEX[41]", "é".encode()])
def test_potfile_text_matches_reference(tmp_path, plain):
    assert potfile.encode_plain(plain) == ref_potfile.encode_plain(plain)
    text = potfile.encode_plain(plain)
    assert potfile.decode_plain(text) == ref_potfile.decode_plain(text)
    ours, ref = tmp_path / "ours.pot", tmp_path / "ref.pot"
    potfile.Potfile(str(ours)).add("k", plain)
    ref_potfile.Potfile(str(ref)).add("k", plain)
    assert ours.read_text() == ref.read_text()
    assert potfile.Potfile(str(ref)).get("k") == plain


def test_hashlist_matches_reference():
    d = hashlib.md5(b"x").hexdigest()
    lines = ["# comment", "", d, d.upper(), "zz", "abc123",
             hashlib.md5(b"y").hexdigest()]
    ours = parse_lines(get_engine("md5"), lines)
    ref = ref_parse_lines(RefMd5Engine(), lines)
    assert [(t.raw, t.digest) for t in ours.targets] == \
        [(t.raw, t.digest) for t in ref.targets]
    assert ours.skipped == ref.skipped
    assert ours.duplicates == ref.duplicates == 1


def test_registry():
    assert engine_class("md5", "cuda") is TorchMd5Engine
    assert engine_class("sha-1", "cuda") is engine_class("sha1", "cuda")
    with pytest.raises(KeyError):
        get_engine("md5crypt", device="cuda")
    assert get_engine("sha-512", device="cuda").name == "sha512"
    with pytest.raises(KeyError):
        get_engine("md5", device="tpu")
