"""End to end: the port's CLI (``--device torch-cpu`` and ``--device
cpu``) against the reference CLI (``--device tpu`` on CPU XLA) on the
same planted ?l?l?l hashlist; the found set and the potfile must be
equal, byte for byte."""

import hashlib

import pytest

from dprf_tpu.cli import main as ref_main
from dprf_tpu_torch.cli import main as port_main

MASK = "?l?l?l"


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


def _crack(main, tmp_path, capsys, device, plain, tag, extra=()):
    digest = hashlib.md5(plain).hexdigest()
    hashfile = tmp_path / f"{tag}.txt"
    hashfile.write_text(f"# planted\n{digest}\n")
    pot = tmp_path / f"{tag}.pot"
    rc, out = _run(main, ["crack", MASK, str(hashfile), "--engine", "md5",
                          "--device", device, "--potfile", str(pot),
                          "--batch", "1024", "--unit-size", "4096", "-q",
                          *extra], capsys)
    found = sorted(ln for ln in out.splitlines() if ":" in ln)
    return rc, found, pot.read_text() if pot.exists() else ""


@pytest.fixture(scope="module")
def ref_results(tmp_path_factory):
    """The reference CLI's results, once per planted word and flags."""
    return {}


@pytest.mark.parametrize("device", ["torch-cpu", "cpu"])
@pytest.mark.parametrize("plain,extra,found", [
    (b"aaa", (), True),                     # first index
    (b"zzz", (), True),                     # last index, partial batch
    (b"qjx", (), True),                     # index 11073
    (b"qjx", ("--skip", "12000"), False),
    (b"qjx", ("--skip", "100", "--limit", "12000"), True),
])
def test_found_set_and_potfile_match_reference(tmp_path, capsys, device,
                                               plain, extra, found,
                                               ref_results):
    key = (plain, extra)
    if key not in ref_results:
        ref_results[key] = _crack(ref_main, tmp_path, capsys, "tpu", plain,
                                  "ref", extra)
    want = ref_results[key]
    got = _crack(port_main, tmp_path, capsys, device, plain, "port", extra)
    assert got == want
    if found:
        assert want[0] == 0
        assert want[1] == [f"{hashlib.md5(plain).hexdigest()}:"
                           f"{plain.decode()}"]
    else:
        assert want[0] == 1 and want[1] == [] and want[2] == ""


def test_potfile_preload_skips_cracked(tmp_path, capsys):
    digest = hashlib.md5(b"abc").hexdigest()
    hashfile = tmp_path / "h.txt"
    hashfile.write_text(digest + "\n")
    pot = tmp_path / "p.pot"
    pot.write_text(f"{digest}:abc\n")
    rc, out = _run(port_main, ["crack", MASK, str(hashfile), "--engine",
                               "md5", "--device", "torch-cpu", "--potfile",
                               str(pot), "-q"], capsys)
    assert rc == 0 and out.splitlines() == [f"{digest}:abc"]
    assert pot.read_text() == f"{digest}:abc\n"


def test_engines_and_keyspace(capsys):
    assert _run(port_main, ["engines"], capsys) == (0, "cpu: md5\ncuda: md5\n")
    assert _run(port_main, ["keyspace", "?l?l?l?l?l?l"], capsys) == \
        (0, "308915776\n")
    assert _run(port_main, ["keyspace", "?1?d", "--custom1", "abc"],
                capsys) == (0, "30\n")
