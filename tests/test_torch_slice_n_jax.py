"""Slice N end to end against the reference's own device path: for one
name of each family -- a salted core (md5-sp), a line format on one
(postgres), MSSQL 2000's uppercase (mssql2000), the nested chains
(md5(md5); mysql41 in test_torch_slice_n_jax2.py), sha224 and mysql323
-- ``crack -a wordlist --device torch-cpu`` against the reference CLI's
``--device jax`` (its XLA wordlist workers on the CPU, a small batch) on
the same word list, rules and hashlist: the same found set and potfile.
"""

import pytest

from dprf_tpu.cli import main as ref_main
from dprf_tpu_torch.cli import main as port_main
from test_torch_slice_n_cli import crack, hashlist

pytestmark = pytest.mark.smoke


def same_as_the_device_path(tmp_path, capsys, name) -> None:
    """``name``'s wordlist job on the port's torch-cpu and the
    reference's jax: the same found set and potfile, every plant found."""
    lines, words, rules = hashlist(tmp_path, name, 5)
    want = crack(ref_main, tmp_path, capsys, name, words, rules, lines,
                 "jax", "ref")
    got = crack(port_main, tmp_path, capsys, name, words, rules, lines,
                "torch-cpu", "port")
    assert got == want
    assert want[0] == 0 and len(want[1]) == 3


@pytest.mark.parametrize("name", ["md5-sp", "postgres", "mssql2000",
                                  "md5(md5)", "sha224", "mysql323"])
def test_cli_matches_the_reference_device_path(tmp_path, capsys, name):
    same_as_the_device_path(tmp_path, capsys, name)
