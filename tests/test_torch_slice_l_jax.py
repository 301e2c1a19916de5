"""Slice L end to end against the reference's own device path: for one
name of each family -- the fast hashes (sha224), mysql323, the sha512
salts (sha512-ps) and MSSQL (mssql2005) -- ``crack --device torch-cpu``
against the reference CLI's ``--device jax`` (its XLA steps on the CPU,
a small batch) on the same hashlist: the same found set and potfile.
"""

import pytest

from dprf_tpu.cli import main as ref_main
from dprf_tpu_torch.cli import main as port_main
from test_torch_slice_l_cli import crack, hashlist

pytestmark = pytest.mark.smoke

MASK = "?l?l"


@pytest.mark.parametrize("name", ["sha224", "mysql323", "sha512-ps",
                                  "mssql2005"])
def test_cli_matches_the_reference_device_path(tmp_path, capsys, name):
    lines = hashlist(name, MASK, 11)
    extra = ("--batch", "256")
    want = crack(ref_main, tmp_path, capsys, name, MASK, lines, "jax", "ref",
                 extra)
    got = crack(port_main, tmp_path, capsys, name, MASK, lines, "torch-cpu",
                "port", extra)
    assert got == want
    assert want[0] == 0 and len(want[1]) == 3
