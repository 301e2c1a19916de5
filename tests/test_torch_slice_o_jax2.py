"""Slice O end to end against the reference's own device path, the
salted names: sha512's ``$pass.$salt`` and MSSQL 2012's UTF-16LE
candidate with its salt after it (the reference's SaltedWordlistWorker
on the CPU), and a Keccak list at the 512-bit width -- as
test_torch_slice_o_jax.py does for the unsalted cores, in a file of its
own so that the two halves run on different workers.
"""

import pytest

from test_torch_slice_o_cli import same_as_the_reference

pytestmark = pytest.mark.smoke


@pytest.mark.parametrize("name,n_plants", [("sha512-ps", 4),
                                           ("mssql2012", 4),
                                           ("keccak-512", 4)])
def test_cli_matches_the_reference_device_path(tmp_path, capsys, name,
                                               n_plants):
    same_as_the_reference(tmp_path, capsys, name, "jax", n_plants)
