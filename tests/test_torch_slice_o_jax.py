"""Slice O end to end against the reference's own device path: the
64-bit cores and the sponge -- ``crack -a wordlist --device torch-cpu``
against the reference CLI's ``--device jax`` (its XLA wordlist workers,
DeviceWordlistWorker for sha512 and KeccakWordlistWorker for the sponge,
on the CPU, a small batch) on the same word list, rules and hashlist,
with one target and with a list: the same found set and potfile, a word
of the name's max_len among the plants (sha3-224's 143 bytes: the pad
byte and 0x80 in one byte).  The salted names are
test_torch_slice_o_jax2.py's.
"""

import pytest

from test_torch_slice_o_cli import same_as_the_reference

pytestmark = pytest.mark.smoke


@pytest.mark.parametrize("name,n_plants", [("sha512", 1), ("sha512", 4),
                                           ("sha3-224", 4),
                                           ("keccak-256", 1)])
def test_cli_matches_the_reference_device_path(tmp_path, capsys, name,
                                               n_plants):
    same_as_the_reference(tmp_path, capsys, name, "jax", n_plants)
