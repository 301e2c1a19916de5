"""Slice N end to end against the reference's own device path, the two
families whose XLA steps take longest to compile: mysql41 (sha1 over the
raw sha1 digest) and Kerberos etype 23 (krb5tgs) -- as
test_torch_slice_n_jax.py does for the others, in a file of their own so
that the two halves (about 16 s and 19 s by pytest's count) run on
different workers.
"""

import pytest

from test_torch_slice_n_jax import same_as_the_device_path

pytestmark = pytest.mark.smoke


@pytest.mark.parametrize("name", ["mysql41", "krb5tgs"])
def test_cli_matches_the_reference_device_path(tmp_path, capsys, name):
    same_as_the_device_path(tmp_path, capsys, name)
