"""chip_smoke.py [streams]'s fixture (tests/data/jax_streams.npz, written
by tests/jax_streams_fixture.py): it still equals what JAX gives, and the
port's replica (engine/jax_streams.py compare_fixture) equals it here as
the smoke requires on the card's host."""

import numpy as np

from lab4d_tpu_torch.engine import jax_streams
from tests import jax_streams_fixture as F


def test_fixture_equals_jax():
    fixture = np.load(F.PATH)
    want = F.jax_values(jax_streams.FIXTURE_SPEC)
    assert set(want) == set(fixture.files) - {"spec", "versions"}
    for name, v in want.items():
        np.testing.assert_array_equal(fixture[name], v, err_msg=name)


def test_port_replica_equals_fixture():
    rows = jax_streams.compare_fixture(np.load(F.PATH))
    assert len(rows) == len(np.load(F.PATH).files) - 2
    bad = [r for r in rows if r[1] > r[2]]
    assert not bad, bad
    # every entry bit for bit here, the normal draws included
    assert all(r[1] == 0 for r in rows), rows
