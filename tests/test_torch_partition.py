"""The port's own copy of the domain decomposition
(calibr8_tpu_torch/parallel/partition.py, numpy only) against
calibr8_tpu's parallel/partition.py: on the same connectivity and
coordinates, build_partition gives equal Partitions, field for field,
the local ELL maps (nbr_local, ell_idx_local, K_ell) included, on notch2D
h=0.1 and cube n=3 at 1, 4, 5 and 8 parts (5: a count that is not a
power of two)."""

import dataclasses

import numpy as np
import pytest

from calibr8_tpu.parallel.partition import build_partition as jax_build_partition
from calibr8_tpu_torch.mesh import generators
from calibr8_tpu_torch.parallel.partition import build_partition

MESHES = {"notch2D h=0.1": lambda: generators.notch2d(0.1), "cube n=3": lambda: generators.cube(3)}


@pytest.mark.parametrize("n_parts", [1, 4, 5, 8])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_partition_equals_calibr8_tpu(mesh, n_parts):
    m = MESHES[mesh]()
    conn, coords = np.asarray(m.conn), np.asarray(m.coords)
    ref = jax_build_partition(conn, coords, n_parts)
    got = build_partition(conn, coords, n_parts)
    names = [f.name for f in dataclasses.fields(ref)] + ["nbr_local", "ell_idx_local", "K_ell"]
    for name in names:
        a, b = getattr(got, name), getattr(ref, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name
    assert got.n_elem_total == m.n_elems
