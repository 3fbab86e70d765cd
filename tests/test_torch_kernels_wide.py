"""The port's conv2d_shard against the Pallas kernel in interpret mode on
the 5x5 and 7x7 geometries of the reference's conformance grid (the rest
of the grid is in ``test_torch_kernels.py``; the two files run on separate
workers)."""
import pytest

from torch_conformance import CONV_GEOMS, check_conv_grid, geom_id

WIDE = [g for g in CONV_GEOMS if g[1] > 3]


@pytest.mark.parametrize("t,k,s,p", WIDE, ids=[geom_id(g) for g in WIDE])
def test_conv_grid_all_halo_pads(t, k, s, p):
    check_conv_grid(t, k, s, p)
