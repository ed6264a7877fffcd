"""The port's point-cloud gridding (hmrt_tpu_torch/io/pointcloud.py)
against the JAX package's on the same points and files."""

import numpy as np
import pytest

from hmrt_tpu.io import pointcloud as jpc
from hmrt_tpu_torch.io import pointcloud as tpc


@pytest.mark.parametrize("agg", ["max", "mean"])
@pytest.mark.parametrize("n", [16, 33])
def test_grid_points_equals_jax(agg, n):
    pts = np.random.default_rng(n).uniform(0, 100, (3000, 3)).astype(np.float32)
    np.testing.assert_array_equal(tpc.grid_points(pts, n, agg=agg),
                                  jpc.grid_points(pts, n, agg=agg))


def test_holes_filled_like_jax():
    pts = np.array([[0, 0, 1], [99, 0, 2], [0, 99, 3], [99, 99, 4]], np.float32)
    got = tpc.grid_points(pts, 16)
    np.testing.assert_array_equal(got, jpc.grid_points(pts, 16))
    assert np.isfinite(got).all() and 1.0 <= got.min() <= got.max() <= 4.0
    with pytest.raises(ValueError, match="agg"):
        tpc.grid_points(pts, 16, agg="median")
    with pytest.raises(ValueError, match="no points"):
        tpc.grid_points(np.zeros((0, 3), np.float32), 16)


def test_load_points_and_heightmap(tmp_path):
    pts = np.random.default_rng(1).uniform(0, 50, (400, 3)).astype(np.float32)
    for name in ("c.xyz", "c.csv", "c.npy"):
        p = str(tmp_path / name)
        if name.endswith(".npy"):
            np.save(p, pts)
        else:
            np.savetxt(p, pts, delimiter="," if name.endswith(".csv") else " ")
        np.testing.assert_array_equal(tpc.load_points(p), jpc.load_points(p))
        np.testing.assert_array_equal(tpc.load_pointcloud_heightmap(p, n=64, z_scale=5.0),
                                      jpc.load_pointcloud_heightmap(p, n=64, z_scale=5.0))
    bad = tmp_path / "bad.xyz"
    bad.write_text("1 2 3\n4 5\n")
    with pytest.raises(ValueError, match="divisible"):
        tpc.load_points(str(bad))
