"""The seed moves the run's entry on the lap and translates the camera by
less than half a cell; it never changes the lap's set of views."""

import json

import numpy as np
import pytest

from port_bench import paths
from port_bench.tests.conftest import HERE

TRAFFIC = sorted(p.stem for p in (HERE / "traffic").glob("*.json"))


@pytest.mark.parametrize("name", TRAFFIC)
def test_seed_changes_the_views_not_the_lap(name):
    tr = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    n, zmax = 4097, 491.5
    eyes, targets = paths.lap_views(tr, n, zmax)
    assert eyes.shape == (tr["frames_per_lap"], 3) and np.isfinite(eyes).all()
    runs = []
    for seed in (0, 1, 2**31 + 77):
        e, t, checked = paths.seeded_lap(tr, n, zmax, seed)
        shift = e[0] - eyes[np.argmin(np.abs(eyes - e[0]).sum(1))]
        assert np.all(np.abs(shift[:2]) <= tr["jitter_cells"]) and shift[2] == 0
        # the same views, in another order: undo the shift and match the lap
        back = e - shift
        order = [int(np.argmin(np.abs(eyes - b).sum(1))) for b in back]
        assert sorted(order) == list(range(len(eyes)))
        assert np.allclose(back, eyes[order], atol=1e-3)
        assert np.allclose(t - shift, targets[order], atol=1e-3)
        assert len(checked) == tr["check_frames"] and max(checked) < tr["check_span"]
        runs.append(e)
    assert not np.allclose(runs[0], runs[1])


def test_orbit_is_the_published_flythrough():
    """The replayed orbit's keys are api/flythrough.py::orbit_flythrough's."""
    tr = json.loads((HERE / "traffic" / "orbit.json").read_text())
    n, zmax = 8192, 983.0
    eyes, targets = paths.lap_views(tr, n, zmax)
    c = (n - 1) / 2.0
    assert np.allclose(eyes[0], [c + 0.42 * n, c, zmax + 0.10 * n], atol=1e-2)
    assert np.allclose(targets[0], [c, c, 0.4 * zmax])
