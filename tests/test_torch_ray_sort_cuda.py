"""The ray sort kernel (kernels/csrc/ray_sort.cu) against its plain torch
version, on the card.

Every test here needs a CUDA device and skips without one (a CUDA kernel
has no interpret mode). On a machine with a card:
    HMRT_TEST_TPU=1 python -m pytest tests/test_torch_ray_sort_cuda.py -q
"""

import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import hmrt_tpu_torch as T
from hmrt_tpu_torch.bench.configs import BENCH_CONFIGS, bench_scene
from hmrt_tpu_torch.core.renderer import render_frame
from hmrt_tpu_torch.kernels import compact
from hmrt_tpu_torch.kernels.compact import frame_graphs, render_frame_compact
from hmrt_tpu_torch.kernels.ray_sort import (column_key, force_level0, ray_sort,
                                             ray_sort_reference, ray_unsort)
from hmrt_tpu_torch.utils import profiling
from test_torch_ray_sort import sort_planes

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _assert_round(rays, state, res, perm_in, dev, **kw):
    """The kernel's round on the card equals the plain version's on the
    CPU: the permutation, every plane and the flag."""
    def cuda(planes):
        return None if planes is None else tuple(x.to(dev) for x in planes)
    got = ray_sort(cuda(rays), cuda(state), cuda(res),
                   None if perm_in is None else perm_in.to(dev, torch.int32), **kw)
    want = ray_sort_reference(rays, state, res, perm_in, **kw)
    for k, (g, w) in enumerate(zip(got[:3], want[:3])):
        assert (g is None) == (w is None)
        for x, y in zip(g or (), w or ()):
            assert x.dtype == y.dtype and torch.equal(x.cpu(), y), k
    assert got[3].dtype == torch.int32 and torch.equal(got[3].cpu().long(), want[3])
    if kw.get("tail") == "auto":
        assert got[4].shape == (1,) and bool(got[4].cpu()) == bool(want[4])
    else:
        assert got[4] is want[4]
    return got


#: (lanes, m, kind): B3's and B4's sorted rounds (2,073,600 and 921,600
#: lanes at m 4096 and 8192, 15- and 17-bit keys), a count not a multiple
#: of the tile, one lane, every lane dead, every lane in one column, the m
#: of tiled sub-scenes (one digit; two of 6 and 5 bits) and a 21-bit key
#: (three digits)
ROUNDS = [(2_073_600, 4096, "mixed"), (921_600, 8192, "mixed"), (100_003, 4096, "mixed"),
          (1, 4096, "mixed"), (70_001, 4096, "dead"), (50_000, 1024, "one_column"),
          (33_333, 256, "mixed"), (40_000, 1024, "mixed"), (5_000, 32, "mixed"),
          (60_000, 32768, "mixed")]


@pytest.mark.parametrize("p, m, kind", ROUNDS)
def test_permutation_and_planes_equal_the_stable_argsort_chain(cuda, p, m, kind):
    rays, state, res = sort_planes(p, m, seed=p + m, kind=kind)
    m5 = max(m // 32, 1)
    got = _assert_round(rays, state, res, None, cuda, m5=m5, moving=(3, 4, 5))
    assert torch.equal(got[3].cpu().long(), torch.argsort(column_key(state, m5), stable=True))
    perm_in = torch.randperm(p, generator=torch.Generator().manual_seed(p))
    _assert_round(rays, state, None, perm_in, cuda, m5=m5, moving=(0, 1, 2))


@pytest.mark.parametrize("tail, kind", [(True, "mixed"), ("auto", "l0"), ("auto", "mixed"),
                                        ("auto", "dead")])
@pytest.mark.parametrize("p, m", [(2_073_600, 4096), (921_600, 8192), (4_097, 512)])
def test_tail_round_equals_force_level0_then_the_chain(cuda, p, m, tail, kind):
    """A tail round forces level 0 (always, or by the "auto" flag, which the
    key pass writes for the march kernel) and sorts by the forced column."""
    rays, state, res = sort_planes(p, m, seed=3 * p + m, kind=kind)
    m5 = max(m // 32, 1)
    perm_in = torch.randperm(p, generator=torch.Generator().manual_seed(m))
    got = _assert_round(rays, state, res, perm_in, cuda, m5=m5, moving=(3, 4, 5), tail=tail)
    forced = tail is True or kind == "l0"
    want = force_level0(rays, state) if forced else state
    assert torch.equal(got[3].cpu().long(), perm_in[torch.argsort(column_key(want, m5),
                                                                  stable=True)])


def test_unsort_inverts_the_running_permutation(cuda):
    rays, state, res = sort_planes(1_000_003, 4096, seed=9, device=cuda)
    _, _, res2, perm, _ = ray_sort(rays, state, res, None, m5=128, moving=(3, 4, 5))
    for keep in (res2, res2[:1]):
        back = ray_unsort(keep, perm)
        for x, y in zip(res, back):
            assert torch.equal(x, y)


def _plain(monkeypatch):
    """Make the compact path take the plain chain on the card."""
    monkeypatch.setattr(compact, "ray_sort", ray_sort_reference)
    monkeypatch.setattr(compact, "ray_unsort", lambda planes, perm: tuple(
        torch.empty_like(x).index_copy_(0, perm, x) for x in planes))


def _assert_frames(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert (x is None) == (y is None), f.name
        if x is not None:
            assert torch.equal(x, y), f.name


@pytest.mark.parametrize("name", ["B3", "B4"])
def test_frames_equal_the_plain_chain_eager_and_replayed(cuda, name, monkeypatch):
    """B3's and B4's compact frames, eager, captured and replayed, equal the
    plain chain's frames bit for bit, and every march pass's per-lane
    counts are in the same lane order."""
    cfg = BENCH_CONFIGS[name]
    scene, cam, terr = bench_scene(cfg, device=cuda)
    view = T.Camera.create(eye=(cfg.map_n * 0.3, cfg.map_n * 0.2, float(terr.max()) + 40.0),
                           target=(cfg.map_n * 0.6, cfg.map_n * 0.7, float(terr.mean())),
                           fov_y_deg=55.0, device=cuda)
    rc = cfg.render
    counts = {"primary": [], "shadow": []}
    eager = render_frame_compact(scene, cam, rc, counts=counts)
    frames = [render_frame(scene, c, rc) for c in (cam, cam, view, cam)]
    torch.cuda.synchronize()
    with monkeypatch.context() as mp:
        _plain(mp)
        plain_counts = {"primary": [], "shadow": []}
        plain = render_frame_compact(scene, cam, rc, counts=plain_counts)
        plain_view = render_frame_compact(scene, view, rc)
    _assert_frames(eager, plain)
    for fr, want in zip(frames, (plain, plain, plain_view, plain)):
        _assert_frames(fr, want)
    for k in counts:
        assert len(counts[k]) == len(plain_counts[k])
        for x, y in zip(counts[k], plain_counts[k]):
            assert torch.equal(x, y), k
    assert 0 < int(eager.hit.sum()) < eager.hit.numel()


class _Ops(TorchDispatchMode):
    """The aten ops a frame runs, with the port's spans open at each."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.append((func.overloadpacket.__name__, profiling.open_spans()))
        return func(*args, **(kwargs or {}))


def test_sorted_rounds_run_no_torch_sort_gather_or_scatter(cuda):
    """On the card no argsort, sort, index_select or index_copy is left in
    a sorted round or the unsort."""
    sc = T.make_scene(T.procedural_terrain(1025, seed=3), device=cuda)
    cam = T.Camera.create(eye=(512.0, -150.0, 300.0), target=(512.0, 512.0, 40.0), device=cuda)
    rc = T.RenderConfig(width=320, height=180, shadows=True, backend="compact")
    ops = _Ops()
    with profiling.tracing(), ops:
        render_frame_compact(sc, cam, rc)
    in_sort = {op for op, spans in ops.seen if {"hmrt.sort", "hmrt.unsort"} & set(spans)}
    assert any("hmrt.sort" in spans for _, spans in ops.seen)
    assert not in_sort & {"argsort", "sort", "index_select", "index_copy", "index_copy_"}


def test_the_launch_count_is_one_reorder_a_sorted_round(cuda):
    """ray_sort.launches counts one reorder a sorted round: 4 a shadowed
    frame, 2 without shadow rays, and replayed frames count theirs."""
    sc = T.make_scene(T.procedural_terrain(1025, seed=3), device=cuda)
    cam = T.Camera.create(eye=(512.0, -150.0, 300.0), target=(512.0, 512.0, 40.0), device=cuda)
    for shadows, per_frame in ((True, 4), (False, 2)):
        rc = T.RenderConfig(width=368, height=200 + shadows, shadows=shadows, backend="compact")
        before, tally = ray_sort.launches, frame_graphs.read()
        for _ in range(5):
            render_frame(sc, cam, rc)
        now = frame_graphs.read()
        assert {k: now[k] - tally[k] for k in now} == {"eager": 1, "captured": 1, "replayed": 3}
        assert ray_sort.launches - before == 5 * per_frame
