"""Compacted-wavefront renderer: budgeted march passes + ray sorting.

Counterpart of the legacy flow of `hmrt_tpu/kernels/compact.py`
(`fold_inv=False`). Rays are generated and initialised in torch, and the
ray state lives in flat per-lane planes. A march pass (`march_pass`, CUDA
kernel 1) steps every live ray up to a budget. Between passes the
survivors are SORTED by their current 32-cell terrain column (`ray_sort`,
kernels/ray_sort.py: a stable counting sort of the column key and one
gather of the planes), so the rays of a thread block march through nearby
terrain; the last round is unbudgeted, so every ray resolves. Results
return to launch order by one scatter through the composed permutation
(`ray_unsort`). The shade pass (`shade_pass`, CUDA kernel 2) then
runs in launch order, the shadow march repeats the sorted rounds from the
hit cells, and the colour pass (`shade_color`, kernels/shade_color.py:
Lambert, occlusion, Phong, fog, sky and the clip) writes the Frame's
planes in one launch.

The schedule only decides which rays march when: any (first_budget,
rounds, round_budget) gives the same frame, because each ray's march is
deterministic and independent of the others. The TPU package's other
knobs (n_col, subserve, band_tail, unroll, banks, sort_dir, sort_mode,
fold_inv, coarse0, prefix schedules) tuned its Mosaic schedule and are not
ported.

The tail, as in the JAX package: the last sorted round of the primary and
of the shadow march may run as the forced-level-0 tail (`l0_tail`). Its
survivors are first descended to the level-0 cell at their position
(ray_sort.py::force_level0, so the sort key is their level-0 column), then march the
level-0 DDA with the exact test, skipping no cell whose max they do not
clear, but passing under whole blocks of the min pyramid (march_pass.py).
That gives up skips the max pyramid could still take and never changes a
hit, so every `l0_tail` gives the same frame. "auto" forces the tail when
more than ray_sort.py::L0_TAIL_AUTO_THRESH of the survivors are at level 0,
decided on the device (a flag the kernel reads), with no host wait. `relax=k` runs the
relaxed stride tail there instead: not exact (a feature narrower than k
cells along a ray can be tunnelled; no false hits), opt-in.

Stage spans (utils/profiling.py, while the port's tracing is armed):
"hmrt.raygen" (the primary rays and their start state), "hmrt.primary"
(the primary march), in each march "hmrt.march.pass0", "hmrt.march.round"
and "hmrt.march.tail" around each kernel launch, "hmrt.sort" around a
sorted round's reorder (`ray_sort`: key, sort and gathers) and
"hmrt.unsort" around the scatter back, "hmrt.shade" (shade data, colour
pass) and inside it "hmrt.shadow" (the shadow rays and their march) and,
with fog, "hmrt.shade.fog" (`apply_fog` in the colour pass's plain
version: on the CPU; the CUDA colour pass launches no op inside it).

Frame graphs: a compact frame holds no host wait and no host decision
(every pass runs over the same P lanes, the "auto" tail is a device flag),
so `render_frame` (core/renderer.py) renders it through `frame_graphs`:
the second frame in a row of one scene, config and camera shape captures
`render_frame_compact` as one CUDA graph, and the frames after it replay
that graph (`FrameGraphs`).
"""

from __future__ import annotations

import dataclasses
import threading
import weakref

import torch

from hmrt_tpu_torch.config import RenderConfig
from hmrt_tpu_torch.core.renderer import SHADOW_EPS
from hmrt_tpu_torch.kernels.march_pass import UNBUDGETED, launch_pass, march_pass
from hmrt_tpu_torch.kernels.ray_sort import ray_sort, ray_unsort
from hmrt_tpu_torch.kernels.shade_color import shade_color
from hmrt_tpu_torch.kernels.shade_pass import shade_pass
from hmrt_tpu_torch.traversal.intersect import BIG_T
from hmrt_tpu_torch.traversal.march import entry_cell, ray_box_range
from hmrt_tpu_torch.types import Camera, Frame, Scene
from hmrt_tpu_torch.utils.profiling import armed, span

#: Default schedule. Pass 0 in launch order resolves sky and near hits
#: cheaply; each later round first sorts the survivors by terrain column.
#: Chosen as a simple start, not tuned yet on the H100 (see PERF.md).
FIRST_BUDGET = 64
ROUNDS = 2
ROUND_BUDGET = 256


def primary_rays(camera: Camera, config: RenderConfig, row0: int | None = None,
                 full_height: int | None = None):
    """Launch-order ray planes (ox, oy, oz, dx, dy, dz), each f32[H*W].
    `row0`/`full_height`: the rays of rows [row0, row0 + H) of a
    full_height-row screen, the same bits as those rows of the full grid."""
    eye, dirs = camera.rays(config.height, config.width, row0, full_height)
    d = dirs.reshape(-1, 3)
    p = d.shape[0]
    return (tuple(eye[i].expand(p).contiguous() for i in range(3))
            + tuple(d[:, i].contiguous() for i in range(3)))


def init_state(rays, valid0, gmax, *, n: int, m: int, levels: int,
               clip=None, start_cell=None):
    """Initial march state (alive, t, lvl, icx, icy), with the sky
    early-out. `start_cell=(cx, cy)`: begin at level 0 in that cell
    instead of at the pyramid top (the shadow rays, whose origins sit in
    the primary hit cells; any start level is exact)."""
    ox, oy, oz, dx, dy, dz = rays
    t0, _, valid = ray_box_range(ox, oy, dx, dy, float(n - 1), clip)
    if valid0 is not None:
        valid = valid & valid0
    valid = valid & ~((oz + t0 * dz > gmax) & (dz >= 0.0))
    if start_cell is not None:
        lvl = torch.zeros_like(start_cell[0])
        icx = torch.clamp(start_cell[0], 0, m - 1)
        icy = torch.clamp(start_cell[1], 0, m - 1)
    else:
        lvl = torch.full(ox.shape, levels - 1, dtype=torch.int32, device=ox.device)
        icx, icy = entry_cell(ox, oy, dx, dy, t0, levels - 1, 1)
    return (valid.to(torch.int32), torch.where(valid, t0, BIG_T), lvl, icx, icy)


def check_l0_tail(l0_tail, relax: int) -> None:
    """Raise unless l0_tail is True, False or "auto" and relax fits it."""
    if l0_tail not in (True, False, "auto"):
        raise ValueError(f"l0_tail must be True, False or 'auto', not {l0_tail!r}")
    if relax < 0:
        raise ValueError(f"relax {relax} < 0")
    if relax and l0_tail is False:
        # without the tail relax would do nothing and the frame would be exact
        raise ValueError("relax > 0 needs the level-0 tail (l0_tail=True, or 'auto' to "
                         "relax only when the tail is chosen)")


def march_rounds(rays, state, scene: Scene, *, cell_intersect: str, clip,
                 first_budget: int, rounds: int, round_budget: int,
                 moving: tuple, skip_pass0: bool = False, counts: list | None = None,
                 l0_tail: bool | str = "auto", relax: int = 0, keep: tuple = (0, 1, 2, 3)):
    """Pass 0 in launch order, then `rounds` sorted rounds (the last one
    unbudgeted, and the tail under `l0_tail`/`relax`, module docstring).
    `moving` names the ray planes that differ per ray and so ride the sort;
    the others are one value broadcast. Returns the result planes (hit,
    t_hit, hx, hy) at the indices `keep`, in launch order. `counts`, a
    list, takes each pass's (2, P) per-ray steps and cell tests, in that
    pass's lane order (march_pass's counting instance). Each pass launches
    through `launch_pass`, without `march_pass`'s checks: every plane it is
    handed is made here, from the scene (march_pass.py). Each sorted round
    reorders through `ray_sort`, and the results go back through
    `ray_unsort` (kernels/ray_sort.py)."""
    check_l0_tail(l0_tail, relax)
    p = rays[0].shape[0]
    res = empty_results(p, rays[0].device)
    kw = dict(n=scene.n, m=scene.m, levels=scene.levels,
              cell_intersect=cell_intersect, clip=clip)

    def run(name, rays, state, res, budget, tail=False):
        with span(name):
            cnt = None
            if counts is not None:
                cnt = torch.empty((2, p), dtype=torch.int32, device=rays[0].device)
                counts.append(cnt)
            return launch_pass(rays, state, res, scene.pyr_flat, scene.heights,
                               scene.corners, budget=budget, counts=cnt, l0_only=tail,
                               relax=0 if tail is False else relax,
                               pyr_min=scene.pyr_min_flat, **kw)

    # the results stay the constant empty planes until a pass has run
    fresh = skip_pass0 or first_budget <= 0
    if not fresh:
        state, res = run("hmrt.march.pass0", rays, state, res, first_budget)
    m5 = max(scene.m // 32, 1)
    perm_tot = None
    for r in range(rounds):
        last = r == rounds - 1
        with span("hmrt.sort"):
            rays, state, moved, perm_tot, tail = ray_sort(
                rays, state, None if fresh else res, perm_tot, m5=m5, moving=moving,
                tail=l0_tail if last else False)
            res = res if fresh else moved
        state, res = run("hmrt.march.tail" if last and l0_tail else "hmrt.march.round",
                         rays, state, res, UNBUDGETED if last else round_budget, tail)
        fresh = False
    # back to launch order: lane k of the sorted planes is launch lane perm_tot[k]
    with span("hmrt.unsort"):
        return ray_unsort(tuple(res[i] for i in keep), perm_tot)


def march_shadows(srays, sstate, scene: Scene, *, cell_intersect: str, clip,
                  first_budget: int = FIRST_BUDGET, rounds: int = ROUNDS,
                  round_budget: int = ROUND_BUDGET, counts: list | None = None,
                  l0_tail: bool | str = "auto", relax: int = 0):
    """The shadow march of a compact frame: min(rounds, 2) sorted rounds
    from the rays' start state and no pass 0, the last one the tail as in
    `march_rounds`. Only the origin planes differ per ray (the direction is
    the sun's). Returns the hit plane in launch order (the only result
    plane it scatters back); `counts` as in `march_rounds`."""
    return march_rounds(srays, sstate, scene, cell_intersect=cell_intersect, clip=clip,
                        first_budget=first_budget, rounds=min(rounds, 2),
                        round_budget=round_budget, moving=(0, 1, 2), skip_pass0=True,
                        counts=counts, l0_tail=l0_tail, relax=relax, keep=(0,))[0]


def hit_points(rays, hit, t_hit, hx, hy):
    """World hit points (px, py, pz) and the offsets (fx, fy) inside the
    hit cell, clamped to [0, 1]."""
    ox, oy, oz, dx, dy, dz = rays
    ts = torch.where(hit, t_hit, 0.0)
    px = ox + ts * dx
    py = oy + ts * dy
    pz = oz + ts * dz
    fx = torch.clamp(px - hx.to(torch.float32), 0.0, 1.0)
    fy = torch.clamp(py - hy.to(torch.float32), 0.0, 1.0)
    return (px, py, pz), fx, fy


def shadow_start(points, normal, hit, hx, hy, scene: Scene, clip=None):
    """Shadow rays toward the sun from just above each hit point (offset
    by SHADOW_EPS along the sun and the normal; misses are parked outside
    the map), and their initial state at level 0 in the hit cell."""
    px, py, pz = points
    nx, ny, nz = normal
    lx, ly, lz = scene.light.sun_dir[0], scene.light.sun_dir[1], scene.light.sun_dir[2]
    p = px.shape[0]
    sxo = px + lx * SHADOW_EPS + nx * SHADOW_EPS
    syo = py + ly * SHADOW_EPS + ny * SHADOW_EPS
    szo = pz + lz * SHADOW_EPS + nz * SHADOW_EPS
    srays = (torch.where(hit, sxo, -1e6), torch.where(hit, syo, -1e6), szo,
             lx.expand(p).contiguous(), ly.expand(p).contiguous(),
             lz.expand(p).contiguous())
    sstate = init_state(srays, hit, scene.pyr_flat[-1], n=scene.n, m=scene.m,
                        levels=scene.levels, clip=clip, start_cell=(hx, hy))
    return srays, sstate


def empty_results(p: int, dev):
    """Result planes (hit, t_hit, hx, hy) of P rays that have not hit."""
    return (torch.zeros(p, dtype=torch.int32, device=dev),
            torch.full((p,), BIG_T, dtype=torch.float32, device=dev),
            torch.zeros(p, dtype=torch.int32, device=dev),
            torch.zeros(p, dtype=torch.int32, device=dev))


def shade_frame(scene: Scene, config: RenderConfig, rays, hit_i, t_hit, hx, hy, *,
                shade, color, shadow_hits):
    """Shade data, shadow rays and the colour for primary march results in
    launch order. `shade` is `shade_pass` or its plain version, `color`
    `shade_color` or its plain version; `shadow_hits(srays, sstate)`
    marches the shadow rays to the end and returns their hit plane. Returns
    flat (color[P,3] clipped to [0, 1], depth[P], normal[P,3], hit[P]
    bool), depth and normal None without config.aux_buffers."""
    hit = hit_i != 0
    points, fx, fy = hit_points(rays, hit, t_hit, hx, hy)
    nx, ny, nz, ar, ag, ab = shade(hit_i, hx, hy, fx, fy, scene.shade_rec,
                                   scene.albedo_rec if config.texture else None)
    occ = None
    if config.shadows:
        with span("hmrt.shadow"):
            srays, sstate = shadow_start(points, (nx, ny, nz), hit, hx, hy, scene,
                                         config.clip_box)
            occ = shadow_hits(srays, sstate)
    return (*color(hit_i, t_hit, rays[3:], (nx, ny, nz), (ar, ag, ab), occ, scene.light,
                   config), hit)


def to_frame(config: RenderConfig, color, depth, normal, hit) -> Frame:
    """A Frame of config's (height, width) from flat or planar buffers;
    depth and normal only with aux_buffers."""
    H, W = config.height, config.width
    return Frame(color=color.reshape(H, W, 3),
                 depth=depth.reshape(H, W) if config.aux_buffers else None,
                 normal=normal.reshape(H, W, 3) if config.aux_buffers else None,
                 hit=hit.reshape(H, W))


def render_frame_compact(scene: Scene, camera: Camera, config: RenderConfig, *,
                         first_budget: int = FIRST_BUDGET, rounds: int = ROUNDS,
                         round_budget: int = ROUND_BUDGET, counts: dict | None = None,
                         row0: int | None = None, full_height: int | None = None,
                         l0_tail: bool | str = "auto", relax: int = 0) -> Frame:
    """Compacted-wavefront render (see the module docstring).

    first_budget: steps of pass 0 in launch order (0 skips it);
    rounds: sorted rounds, the last unbudgeted (at least 1);
    round_budget: steps of each earlier sorted round.
    The shadow march takes min(rounds, 2) sorted rounds and no pass 0.
    l0_tail: True forces the last round of each march to the level-0 tail,
    "auto" (the default) when more than ray_sort.L0_TAIL_AUTO_THRESH of its rays are
    already at level 0, False never; the frame is the same for each.
    relax: stride in cells of the relaxed tail (0, the default: exact). Its
    contract: no false hits; a detected hit is the exact hit with the exact
    t; a feature narrower than `relax` cells along a ray can be tunnelled
    (a missed or later hit). It needs the tail: with l0_tail=False it
    raises; with "auto" it relaxes only the marches whose tail is chosen.
    counts: a dict whose "primary" and "shadow" lists take each march
    launch's per-ray steps and cell tests (`march_rounds`; bench/floor.py).
    row0/full_height: render rows [row0, row0 + height) of a
    full_height-row screen (the band form under sharding); the sort keys
    and passes then run over the band's rays alone."""
    check_l0_tail(l0_tail, relax)
    if rounds < 1 or first_budget < 0 or round_budget < 0:
        raise ValueError(f"bad schedule first_budget={first_budget} "
                         f"rounds={rounds} round_budget={round_budget}")
    if row0 is not None and not 0 <= row0 <= (full_height or config.height) - config.height:
        raise ValueError(f"row band [{row0}, {row0 + config.height}) outside a "
                         f"{full_height or config.height}-row screen")
    with span("hmrt.raygen"):
        rays = primary_rays(camera, config, row0, full_height)
        state0 = init_state(rays, None, scene.pyr_flat[-1], n=scene.n, m=scene.m,
                            levels=scene.levels, clip=config.clip_box)
    sched = dict(cell_intersect=config.cell_intersect, clip=config.clip_box,
                 first_budget=first_budget, round_budget=round_budget, l0_tail=l0_tail,
                 relax=relax)
    counts = counts if counts is not None else {"primary": None, "shadow": None}
    with span("hmrt.primary"):
        hit_i, t_hit, hx, hy = march_rounds(rays, state0, scene, rounds=rounds,
                                            moving=(3, 4, 5), counts=counts["primary"],
                                            **sched)
    with span("hmrt.shade"):
        return to_frame(config, *shade_frame(
            scene, config, rays, hit_i, t_hit, hx, hy, shade=shade_pass, color=shade_color,
            shadow_hits=lambda srays, sstate: march_shadows(
                srays, sstate, scene, rounds=rounds, counts=counts["shadow"], **sched)))


#: what a compact frame through `render_frame` did (FrameGraphs' tally)
GRAPH_STEPS = ("eager", "captured", "replayed")


def graph_step(last_key, key, captured: bool) -> str:
    """The key rule of `FrameGraphs`, one of GRAPH_STEPS: what a frame of
    `key` does after a frame of `last_key`, where `captured` says whether
    a graph of last_key is held. A key of None (a frame no graph may take)
    and a key other than the last run eagerly; the second frame of a key
    in a row captures the graph, and the frames after it replay it."""
    if key is None or key != last_key:
        return "eager"
    return "replayed" if captured else "captured"


@dataclasses.dataclass
class _Slot:
    """One device's last key and, once captured, its graph: the static
    camera it reads, the frame it writes and the launches it holds."""
    key: tuple
    scene: weakref.ref
    graph: torch.cuda.CUDAGraph | None = None
    held: Scene | None = None          # the scene, held while its graph is
    camera: Camera | None = None
    frame: Frame | None = None
    launches: tuple = (0, 0, 0)        # march_pass's, shade_pass's, ray_sort's a replay


class FrameGraphs:
    """Compact frames of `render_frame`, replayed from one CUDA graph per
    device.

    A frame's key is its scene (by identity), its RenderConfig, its device
    and the shapes and dtypes of its camera's tensors. A frame may take a
    graph only on a CUDA scene, with the camera's tensors on its device,
    on the device's default stream and while the port's tracing is unarmed
    (utils/profiling.py: armed frames run eagerly, so their spans and
    live-lane counts read the kernels stage by stage). Of such frames, the
    first of a key runs eagerly, the second in a row captures
    `render_frame_compact` as a graph and replays it, and each later one
    replays it (`graph_step`): the camera's eye, target, up and fov_y are
    copied into the graph's static camera, the graph is replayed, and the
    frame's tensors are copied out of the graph's pool into new ones, so a
    Frame the caller holds never changes. Copies on the card, so a replay
    holds no host wait. A path whose scene changes every call (the tiled
    path) never captures.

    Memory: one graph a device, for the last key: the scene it holds
    alive, its static camera and its pool (the frame's working planes).
    A frame of another key releases them.

    `tally` counts the frames by GRAPH_STEPS (plain ints; frames that may
    take no graph count as eager): `read()`, `reset()`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._slots = {}  # device -> _Slot
        self.tally = dict.fromkeys(GRAPH_STEPS, 0)

    def read(self) -> dict:
        return dict(self.tally)

    def reset(self) -> None:
        """Zero the tally (the graphs are kept)."""
        with self._lock:
            self.tally.update(dict.fromkeys(GRAPH_STEPS, 0))

    @staticmethod
    def key(scene: Scene, camera: Camera, config: RenderConfig):
        """The frame's key, or None where it may take no graph."""
        dev = scene.device
        cam = _cam_tensors(camera)
        if dev.type != "cuda" or armed() or any(t.device != dev for t in cam) \
                or torch.cuda.current_stream(dev) != torch.cuda.default_stream(dev):
            return None
        return id(scene), config, dev, tuple((tuple(t.shape), t.dtype) for t in cam)

    def render(self, scene: Scene, camera: Camera, config: RenderConfig) -> Frame:
        """The compact frame of `render_frame_compact(scene, camera,
        config)`, eagerly or from the device's graph (class docstring)."""
        key = self.key(scene, camera, config)
        if key is None:
            with self._lock:
                self.tally["eager"] += 1
            return render_frame_compact(scene, camera, config)
        with self._lock:
            slot = self._slots.get(scene.device)
            last = slot.key if slot is not None and slot.scene() is scene else None
            step = graph_step(last, key, slot is not None and slot.graph is not None)
            self.tally[step] += 1
            if step == "eager":
                # a new key: release the old graph, its scene and its pool
                self._slots[scene.device] = _Slot(key, weakref.ref(scene))
                return render_frame_compact(scene, camera, config)
            if step == "captured":
                self._capture(slot, scene, camera, config)
            else:
                for dst, src in zip(_cam_tensors(slot.camera), _cam_tensors(camera)):
                    dst.copy_(src)
                march_pass.launches += slot.launches[0]
                shade_pass.launches += slot.launches[1]
                ray_sort.launches += slot.launches[2]
            slot.graph.replay()
            out = slot.frame
            return Frame(color=out.color.clone(), depth=_clone(out.depth),
                         normal=_clone(out.normal), hit=out.hit.clone())

    @staticmethod
    def _capture(slot: _Slot, scene: Scene, camera: Camera, config: RenderConfig) -> None:
        """Capture the frame on a static copy of `camera` into `slot`. Other
        threads may go on using the card meanwhile ("thread_local")."""
        cam = Camera(*(t.clone() for t in _cam_tensors(camera)))
        graph = torch.cuda.CUDAGraph()
        before = (march_pass.launches, shade_pass.launches, ray_sort.launches)
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            frame = render_frame_compact(scene, cam, config)
        slot.graph, slot.held, slot.camera, slot.frame = graph, scene, cam, frame
        slot.launches = (march_pass.launches - before[0], shade_pass.launches - before[1],
                         ray_sort.launches - before[2])


def _cam_tensors(camera: Camera) -> tuple:
    return camera.eye, camera.target, camera.up, camera.fov_y


def _clone(x):
    return None if x is None else x.clone()


#: the process's frame graphs, one a device (`render_frame`'s compact path)
frame_graphs = FrameGraphs()
