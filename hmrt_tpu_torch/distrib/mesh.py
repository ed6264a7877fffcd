"""Multi-card rendering over torch.distributed: row bands of one frame, or
whole frames of an animation, one process per card.

Counterpart of `hmrt_tpu/distrib/mesh.py`. The JAX module maps the
single-device renderer over a 1-D device mesh with `shard_map`, keeps the
scene replicated on every chip and all-gathers the framebuffer over ICI.
Here each rank is one process with one device: the scene is broadcast
from rank 0 once (`replicate_scene`), rank r renders rows [r*band,
(r+1)*band) of the screen through the path `render_frame` would take, with
the band's raygen shifted into the full screen (`row0`/`full_height`, the
same ray bits as those rows of the full grid), and `all_gather` assembles
the frame in rank order on every rank. Rays do not interact, so nothing
else crosses between ranks.

The collectives run on NCCL when every rank has a card of its own, and on
gloo otherwise: on the CPU, or with several ranks sharing one card (NCCL
refuses two ranks on one device). gloo moves host tensors, so a CUDA band
is gathered through host copies; the renders stay on the card.

`spawn` starts the ranks itself (torch.multiprocessing, a file store under
`build/`), so nothing here needs `torchrun`; `make_mesh` also joins a
group that `torchrun` or the caller set up.

Stage spans (utils/profiling.py, while the port's tracing is armed):
"hmrt.band" around a rank's band render (the path as its argument, the
compact path's stage spans inside) and "hmrt.gather" around each
`gather_rows`.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import time
import uuid
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist

from hmrt_tpu_torch.api.scene import shade_records
from hmrt_tpu_torch.config import RenderConfig
from hmrt_tpu_torch.core.pyramid import build_min_pyramid_flat
from hmrt_tpu_torch.core.renderer import COMPACT_MIN_M, choose_backend, render_frame
from hmrt_tpu_torch.device import resolve
from hmrt_tpu_torch.types import Camera, Frame, Light, Scene
from hmrt_tpu_torch.utils.profiling import span

BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
#: how long a collective may wait for the other ranks before it fails
DEFAULT_TIMEOUT = timedelta(seconds=300)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in a 1-D mesh of ranks, one device each.

    Used as a context manager it destroys the process group on exit if
    `make_mesh` created it."""

    group: object            # the torch.distributed process group
    rank: int
    size: int
    device: torch.device     # this rank's device
    backend: str             # "nccl" or "gloo"
    owned: bool = False      # make_mesh initialised the group

    @property
    def host_collectives(self) -> bool:
        """True when CUDA tensors cross ranks as host copies (gloo)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(self.group, device_ids=[self.device.index])
        else:
            dist.barrier(self.group)

    def __enter__(self) -> "Mesh":
        return self

    def __exit__(self, *exc) -> None:
        if self.owned and dist.is_initialized():
            dist.destroy_process_group()


def _store_url() -> str:
    """A fresh file:// rendezvous under build/ of the checkout."""
    d = BUILD_DIR / "dist"
    d.mkdir(parents=True, exist_ok=True)
    return f"file://{d / f'store-{os.getpid()}-{uuid.uuid4().hex}'}"


def _rank_device(device, local_rank: int) -> torch.device:
    """`device` for this rank; None and a bare "cuda" mean the card of the
    rank's local index. Raises without CUDA unless a CPU device is named."""
    device = resolve(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
    return device


def make_mesh(device=None, backend: str | None = None, *,
              timeout: timedelta = DEFAULT_TIMEOUT, init_method: str | None = None,
              rank: int | None = None, world_size: int | None = None) -> Mesh:
    """The mesh of this process: it joins the default process group if one
    exists, else initialises one from the torchrun variables (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/MASTER_PORT), else from
    `init_method`/`rank`/`world_size` (what `spawn` passes), else makes a
    one-rank group.

    device: this rank's device (default: the card of its local rank; a
    rank with no card raises). backend: "nccl" for a CUDA device, "gloo"
    otherwise, unless named. On a CUDA mesh the kernels are built by rank 0
    before the others load them, so no two ranks compile at once."""
    env = os.environ
    owned = not dist.is_initialized()
    if owned:
        if init_method is None and "RANK" in env and "WORLD_SIZE" in env:
            init_method, rank, world_size = "env://", int(env["RANK"]), int(env["WORLD_SIZE"])
        elif init_method is None:
            init_method, rank, world_size = _store_url(), 0, 1
        local = int(env.get("LOCAL_RANK", rank))
        device = _rank_device(device, local)
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size, timeout=timeout)
    else:
        rank = dist.get_rank()
        device = _rank_device(device, int(env.get("LOCAL_RANK", rank)))
        if device.type == "cuda":
            torch.cuda.set_device(device)
    mesh = Mesh(group=dist.group.WORLD, rank=dist.get_rank(), size=dist.get_world_size(),
                device=device, backend=dist.get_backend(), owned=owned)
    if device.type == "cuda":
        from hmrt_tpu_torch.kernels import _build
        if mesh.rank == 0:
            _build.library()
        mesh.barrier()
        _build.library()
    return mesh


def _rank_main(rank, fn, args, nprocs, backend, devices, store, timeout, threads, results):
    if threads:
        torch.set_num_threads(threads)
    device = None if devices is None else devices[rank]
    with make_mesh(device, backend, timeout=timeout, init_method=store, rank=rank,
                   world_size=nprocs) as mesh:
        out = fn(mesh, *args)
        if rank == 0:
            results.put(out)


def spawn(fn, nprocs: int, *, args: tuple = (), backend: str | None = None,
          devices=None, timeout: timedelta = DEFAULT_TIMEOUT,
          join_timeout: float | None = None, threads: int | None = None):
    """Run fn(mesh, *args) on `nprocs` new ranks (one process each, the
    spawn start method) and return rank 0's return value.

    fn must be importable by name (a module-level function), and its return
    value picklable. devices: one device per rank (default: rank r takes
    card r). timeout goes to init_process_group and bounds every
    collective; join_timeout (seconds) bounds the whole run, after which
    the ranks are killed and TimeoutError raised. A rank that raises fails
    the run: its exception and traceback are raised here
    (torch.multiprocessing.ProcessRaisedException). threads: torch's
    intra-op threads per rank."""
    results = multiprocessing.get_context("spawn").SimpleQueue()
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(fn, args, nprocs, backend, devices, _store_url(), timeout, threads,
                          results),
        nprocs=nprocs, join=False, start_method="spawn")
    deadline = None if join_timeout is None else time.monotonic() + join_timeout
    out = None
    try:
        while not ctx.join(timeout=0.2):
            while not results.empty():
                out = results.get()
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks of {fn.__qualname__} still running after "
                                   f"{join_timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    while not results.empty():
        out = results.get()
    return out


# ---- collectives ---------------------------------------------------------

def broadcast_object(obj, mesh: Mesh):
    """Rank 0's picklable obj on every rank (others may pass None)."""
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.group,
                               device=mesh.device if mesh.backend == "nccl" else None)
    return box[0]


def _broadcast(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Rank 0's x on every rank (x gives the shape and dtype elsewhere)."""
    buf = x.cpu() if mesh.host_collectives else x
    dist.broadcast(buf, 0, group=mesh.group)
    return buf.to(mesh.device)


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """All-gather x along dim 0 in rank order, on every rank. bool goes as
    uint8: not every backend gathers bool."""
    if x.dtype == torch.bool:
        return gather_rows(x.to(torch.uint8), mesh).bool()
    with span("hmrt.gather"):
        src = x.contiguous()
        if mesh.host_collectives:
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(mesh.size)]
        dist.all_gather(parts, src, group=mesh.group)
        return torch.cat(parts).to(mesh.device)


def all_reduce_max(v: float, mesh: Mesh) -> float:
    """The largest of every rank's v."""
    dev = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
    t = torch.tensor([v], dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return float(t)


_SCENE_PLANES = ("heights", "pyr_flat", "corners", "gx", "gy", "albedo")
_LIGHT_FIELDS = ("sun_dir", "sun_color", "sky_top", "sky_horizon", "fog_color")


def replicate_scene(scene: Scene | None, mesh: Mesh) -> Scene:
    """Rank 0's scene on every rank's device, bit for bit: heights,
    pyr_flat, corners, gx, gy, albedo and the light are broadcast once
    (BASELINE.json:5, "replicated height pyramid"), and each rank packs the
    shade records from its copies of gx, gy and albedo and builds the min
    pyramid from its heights (copies of the same values, so the same bits,
    without sending 2.5 times the planes' bytes again). Ranks other than 0
    may pass None (only rank 0 read the file)."""
    meta = None
    if mesh.rank == 0:
        meta = {"geom": (scene.n, scene.m, scene.levels),
                "shapes": {k: None if getattr(scene, k) is None
                           else tuple(getattr(scene, k).shape) for k in _SCENE_PLANES}}
    meta = broadcast_object(meta, mesh)
    n, m, levels = meta["geom"]
    shapes = meta["shapes"]

    def bcast(x, shape):
        if shape is None:
            return None
        if mesh.rank == 0:
            x = x.to(mesh.device).contiguous()
        else:
            x = torch.empty(shape, dtype=torch.float32, device=mesh.device)
        return _broadcast(x, mesh)

    planes = {k: bcast(getattr(scene, k) if mesh.rank == 0 else None, shapes[k])
              for k in _SCENE_PLANES}
    light = Light(**{k: bcast(getattr(scene.light, k) if mesh.rank == 0 else None, (3,))
                     for k in _LIGHT_FIELDS})
    shade_rec, albedo_rec = shade_records(planes["gx"], planes["gy"], planes["albedo"])
    return Scene(**planes, pyr_min_flat=build_min_pyramid_flat(planes["heights"]), light=light,
                 shade_rec=shade_rec, albedo_rec=albedo_rec, n=n, m=m, levels=levels)


# ---- sharded renders -----------------------------------------------------

def band_path(scene: Scene, config: RenderConfig, use_kernels: bool | None = None) -> str:
    """The path a band renders by: "oracle", "compact" or "fused".
    None: the one `render_frame` takes (core/renderer.py::choose_backend);
    True: a kernel path even where that would pick the oracle (compact for
    backend "compact", or "auto" on maps with m >= COMPACT_MIN_M, else
    fused), as the JAX module's use_pallas=True; False: the oracle."""
    if use_kernels is None:
        return choose_backend(scene.device.type, scene.m, config.backend)
    if not use_kernels:
        return "oracle"
    compact = config.backend == "compact" or (config.backend == "auto"
                                              and scene.m >= COMPACT_MIN_M)
    return "compact" if compact else "fused"


def render_band(scene: Scene, camera: Camera, config: RenderConfig, row0: int,
                full_height: int, use_kernels: bool | None = None) -> Frame:
    """Rows [row0, row0 + config.height) of a full_height-row frame, by
    `band_path`: one rank's work under band sharding."""
    path = band_path(scene, config, use_kernels)
    with span("hmrt.band", path):
        if path == "compact":
            from hmrt_tpu_torch.kernels.compact import render_frame_compact
            return render_frame_compact(scene, camera, config, row0=row0,
                                        full_height=full_height)
        if path == "fused":
            from hmrt_tpu_torch.kernels.raycast import render_frame_fused
            return render_frame_fused(scene, camera, config, row0, full_height)
        from hmrt_tpu_torch.core.renderer import render_frame_oracle
        return render_frame_oracle(scene, camera, config, row0, full_height)


def _check_placement(scene: Scene, camera: Camera, mesh: Mesh):
    if scene.device != mesh.device or camera.eye.device != mesh.device:
        raise ValueError(f"scene on {scene.device} and camera on {camera.eye.device}, "
                         f"rank {mesh.rank} on {mesh.device}")


def render_frame_sharded(scene: Scene, camera: Camera, config: RenderConfig,
                         mesh: Mesh | None = None, use_kernels: bool | None = None) -> Frame:
    """Band-sharded render (SURVEY.md section 3.6): rank r renders rows
    [r*band, (r+1)*band) with band = height / ranks, and every rank
    all-gathers colour, hit and, under aux_buffers, depth and normal into
    the full Frame. Equal to `render_frame` of the same path: the band's
    rays are the same bits as those rows of the full grid. Called by every
    rank of the mesh (default: a one-rank mesh on the scene's device)."""
    if mesh is None:
        with make_mesh(scene.device) as one:
            return render_frame_sharded(scene, camera, config, one, use_kernels)
    H = config.height
    if H % mesh.size:
        raise ValueError(f"height {H} must divide evenly over {mesh.size} ranks")
    _check_placement(scene, camera, mesh)
    band = H // mesh.size
    fr = render_band(scene, camera, dataclasses.replace(config, height=band),
                     mesh.rank * band, H, use_kernels)
    aux = config.aux_buffers
    return Frame(color=gather_rows(fr.color, mesh),
                 depth=gather_rows(fr.depth, mesh) if aux else None,
                 normal=gather_rows(fr.normal, mesh) if aux else None,
                 hit=gather_rows(fr.hit, mesh))


def render_flythrough_sharded(scene: Scene, cams: Camera, config: RenderConfig,
                              mesh: Mesh | None = None) -> torch.Tensor:
    """Frame-parallel animation (C8 x C27): rank r renders frames
    [r*F/k, (r+1)*F/k) of the batched camera through `render_frame`, with
    no traffic per frame, and the (F, H, W, 3) colour stack is gathered on
    every rank. F must divide over the k ranks."""
    from hmrt_tpu_torch.api.flythrough import frame_camera
    if mesh is None:
        with make_mesh(scene.device) as one:
            return render_flythrough_sharded(scene, cams, config, one)
    if cams.eye.ndim != 2:
        raise ValueError("cams must be a batched Camera (leading frame axis, e.g. from "
                         f"api.flythrough.flythrough); got eye shape {tuple(cams.eye.shape)}")
    F = int(cams.eye.shape[0])
    if F % mesh.size:
        raise ValueError(f"frame count {F} must divide evenly over {mesh.size} ranks")
    _check_placement(scene, cams, mesh)
    local = F // mesh.size
    colors = torch.stack([render_frame(scene, frame_camera(cams, mesh.rank * local + i),
                                       config).color for i in range(local)])
    return gather_rows(colors, mesh)
