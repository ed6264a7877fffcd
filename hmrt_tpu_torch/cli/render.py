"""CLI: render a heightmap to a PNG (or a flythrough to an .npy stack).

Counterpart of `hmrt_tpu/cli/render.py`, flag for flag, plus `--cpu`.
Without `--cpu` it renders on the CUDA card and fails on a machine without
one. `--sharded` spawns one rank per card (a single rank on a one-card
machine, or with `--cpu`): rank 0 reads the map and builds the scene,
`replicate_scene` gives it to the others, stills render band-sharded and
`--flythrough` frame-sharded, and rank 0 writes the outputs.

    python -m hmrt_tpu_torch.cli.render [heightmap] -o out.png [--shadows --aux]
    python -m hmrt_tpu_torch.cli.render dem.r32 --tile 2048 -o out.png
    python -m hmrt_tpu_torch.cli.render --size 1024 --flythrough 48 -o fly.npy
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(
        prog="hmrt-render",
        description="heightmap raytracer on a CUDA card (PyTorch port of hmrt_tpu)")
    p.add_argument("heightmap", nargs="?", default=None,
                   help="heightmap file (.png/.pgm/.npy/.npz/.raw/.r32/.tif/.asc/.xyz); "
                        "omit for procedural terrain")
    p.add_argument("-o", "--output", default="render.png")
    p.add_argument("--size", type=int, default=1024,
                   help="procedural terrain size (when no file given)")
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--eye", type=float, nargs=3, default=None, metavar=("X", "Y", "Z"))
    p.add_argument("--target", type=float, nargs=3, default=None, metavar=("X", "Y", "Z"))
    p.add_argument("--fov", type=float, default=55.0)
    p.add_argument("--sun", type=float, nargs=3, default=(0.4, 0.3, 0.85))
    p.add_argument("--traversal", choices=["maxmip", "dda"], default="maxmip")
    p.add_argument("--intersect", choices=["triangle", "bilinear", "flat"],
                   default="triangle")
    p.add_argument("--shading", choices=["lambert", "phong"], default="phong")
    p.add_argument("--albedo", default=None, metavar="IMAGE",
                   help="albedo texture image draped over the terrain; resampled to "
                        "the heightmap resolution")
    p.add_argument("--shadows", action="store_true")
    p.add_argument("--fog", action="store_true")
    p.add_argument("--aux", action="store_true",
                   help="also write depth (.npy) and normal buffers")
    p.add_argument("--flythrough", type=int, default=0, metavar="FRAMES",
                   help="render an orbiting flythrough to <output>.npy")
    p.add_argument("--sharded", action="store_true",
                   help="one rank per card: the framebuffer in row bands for stills, "
                        "the frame axis for --flythrough")
    p.add_argument("--backend", choices=["auto", "oracle", "pallas", "compact"],
                   default="auto")
    p.add_argument("--zscale", type=float, default=None)
    p.add_argument("--tile", type=int, default=0, metavar="CELLS",
                   help="out-of-core tiled render: stream the map as CELLS^2-cell "
                        "sub-scenes and composite by depth. A .raw/.r32 file is mmap'd "
                        "and never fully loaded (heights are used as-is, no "
                        "normalization). Incompatible with --sharded.")
    p.add_argument("--tile-cache", type=int, default=0, metavar="N",
                   help="keep up to N tile sub-scenes resident across the shadow sweep "
                        "(pixel-neutral)")
    p.add_argument("--cpu", action="store_true",
                   help="render on the CPU (the kernels' plain versions) instead of the card")
    return p


def load_terrain(args):
    """(terr, source, albedo, n, zmax, zmean) on the host: terr is the
    in-memory map (None for a --tile raw file, which `source` maps)."""
    from hmrt_tpu_torch.io.heightmap import load_heightmap, load_texture, procedural_terrain
    source = None
    if args.tile and args.heightmap and args.heightmap.lower().endswith((".raw", ".r32")):
        from hmrt_tpu_torch.io.native import RawTileMap
        source = RawTileMap(args.heightmap)
        n = source.side
        # camera defaults need a height estimate; sample a coarse grid
        probe = source.tile(0, 0, min(n, 512), min(n, 512))
        return None, source, None, n, float(probe.max()), float(probe.mean())
    if args.heightmap:
        terr = load_heightmap(args.heightmap, z_scale=args.zscale)
        if terr.shape[0] != terr.shape[1]:
            side = min(terr.shape)
            terr = terr[:side, :side]
    else:
        terr = procedural_terrain(args.size, seed=args.seed, z_scale=args.zscale)
    albedo = load_texture(args.albedo, terr.shape[0]) if args.albedo else None
    return (terr, terr if args.tile else None, albedo, terr.shape[0], float(terr.max()),
            float(terr.mean()))


def camera_and_config(args, n: int, zmax: float, zmean: float, texture: bool, device):
    import hmrt_tpu_torch as T
    eye = tuple(args.eye) if args.eye else (n * 0.5, -n * 0.25, zmax + n * 0.06)
    target = tuple(args.target) if args.target else (n * 0.5, n * 0.5, zmean)
    cam = T.Camera.create(eye=eye, target=target, fov_y_deg=args.fov, device=device)
    cfg = T.RenderConfig(width=args.width, height=args.height, traversal=args.traversal,
                         cell_intersect=args.intersect, shading=args.shading,
                         shadows=args.shadows, fog=args.fog, texture=texture,
                         aux_buffers=args.aux, backend=args.backend)
    return cam, cfg


def _flythrough_path(args) -> str:
    return args.output if args.output.endswith(".npy") else args.output + ".npy"


def write_outputs(args, fr, n: int, dt: float) -> None:
    from hmrt_tpu_torch.io.image import write_png
    write_png(args.output, fr.color.cpu().numpy())
    print(f"wrote {args.output} ({args.width}x{args.height}, map {n}^2, "
          f"{dt:.2f}s incl. kernel build)")
    if args.aux:
        base = args.output.rsplit(".", 1)[0]
        np.save(base + "_depth.npy", fr.depth.cpu().numpy())
        write_png(base + "_normal.png", fr.normal.cpu().numpy() * 0.5 + 0.5)
        print(f"wrote {base}_depth.npy, {base}_normal.png")


def _sharded_rank(mesh, args):
    """One rank of --sharded (spawn pickles it by name)."""
    import hmrt_tpu_torch as T
    from hmrt_tpu_torch.distrib.mesh import (broadcast_object, render_flythrough_sharded,
                                             render_frame_sharded, replicate_scene)
    scene, meta = None, None
    if mesh.rank == 0:
        terr, _, albedo, n, zmax, zmean = load_terrain(args)
        light = T.Light.create(sun_dir=tuple(args.sun), device=mesh.device)
        scene = T.make_scene(terr, albedo=albedo, light=light, device=mesh.device)
        meta = (n, zmax, zmean, albedo is not None)
    n, zmax, zmean, texture = broadcast_object(meta, mesh)
    scene = replicate_scene(scene, mesh)
    cam, cfg = camera_and_config(args, n, zmax, zmean, texture, mesh.device)
    t0 = time.time()
    if args.flythrough:
        cams = T.orbit_flythrough(n, zmax, args.flythrough, device=mesh.device)
        stack = render_flythrough_sharded(scene, cams, cfg, mesh)
        if mesh.rank == 0:
            np.save(_flythrough_path(args), stack.cpu().numpy())
            print(f"wrote {len(stack)} frames to {_flythrough_path(args)} on {mesh.size} "
                  f"ranks ({(time.time() - t0) / args.flythrough * 1e3:.1f} ms/frame)")
        return
    fr = render_frame_sharded(scene, cam, cfg, mesh)
    if mesh.rank == 0:
        write_outputs(args, fr, n, time.time() - t0)


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch

    import hmrt_tpu_torch as T
    from hmrt_tpu_torch.device import resolve
    from hmrt_tpu_torch.kernels.compact import frame_graphs

    device = resolve("cpu" if args.cpu else None)
    if args.tile and args.sharded:
        print("--tile is incompatible with --sharded", file=sys.stderr)
        return 2
    if args.sharded:
        from hmrt_tpu_torch.distrib.mesh import spawn
        ranks = torch.cuda.device_count() if device.type == "cuda" else 1
        spawn(_sharded_rank, ranks, args=(args,),
              devices=[device] if device.type == "cpu" else None)
        return 0

    terr, source, albedo, n, zmax, zmean = load_terrain(args)
    if args.albedo and terr is None:
        print("--albedo needs an in-memory heightmap (not --tile on a raw mmap)",
              file=sys.stderr)
        return 2
    light = T.Light.create(sun_dir=tuple(args.sun), device=device)
    cam, cfg = camera_and_config(args, n, zmax, zmean, albedo is not None, device)
    scene = None if args.tile else T.make_scene(terr, albedo=albedo, light=light,
                                                device=device)

    if args.flythrough:
        from hmrt_tpu_torch.api.flythrough import frame_camera
        cams = T.orbit_flythrough(n, zmax, args.flythrough, device=device)
        graphs0 = frame_graphs.read()  # how the frames ran (kernels/compact.py::FrameGraphs)
        t0 = time.time()
        if args.tile:
            # out-of-core animation: the tile-scene cache keeps the working
            # set resident so later frames skip the rebuilds
            from hmrt_tpu_torch.api.tiled import TileSceneCache
            cache = TileSceneCache(args.tile_cache or 16)
            frames = [T.render_frame_tiled(source, frame_camera(cams, i), cfg, tile=args.tile,
                                           light=light, albedo=albedo, cache=cache,
                                           device=device).color
                      for i in range(args.flythrough)]
        else:
            frames = [T.render_frame(scene, frame_camera(cams, i), cfg).color
                      for i in range(args.flythrough)]
        stack = torch.stack(frames).cpu().numpy()
        dt = time.time() - t0
        out = _flythrough_path(args)
        np.save(out, stack)
        graphs = frame_graphs.read()
        graphs = {k: graphs[k] - graphs0[k] for k in graphs}
        print(f"wrote {len(stack)} frames to {out} "
              f"({dt / args.flythrough * 1e3:.1f} ms/frame incl. host loop"
              + (f"; compact frames {graphs}" if any(graphs.values()) else "") + ")")
        return 0

    t0 = time.time()
    if args.tile:
        fr = T.render_frame_tiled(source, cam, cfg, tile=args.tile, light=light,
                                  albedo=albedo, cache=args.tile_cache, device=device)
    else:
        fr = T.render_frame(scene, cam, cfg)
    write_outputs(args, fr, n, time.time() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
