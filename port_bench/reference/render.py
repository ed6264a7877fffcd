"""A frame worked out again from the heightmap, the camera and the render
settings, in plain torch, on any device and in any float dtype.

The model is the one the port states (its `traversal/intersect.py` and
`core/renderer.py`): the heightfield's cell (cx, cy) spans [cx, cx+1] x
[cy, cy+1] with corner heights h[cy, cx], h[cy, cx+1], h[cy+1, cx],
h[cy+1, cx+1], split along the (10)-(01) diagonal into two triangles; a ray
hits the first cell along it whose triangles it crosses within the cell's
stretch of t, widened by T_TOL; shadow rays leave each hit toward the sun
from SHADOW_EPS above it; a hit is shaded by the bilinear interpolation of
the per-sample central-difference gradients and albedo at its point in the
cell, Lambert plus Phong, exponential fog and a vertical sky gradient.

The march is independent of the port's: the plain DDA over the level-0
cells, GROUP cells of each ray at a time (their crossings merged, x before
y at a tie, each cell tested over its own stretch of t, the first hit
kept), over lanes compacted after every group and taken CHUNK lanes at
once. A ray above the highest sample starts where it descends to it, and
one above it and climbing ends. It builds no pyramid, record or table of
the port's.
"""

from __future__ import annotations

import math

import torch

T_TOL = 1.0e-3
EPS_EXIT = 1.0e-6
SHADOW_EPS = 1.0e-2
BIG_T = 3.0e38
GROUP = 32
CHUNK = 1 << 18


def _norm(v):
    """Euclidean norm over the last axis: the sum of squares x, y, z in that
    order, and its correctly rounded root."""
    sq = v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]
    return torch.sqrt(sq.double()).to(v.dtype)


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def camera_rays(eye, target, fov_deg: float, height: int, width: int, dtype, device):
    """Pinhole rays through pixel centres: origin (3,) and unit directions
    (H*W, 3), row 0 at the top. Pixel (i, j) looks along f + x r + y u,
    x = ((j + 1/2) (1/W) 2 - 1) tan(fov/2) W/H, y = (1 - (i + 1/2) (1/H) 2)
    tan(fov/2), with 1/W, 1/H and tan(fov/2) each rounded once."""
    e = torch.tensor(eye, dtype=torch.float32, device=device).to(dtype)
    tg = torch.tensor(target, dtype=torch.float32, device=device).to(dtype)
    up = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=device)
    f = tg - e
    f = f / _norm(f)
    r = _cross(f, up)
    r = r / _norm(r)
    u = _cross(r, f)
    fov = torch.deg2rad(torch.tensor(fov_deg, dtype=torch.float32, device=device))
    th = torch.tan((fov * 0.5).double()).to(dtype)
    rw = float(torch.tensor(1.0, dtype=dtype) / torch.tensor(float(width), dtype=dtype))
    rh = float(torch.tensor(1.0, dtype=dtype) / torch.tensor(float(height), dtype=dtype))
    jj = (torch.arange(width, dtype=dtype, device=device) + 0.5) * rw * 2.0 - 1.0
    ii = 1.0 - (torch.arange(height, dtype=dtype, device=device) + 0.5) * rh * 2.0
    sx = jj * th * (width / height)
    sy = ii * th
    d = f[None, None, :] + sx[None, :, None] * r[None, None, :] + sy[:, None, None] * u[None, None, :]
    d = d / _norm(d)[..., None]
    return e, d.reshape(-1, 3)


class Terrain:
    """The heightfield the walk reads: heights (n, n) and the highest one."""

    def __init__(self, heights: torch.Tensor, dtype):
        self.h = heights.to(dtype)
        self.flat = self.h.reshape(-1)
        self.n = self.h.shape[0]
        self.gmax = self.h.max()


def _safe(x):
    return torch.where(torch.abs(x) < 1e-20, torch.full_like(x, 1e-20), x)


def intersect(ox, oy, oz, dx, dy, dz, cx, cy, z00, z10, z01, z11, t_lo, t_hi):
    """Ray against the cell's two triangles (c00, c10, c01) and (c11, c01,
    c10): each plane solved for t, then tested for containment in the
    cell's (u, v). Returns (hit, t of the nearer valid crossing)."""
    fx = cx.to(ox.dtype)
    fy = cy.to(ox.dtype)
    eps = 1e-6
    g1x, g1y = z10 - z00, z01 - z00
    t1 = (z00 + g1x * (ox - fx) + g1y * (oy - fy) - oz) / _safe(dz - g1x * dx - g1y * dy)
    u1, v1 = ox + t1 * dx - fx, oy + t1 * dy - fy
    ok1 = (u1 >= -eps) & (v1 >= -eps) & (u1 + v1 <= 1.0 + eps) & (t1 >= t_lo) & (t1 <= t_hi)
    g2x, g2y = z11 - z01, z11 - z10
    t2 = ((z10 - z11 + z01) + g2x * (ox - fx) + g2y * (oy - fy) - oz) \
        / _safe(dz - g2x * dx - g2y * dy)
    u2, v2 = ox + t2 * dx - fx, oy + t2 * dy - fy
    ok2 = (u2 <= 1.0 + eps) & (v2 <= 1.0 + eps) & (u2 + v2 >= 1.0 - eps) \
        & (t2 >= t_lo) & (t2 <= t_hi)
    big = torch.full_like(t1, BIG_T)
    return ok1 | ok2, torch.minimum(torch.where(ok1, t1, big), torch.where(ok2, t2, big))


def box_range(ox, oy, dx, dy, world_max: float):
    """The stretch [t0, t1] of each ray over x, y in [0, world_max]."""
    ivx, ivy = 1.0 / _safe(dx), 1.0 / _safe(dy)
    tx0, tx1 = (0.0 - ox) * ivx, (world_max - ox) * ivx
    ty0, ty1 = (0.0 - oy) * ivy, (world_max - oy) * ivy
    t_lo = torch.maximum(torch.minimum(tx0, tx1), torch.minimum(ty0, ty1))
    t1 = torch.minimum(torch.maximum(tx0, tx1), torch.maximum(ty0, ty1))
    t0 = torch.clamp_min(t_lo, 0.0)
    return t0, t1, t1 > t0


def _crossings(o, inv, d, c, j):
    """t of the next len(j) cell boundaries of one axis after cell c, and
    the step (+1 or -1) along it."""
    pos = d > 0
    step = torch.where(pos, 1, -1)
    b = (c + pos.to(c.dtype))[:, None] + j[None, :] * step[:, None]
    t = (b.to(o.dtype) - o[:, None]) * inv[:, None]
    return torch.where(torch.abs(d)[:, None] < 1e-20, torch.full_like(t, BIG_T), t), step


def _group(terr: Terrain, s: dict):
    """GROUP DDA steps of every lane in `s`, in place."""
    n = terr.n
    ox, oy, oz, dx, dy, dz, t1 = (s[k] for k in ("ox", "oy", "oz", "dx", "dy", "dz", "t1"))
    j = torch.arange(GROUP, device=ox.device)
    tx, sx = _crossings(ox, s["ivx"], dx, s["cx"], j)
    ty, sy = _crossings(oy, s["ivy"], dy, s["cy"], j)
    # the merged crossings, x first at a tie: crossing k leaves cell k
    ts, order = torch.sort(torch.cat([tx, ty], 1), dim=1, stable=True)
    ts, on_x = ts[:, :GROUP], (order[:, :GROUP] < GROUP).long()
    nx_before = torch.cumsum(on_x, 1) - on_x
    cx = s["cx"][:, None] + sx[:, None] * nx_before
    cy = s["cy"][:, None] + sy[:, None] * (j[None, :] - nx_before)
    tec = torch.minimum(ts, t1[:, None])
    t_in = torch.cummax(torch.cat([s["t"][:, None], tec[:, :-1]], 1), 1).values
    t_in = torch.maximum(t_in, s["t"][:, None])
    inside = (cx >= 0) & (cx <= n - 2) & (cy >= 0) & (cy <= n - 2)
    ends = ts >= (t1 - EPS_EXIT)[:, None]
    # a cell is walked when every earlier one was inside and did not end the ray
    stop = ~inside | torch.cat([torch.zeros_like(ends[:, :1]), ends[:, :-1]], 1)
    walked = torch.cumsum(stop.long(), 1) == 0
    ccx, ccy = torch.clamp(cx, 0, n - 2), torch.clamp(cy, 0, n - 2)
    base = ccy * n + ccx
    fl = terr.flat
    b = lambda x: x[:, None]  # noqa: E731
    hit, th = intersect(b(ox), b(oy), b(oz), b(dx), b(dy), b(dz), cx, cy, fl[base], fl[base + 1],
                        fl[base + n], fl[base + n + 1], t_in - T_TOL, tec + T_TOL)
    hit = hit & walked
    first = torch.argmax(hit.long(), 1)
    any_hit = hit.any(1)
    rows = torch.arange(ox.shape[0], device=ox.device)
    s["hit"] = any_hit
    s["th"] = th[rows, first]
    s["hx"], s["hy"] = cx[rows, first], cy[rows, first]
    # no hit: on from the cell after the last crossing, unless the ray ended
    last = GROUP - 1
    gone = ~walked[:, last] | ends[:, last]
    s["cx"] = torch.where(on_x[:, last] == 1, cx[:, last] + sx, cx[:, last])
    s["cy"] = torch.where(on_x[:, last] == 1, cy[:, last], cy[:, last] + sy)
    s["t"] = torch.maximum(t_in[:, last], tec[:, last])
    out = (s["cx"] < 0) | (s["cx"] > n - 2) | (s["cy"] < 0) | (s["cy"] > n - 2)
    escaped = (oz + s["t"] * dz > terr.gmax) & (dz > 0)
    s["alive"] = ~any_hit & ~gone & ~out & ~escaped


def march(terr: Terrain, ox, oy, oz, dx, dy, dz, valid):
    """First hit of each ray: (hit bool, t, cx, cy), every plane (P,)."""
    n = terr.n
    p = dx.shape[0]
    dev = dx.device
    hit = torch.zeros(p, dtype=torch.bool, device=dev)
    t_hit = torch.full((p,), BIG_T, dtype=dx.dtype, device=dev)
    hcx = torch.zeros(p, dtype=torch.int64, device=dev)
    hcy = torch.zeros(p, dtype=torch.int64, device=dev)
    t0, t1, inside = box_range(ox, oy, dx, dy, float(n - 1))
    alive = valid & inside & ~((oz + t0 * dz > terr.gmax) & (dz >= 0))
    # above the highest sample and descending: nothing to hit before it
    t_top = torch.where((oz > terr.gmax) & (dz < 0), (terr.gmax - oz) / _safe(dz), t0)
    ts = torch.maximum(t0, t_top)
    cx = torch.clamp(torch.floor(ox + ts * dx), 0, n - 2).to(torch.int64)
    cy = torch.clamp(torch.floor(oy + ts * dy), 0, n - 2).to(torch.int64)
    idx = torch.nonzero(alive).squeeze(1)
    lanes = dict(ox=ox, oy=oy, oz=oz, dx=dx, dy=dy, dz=dz, t=ts, t1=t1, cx=cx, cy=cy)
    s = {k: v[idx] for k, v in lanes.items()}
    limit = 2 * n // GROUP + 4
    for _ in range(limit):
        if not idx.numel():
            break
        s["ivx"], s["ivy"] = 1.0 / _safe(s["dx"]), 1.0 / _safe(s["dy"])
        parts = []
        for a in range(0, idx.numel(), CHUNK):
            part = {k: v[a:a + CHUNK] for k, v in s.items()}
            _group(terr, part)
            parts.append(part)
        s = {k: torch.cat([q[k] for q in parts]) for k in parts[0]}
        h = s["hit"]
        gi = idx[h]
        hit[gi] = True
        t_hit[gi] = s["th"][h]
        hcx[gi] = s["hx"][h]
        hcy[gi] = s["hy"][h]
        keep = torch.nonzero(s["alive"]).squeeze(1)
        idx = idx[keep]
        s = {k: s[k][keep] for k in lanes}
    return hit, t_hit, hcx, hcy


def _grads(h: torch.Tensor):
    """Per-sample central-difference gradients, one-sided at the border."""
    n = h.shape[0]
    i = torch.arange(n, device=h.device)
    lo, hi = torch.clamp(i - 1, 0, n - 1), torch.clamp(i + 1, 0, n - 1)
    den = (hi - lo).to(h.dtype)
    return (h[:, hi] - h[:, lo]) / den[None, :], (h[hi, :] - h[lo, :]) / den[:, None]


def _bilerp(plane_flat, n, cx, cy, fx, fy):
    base = cy * n + cx
    v00, v10 = plane_flat[base], plane_flat[base + 1]
    v01, v11 = plane_flat[base + n], plane_flat[base + n + 1]
    return (v00 * (1 - fx) * (1 - fy) + v10 * fx * (1 - fy)
            + v01 * (1 - fx) * fy + v11 * fx * fy)


def render(heights: torch.Tensor, albedo, eye, target, fov_deg: float, render_cfg: dict,
           light: dict, dtype=torch.float32):
    """The reference frame: (colour (H, W, 3) float32 in [0, 1], hit (H, W)
    bool). `heights` (n, n) and `albedo` (n, n, 3) or None are the
    benchmark's inputs, on the device the work runs on; `render_cfg` the
    configuration's render settings; `light` its five light vectors."""
    dev = heights.device
    H, W = int(render_cfg["height"]), int(render_cfg["width"])
    if render_cfg.get("cell_intersect", "triangle") != "triangle" or render_cfg.get("aux_buffers"):
        raise ValueError("the reference renders the triangle surface without aux buffers")
    terr = Terrain(heights, dtype)
    n = terr.n
    e, d = camera_rays(eye, target, fov_deg, H, W, dtype, dev)
    p = d.shape[0]
    ox, oy, oz = (e[i].expand(p) for i in range(3))
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    hit, t, hx, hy = march(terr, ox, oy, oz, dx, dy, dz, torch.ones(p, dtype=torch.bool, device=dev))

    def vec(name):
        return torch.tensor(light[name], dtype=torch.float32, device=dev).to(dtype)

    sun = vec("sun_dir")
    sun = sun / torch.linalg.vector_norm(sun)
    sun_c, top, hor, fog_c = vec("sun_color"), vec("sky_top"), vec("sky_horizon"), vec("fog_color")
    ts = torch.where(hit, t, torch.zeros_like(t))
    px, py, pz = ox + ts * dx, oy + ts * dy, oz + ts * dz
    fx = torch.clamp(px - hx.to(dtype), 0, 1)
    fy = torch.clamp(py - hy.to(dtype), 0, 1)
    gx, gy = _grads(terr.h)
    ngx = _bilerp(gx.reshape(-1), n, hx, hy, fx, fy)
    ngy = _bilerp(gy.reshape(-1), n, hx, hy, fx, fy)
    inv = torch.rsqrt(ngx * ngx + ngy * ngy + 1)
    nx, ny, nz = -ngx * inv, -ngy * inv, inv
    ndl = nx * sun[0] + ny * sun[1] + nz * sun[2]
    diff = torch.clamp_min(ndl, 0)
    occ = torch.zeros_like(hit)
    if render_cfg["shadows"]:
        sxo = px + sun[0] * SHADOW_EPS + nx * SHADOW_EPS
        syo = py + sun[1] * SHADOW_EPS + ny * SHADOW_EPS
        szo = pz + sun[2] * SHADOW_EPS + nz * SHADOW_EPS
        occ = march(terr, sxo, syo, szo, sun[0].expand(p), sun[1].expand(p),
                    sun[2].expand(p), hit)[0]
        diff = torch.where(occ, torch.zeros_like(diff), diff)
    if render_cfg["texture"] and albedo is not None:
        a = albedo.to(dtype)
        alb = [_bilerp(a[..., c].reshape(-1), n, hx, hy, fx, fy) for c in range(3)]
    else:
        alb = [torch.full_like(px, 0.55)] * 3
    amb = float(render_cfg["ambient"])
    rgb = [alb[c] * (amb + diff * sun_c[c]) for c in range(3)]
    if render_cfg["shading"] == "phong":
        rx, ry, rz = (2 * ndl * nx - sun[0], 2 * ndl * ny - sun[1], 2 * ndl * nz - sun[2])
        rdv = torch.clamp_min(-(rx * dx + ry * dy + rz * dz), 0)
        spec = torch.where(ndl > 0, rdv ** float(render_cfg["shininess"]), torch.zeros_like(rdv))
        spec = torch.where(occ, torch.zeros_like(spec), spec)
        rgb = [rgb[c] + float(render_cfg["specular"]) * spec * sun_c[c] for c in range(3)]
    if render_cfg["fog"]:
        f = torch.exp(-ts * float(render_cfg["fog_density"]))
        rgb = [rgb[c] * f + fog_c[c] * (1 - f) for c in range(3)]
    u = torch.sqrt(torch.clamp(dz, 0, 1))
    color = torch.stack([torch.where(hit, rgb[c], hor[c] * (1 - u) + top[c] * u)
                         for c in range(3)], -1)
    return torch.clamp(color, 0, 1).float().reshape(H, W, 3), hit.reshape(H, W)
