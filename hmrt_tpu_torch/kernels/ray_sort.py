"""The ray sort of the compact path's sorted rounds (kernels/compact.py).

Before each sorted round the survivors are reordered by their current
32-cell terrain column (`column_key`), so that the rays of a thread block
march through nearby terrain, and after the last round the results go back
to launch order. `ray_sort` does one round's reorder: on a tail round it
first forces the lanes to level 0 (`force_level0`, always or by the "auto"
flag `l0_tail_flag`), keys them, sorts the keys stably and gathers the
state, the moving ray planes and the results through that permutation,
composing it with the running one. `ray_unsort` scatters result planes back
through the running permutation.

CUDA tensors launch `csrc/ray_sort.cu`: a key pass, a stable radix sort
over only the key's bits (m5^2 + 1 values) and one gather launch, then one
unsort launch; no host wait. CPU tensors run the plain versions,
`ray_sort_reference` (torch: the key, `argsort(stable=True)`, one
`index_select` a plane) and `index_copy_`. Both give the same permutation
and planes, bit for bit. The kernel replaces no TPU kernel: the JAX package
sorts with XLA.
"""

from __future__ import annotations

import ctypes

import torch

from hmrt_tpu_torch.kernels import _build

#: l0_tail="auto": the share of surviving rays already at level 0 (before
#: the last sorted round) above which the tail is forced to level 0; the
#: JAX package's value (hmrt_tpu/kernels/compact.py). Both choices are exact.
L0_TAIL_AUTO_THRESH = 0.9

#: the kernel's tail argument: no tail, forced, "auto" (ray_sort.cu TAIL_*)
TAIL_MODES = {False: 0, True: 1, "auto": 2}


def force_level0(rays, state):
    """Descend every lane to the level-0 cell containing its position at t,
    as `levels - 1` masked rounds of `descend_cell` do
    (`hmrt_tpu/kernels/compact.py::_force_level0`). Descending without a
    test is always exact (the skip test only skips when certain, and this
    skips nothing), so the level-0 tail stays exact; a lane that could
    still have taken pyramid skips now steps cell by cell.

    Those rounds are a binary search of the position inside the lane's
    cell: each compares it with the midpoint of the current cell, an
    integer that f32 holds exactly. So the cell they reach is floor(p)
    clamped to the level-0 cells under the lane's cell, which this computes
    in one pass of torch over the planes, on any device, bit for bit the
    same (tests/test_torch_relaxed.py holds it against the JAX rounds)."""
    ox, oy, _, dx, dy, _ = rays
    alive, t, lvl, icx, icy = state

    def descend(o, d, c):
        lo = c << lvl
        hi = lo + (1 << lvl) - 1
        f = torch.floor(o + t * d)
        return torch.clamp(f, lo.to(torch.float32), hi.to(torch.float32)).to(torch.int32)

    return alive, t, torch.zeros_like(lvl), descend(ox, dx, icx), descend(oy, dy, icy)


def l0_tail_flag(state):
    """The "auto" tail's choice, a 0-dim bool on the planes' device: more
    than L0_TAIL_AUTO_THRESH of the alive lanes are at level 0."""
    alive = state[0] != 0
    n_alive = alive.sum()
    n_l0 = (alive & (state[2] == 0)).sum(dtype=torch.int32)
    return n_l0 > (L0_TAIL_AUTO_THRESH * n_alive.to(torch.float32)).to(torch.int32)


def column_key(state, m5: int):
    """Sort key: the 32-cell terrain column of each live lane's current
    cell (at any level), coly * m5 + colx; a dead lane keys m5 * m5, the
    bucket after every live column, so dead lanes sort last."""
    alive, _, lvl, icx, icy = state
    colx = torch.clamp((icx << lvl) >> 5, 0, m5 - 1)
    coly = torch.clamp((icy << lvl) >> 5, 0, m5 - 1)
    return torch.where(alive != 0, coly * m5 + colx, m5 * m5)


def ray_sort_reference(rays, state, res, perm_tot, *, m5: int, moving: tuple, tail=False):
    """The plain torch version of `ray_sort`, with its arguments and result."""
    flag = tail
    if tail:
        # force level 0 before the sort, so the sort key is the tail's column
        forced = force_level0(rays, state)
        if tail == "auto":
            flag = l0_tail_flag(state)
            forced = tuple(torch.where(flag, f, s) for f, s in zip(forced, state))
        state = forced
    perm = torch.argsort(column_key(state, m5), stable=True)
    rays = tuple(x.index_select(0, perm) if i in moving else x for i, x in enumerate(rays))
    state = tuple(x.index_select(0, perm) for x in state)
    if res is not None:
        res = tuple(x.index_select(0, perm) for x in res)
    perm_tot = perm if perm_tot is None else perm_tot.index_select(0, perm)
    return rays, state, res, perm_tot, flag


def _pointers(planes) -> ctypes.Array:
    return (ctypes.c_void_p * max(len(planes), 1))(*(x.data_ptr() for x in planes))


def _check_planes(planes, p: int, dev) -> None:
    for i, x in enumerate(planes):
        if x.shape != (p,) or x.element_size() != 4 or not x.is_contiguous() \
                or x.device != dev:
            raise ValueError(f"plane {i}: want a contiguous 4-byte plane of shape ({p},) on "
                             f"{dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")


def ray_sort(rays, state, res, perm_tot, *, m5: int, moving: tuple, tail=False):
    """One sorted round's reorder. Returns (rays, state, res, perm_tot,
    l0_only).

    rays: the six ray planes, of which those at the indices `moving` ride
    the sort (the others are one value broadcast and stay as they are);
    state: (alive, t, lvl, icx, icy); res: the result planes, or None where
    they are still the constant empty results (nothing to reorder: None is
    returned); perm_tot: the running permutation (lane k of the sorted
    planes is launch lane perm_tot[k]), or None before the first round; m5:
    the terrain columns a side (max(m // 32, 1)); tail: False, or the round
    forces level 0 first: True always, "auto" by `l0_tail_flag`. l0_only is
    the following march pass's tail argument: `tail`, or for "auto" the
    flag on the planes' device (CUDA: int32 (1,), written by the key pass;
    CPU: `l0_tail_flag`'s bool).

    CPU tensors run `ray_sort_reference`; CUDA tensors launch the kernel
    (building it on first use) or raise. The permutation is that of a
    stable sort by `column_key`, on either (int32 on the card, int64 on the
    CPU)."""
    if tail not in TAIL_MODES:
        raise ValueError(f"tail must be True, False or 'auto', not {tail!r}")
    dev = state[0].device
    if dev.type == "cpu":
        return ray_sort_reference(rays, state, res, perm_tot, m5=m5, moving=moving, tail=tail)
    if dev.type != "cuda":
        raise ValueError(f"ray_sort runs on cpu or cuda, not {dev}")
    out = launch_round(_build.library().hmrt_ray_sort, rays, state, res, perm_tot, m5=m5,
                       moving=moving, tail=tail)
    if state[0].shape[0]:  # an empty round launches nothing
        ray_sort.launches += 1
    return out


def launch_round(entry, rays, state, res, perm_tot, *, m5: int, moving: tuple, tail):
    """`ray_sort` on CUDA tensors through the C entry `entry`, which takes
    `hmrt_ray_sort`'s arguments (ray_sort.cu), counting nothing."""
    dev = state[0].device
    p = state[0].shape[0]
    mode = TAIL_MODES[tail]
    extra = [x for i, x in enumerate(rays) if i in moving] + ([] if res is None else list(res))
    _check_planes([*state, *extra, *(rays[:2] + rays[3:5] if mode else ())]
                  + ([] if perm_tot is None else [perm_tot]), p, dev)
    lib = _build.library()
    n_scratch = lib.hmrt_ray_sort_scratch(p, mode)
    if n_scratch < 0:
        raise ValueError(f"ray_sort: {p} lanes need more scratch than int32 counts")
    scratch = torch.empty(n_scratch, dtype=torch.int32, device=dev)
    state_o = [torch.empty_like(x) for x in state]
    extra_o = [torch.empty_like(x) for x in extra]
    perm_o = torch.empty(p, dtype=torch.int32, device=dev)
    flag = torch.empty(1, dtype=torch.int32, device=dev) if tail == "auto" else None
    ox, oy, _, dx, dy, _ = rays
    with torch.cuda.device(dev):
        err = entry(
            *[x.data_ptr() for x in state],
            *[x.data_ptr() if mode else None for x in (ox, oy, dx, dy)],
            _pointers(extra), _pointers(extra_o), len(extra), _pointers(state_o),
            None if perm_tot is None else perm_tot.data_ptr(), perm_o.data_ptr(),
            None if flag is None else flag.data_ptr(), scratch.data_ptr(), n_scratch, p, m5,
            mode, L0_TAIL_AUTO_THRESH, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ray_sort")
    moved = iter(extra_o)
    rays = tuple(next(moved) if i in moving else x for i, x in enumerate(rays))
    res = None if res is None else tuple(moved)
    return rays, tuple(state_o), res, perm_o, tail if flag is None else flag


ray_sort.launches = 0


def ray_unsort(planes, perm_tot):
    """Result planes back to launch order: out[perm_tot[k]] = plane[k].
    CPU tensors: `index_copy_`; CUDA tensors: one launch for up to four
    4-byte planes."""
    dev = perm_tot.device
    if dev.type == "cpu":
        return tuple(torch.empty_like(x).index_copy_(0, perm_tot, x) for x in planes)
    if dev.type != "cuda":
        raise ValueError(f"ray_unsort runs on cpu or cuda, not {dev}")
    p = perm_tot.shape[0]
    _check_planes([*planes, perm_tot], p, dev)
    out = [torch.empty_like(x) for x in planes]
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.hmrt_ray_unsort(perm_tot.data_ptr(), _pointers(planes), _pointers(out),
                                  len(planes), p, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ray_unsort")
    return tuple(out)
