"""Device ms a frame (busy and idle) charged to the ray sorts of both
marches: `hmrt.sort` (a sorted round's level-0 descent and tail flag, key,
argsort and gathers) and `hmrt.unsort` (the scatter back to launch order),
primary and shadow (stages.py, the armed spans sub-run)."""

from port_bench import stages


def read(ctx):
    r = stages.reading(ctx)
    return r.ms("primary sort", "shadow sort") if r else None
