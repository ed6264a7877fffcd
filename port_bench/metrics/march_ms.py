"""Device ms a frame (busy and idle) charged to the primary march: the
launches under `hmrt.primary` outside its sorts, the three `hmrt.march.*`
kernel launches of B3 and the result planes they start from (stages.py,
the armed spans sub-run)."""

from port_bench import stages


def read(ctx):
    r = stages.reading(ctx)
    return r.ms("primary march") if r else None
