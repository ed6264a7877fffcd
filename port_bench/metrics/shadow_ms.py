"""Device ms a frame (busy and idle) charged under `hmrt.shadow` outside
its sorts: the shadow rays' start and the shadow march's kernel launches
(stages.py, the armed spans sub-run)."""

from port_bench import stages


def read(ctx):
    r = stages.reading(ctx)
    return r.ms("shadow march") if r else None
