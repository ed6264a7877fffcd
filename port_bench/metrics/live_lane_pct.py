"""Lanes handed alive into the march kernel's launches over the lanes
launched, in %, over the armed spans sub-run's frames: counted on the
card by the kernel itself (`march_pass.mode_launches.read_live`). Every
sorted round gathers and marches all P lanes, dead ones included."""

from port_bench import stages


def read(ctx):
    r = stages.reading(ctx)
    return r.live_pct() if r else None
