"""Seconds of `make_scene` from the host arrays to a synchronised scene
on the card (host clock, in set-up): pyramids, corner, shade and albedo
records."""


def read(ctx):
    return ctx.facts.get("scene_build_s")
