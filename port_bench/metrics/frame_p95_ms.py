"""The 95th percentile of every frame's time in the window, call to the
return of the synchronise (host clock): the stutter a viewer sees."""

import numpy as np


def read(ctx):
    return float(np.percentile(ctx.frame_s, 95)) * 1e3 if ctx.frame_s else None
