"""Local flythrough viewer: an .npy stack -> a self-contained HTML player
(frames inlined as base64 PNGs, play/scrub controls) or an animated PNG.

Counterpart of `hmrt_tpu/cli/view.py`, the same page; numpy only.

    python -m hmrt_tpu_torch.cli.render --size 512 --flythrough 48 -o fly.npy
    python -m hmrt_tpu_torch.cli.view fly.npy -o fly.html   # or -o fly.apng
"""

from __future__ import annotations

import argparse
import base64
import os
import sys

import numpy as np

_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>hmrt_tpu flythrough</title>
<style>
 body {{ background:#111; color:#ccc; font-family:monospace; text-align:center }}
 img {{ image-rendering:auto; max-width:96vw; border:1px solid #333 }}
 .bar {{ margin:10px }}
</style></head><body>
<h3>hmrt_tpu flythrough — {n} frames</h3>
<img id="v">
<div class="bar">
 <button onclick="togglePlay()">play/pause</button>
 <input id="s" type="range" min="0" max="{nm1}" value="0"
        style="width:60%" oninput="seek(this.value)">
 <span id="t"></span>
</div>
<script>
const frames = [{frames}];
let i = 0, playing = true;
const img = document.getElementById('v');
const slider = document.getElementById('s');
const label = document.getElementById('t');
function show(k) {{ img.src = 'data:image/png;base64,' + frames[k];
  slider.value = k; label.textContent = (k+1) + '/' + frames.length; }}
function tick() {{ if (playing) {{ i = (i+1) % frames.length; show(i); }} }}
function togglePlay() {{ playing = !playing; }}
function seek(v) {{ playing = false; i = +v; show(i); }}
show(0); setInterval(tick, 1000/24);
</script></body></html>
"""


def main(argv=None):
    p = argparse.ArgumentParser(prog="hmrt-view",
                                description="flythrough .npy -> HTML player")
    p.add_argument("stack", help=".npy flythrough stack (F, H, W, 3)")
    p.add_argument("-o", "--output", default=None,
                   help=".html player (default) or .apng animated PNG")
    p.add_argument("--fps", type=float, default=24.0)
    args = p.parse_args(argv)

    from hmrt_tpu_torch.io.image import encode_png, write_apng

    stack = np.load(args.stack)
    if stack.ndim != 4 or stack.shape[-1] != 3:
        raise SystemExit(f"expected (F, H, W, 3) stack, got {stack.shape}")
    if args.output and args.output.endswith(".apng"):
        write_apng(args.output, stack, fps=args.fps)
        print(f"wrote {args.output} ({stack.shape[0]} frames, APNG)")
        return 0
    encoded = ["'" + base64.b64encode(encode_png(f)).decode() + "'"
               for f in stack]
    out = args.output or (os.path.splitext(args.stack)[0] + ".html")
    with open(out, "w") as fh:
        fh.write(_HTML.format(n=len(encoded), nm1=len(encoded) - 1,
                              frames=",".join(encoded)))
    print(f"wrote {out} ({len(encoded)} frames); open it in a browser")
    return 0


if __name__ == "__main__":
    sys.exit(main())
