"""Interactive viewer: a local HTTP fly-camera around the renderer.

Counterpart of `hmrt_tpu/cli/serve.py`: the same page, endpoints and
answers (GET / and /state, POST /frame with the camera as JSON; 404 for
another path, 413 for a body over 64 KiB, 500 with the error's text when
a frame fails, a non-finite camera among them). The browser page captures
WASD/mouse input, POSTs the camera, and shows the PNG rendered back; while
the camera moves it asks for "draft" frames at a reduced resolution, and
one full frame once input goes idle. Frames render through `render_frame`
on the card (`--cpu`: on the CPU), or through `render_frame_tiled` with a
`TileSceneCache` in `--tile` mode.

    python -m hmrt_tpu_torch.cli.serve [heightmap] --width 960 --height 540
    # then open http://localhost:8765/

Standard library http.server and the package's PNG writer.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import threading

import numpy as np

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>hmrt_tpu viewer</title>
<style>
 body { background:#111; color:#ccc; font-family:monospace; text-align:center;
        margin:8px }
 img  { max-width:96vw; border:1px solid #333; cursor:crosshair }
 #hud { margin:6px; color:#8a8 }
 kbd  { background:#222; border:1px solid #444; border-radius:3px;
        padding:0 4px }
</style></head><body>
<div id="hud">connecting…</div>
<img id="v" draggable="false">
<div>move <kbd>W</kbd><kbd>A</kbd><kbd>S</kbd><kbd>D</kbd>,
 up/down <kbd>Q</kbd><kbd>E</kbd>, look: drag mouse,
 speed <kbd>shift</kbd>, reset <kbd>R</kbd></div>
<script>
let st = null;          // {eye:[x,y,z], yaw, pitch, speed}
let keys = {};
let ticking = false, lastUrl = null;
let dragging = false, lastX = 0, lastY = 0;
let inflight = false, dirty = true, wantFull = false, fullTimer = null;
const img = document.getElementById('v');
const hud = document.getElementById('hud');

async function init() {
  st = await (await fetch('/state')).json();
  requestFrame();
  if (!ticking) { ticking = true; setInterval(tick, 50); }
}
function dir() {
  const cp = Math.cos(st.pitch), sp = Math.sin(st.pitch);
  const cy = Math.cos(st.yaw),  sy = Math.sin(st.yaw);
  return [cp*cy, cp*sy, sp];
}
function tick() {
  const d = dir();
  const right = [d[1], -d[0], 0];   // matches Camera.basis r = f x up
  const v = st.speed * (keys['shift'] ? 4 : 1);
  let moved = false;
  const add = (vec, s) => { st.eye[0]+=vec[0]*s; st.eye[1]+=vec[1]*s;
                            st.eye[2]+=vec[2]*s; moved = true; };
  if (keys['w']) add(d,  v);
  if (keys['s']) add(d, -v);
  if (keys['a']) add(right, -v);
  if (keys['d']) add(right,  v);
  if (keys['q']) add([0,0,1],  v);
  if (keys['e']) add([0,0,1], -v);
  if (moved) dirty = true;
  if (dirty) requestFrame();
}
async function requestFrame() {
  if (inflight || !st) return;
  inflight = true;
  const draft = !wantFull;
  dirty = false; wantFull = false;
  const t0 = performance.now();
  try {
    const r = await fetch('/frame', {method:'POST',
      body: JSON.stringify({eye:st.eye, yaw:st.yaw, pitch:st.pitch,
                            draft:draft})});
    const blob = await r.blob();
    if (lastUrl) URL.revokeObjectURL(lastUrl);
    lastUrl = URL.createObjectURL(blob);
    img.src = lastUrl;
    const ms = (performance.now()-t0).toFixed(0);
    hud.textContent = `eye ${st.eye.map(x=>x.toFixed(1))}  ` +
      `yaw ${(st.yaw*180/Math.PI).toFixed(0)}°  ` +
      `pitch ${(st.pitch*180/Math.PI).toFixed(0)}°  ${ms} ms ` +
      (draft ? '(draft)' : '(full)');
  } finally {
    inflight = false;
    if (dirty) requestFrame();
    else if (draft) {      // settle to one full-res frame after idling
      clearTimeout(fullTimer);
      fullTimer = setTimeout(() => { wantFull = true; dirty = true;
                                     requestFrame(); }, 250);
    }
  }
}
window.addEventListener('keydown', e => {
  const k = e.key.toLowerCase();
  if (k === 'r') { init(); return; }
  keys[k === 'shift' ? 'shift' : k] = true;
});
window.addEventListener('keyup', e => {
  const k = e.key.toLowerCase();
  keys[k === 'shift' ? 'shift' : k] = false;
});
img.addEventListener('mousedown', e => { dragging = true;
  lastX = e.clientX; lastY = e.clientY; });
window.addEventListener('mouseup', () => dragging = false);
window.addEventListener('mousemove', e => {
  if (!dragging || !st) return;
  st.yaw   -= (e.clientX - lastX) * 0.004;
  st.pitch -= (e.clientY - lastY) * 0.004;
  st.pitch = Math.max(-1.5, Math.min(1.5, st.pitch));
  lastX = e.clientX; lastY = e.clientY; dirty = true;
});
init();
</script></body></html>
"""


class ViewerSession:
    """Renderer and camera state behind the HTTP handlers (testable without
    sockets: call page() / state_json() / render_frame_png() directly).
    Frames render on the scene's device, or on `device` (default: the
    card) in tiled mode."""

    def __init__(self, scene, config, *, eye, yaw, pitch, speed,
                 draft_scale=4, tiled=None, device=None):
        import dataclasses

        from hmrt_tpu_torch.device import resolve

        self.scene = scene
        self.config = config
        # out-of-core mode: (source, tile_cells, TileSceneCache); frames go
        # through api.tiled with the cache keeping the working set warm
        self.tiled = tiled
        self.device = scene.device if scene is not None else resolve(device)
        self.draft_config = dataclasses.replace(
            config,
            width=max(64, (config.width // draft_scale) // 2 * 2),
            height=max(36, (config.height // draft_scale) // 2 * 2))
        self.eye0, self.yaw0, self.pitch0 = tuple(eye), yaw, pitch
        self.speed = speed
        self._lock = threading.Lock()

    def page(self) -> bytes:
        return _PAGE.encode()

    def state_json(self) -> bytes:
        return json.dumps({"eye": list(self.eye0), "yaw": self.yaw0,
                           "pitch": self.pitch0, "speed": self.speed}).encode()

    def camera(self, params: dict):
        """The Camera and RenderConfig a /frame request asks for; raises
        ValueError on a non-finite camera."""
        import hmrt_tpu_torch as T

        eye = [float(v) for v in params["eye"]]
        yaw = float(params["yaw"])
        pitch = float(params["pitch"])
        # server-side validation (the client JS also clamps, but the
        # endpoint is reachable directly): non-finite state would NaN the
        # whole frame, and pitch at +-pi/2 makes the view direction
        # parallel to up so the camera basis degenerates
        if not all(math.isfinite(v) for v in (*eye, yaw, pitch)):
            raise ValueError("non-finite camera parameter")
        pitch = max(-1.55, min(1.55, pitch))
        cp = math.cos(pitch)
        d = (cp * math.cos(yaw), cp * math.sin(yaw), math.sin(pitch))
        target = (eye[0] + d[0], eye[1] + d[1], eye[2] + d[2])
        cfg = self.draft_config if params.get("draft") else self.config
        return T.Camera.create(eye=tuple(eye), target=target, fov_y_deg=55.0,
                               device=self.device), cfg

    def render_frame_png(self, params: dict) -> bytes:
        import hmrt_tpu_torch as T
        from hmrt_tpu_torch.io.image import encode_png

        cam, cfg = self.camera(params)
        with self._lock:     # one render at a time (one card)
            if self.tiled is not None:
                source, tile_cells, cache = self.tiled
                fr = T.render_frame_tiled(source, cam, cfg, tile=tile_cells, cache=cache,
                                          device=self.device)
            else:
                fr = T.render_frame(self.scene, cam, cfg)
            img = fr.color.cpu().numpy()
        return encode_png(img)


def make_handler(session: ViewerSession):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                self._send(200, "text/html", session.page())
            elif self.path == "/state":
                self._send(200, "application/json", session.state_json())
            else:
                self._send(404, "text/plain", b"not found")

        def do_POST(self):
            if self.path != "/frame":
                self._send(404, "text/plain", b"not found")
                return
            length = int(self.headers.get("Content-Length", "0"))
            if length > 1 << 16:
                self._send(413, "text/plain", b"too large")
                return
            try:
                params = json.loads(self.rfile.read(length))
                png = session.render_frame_png(params)
            except Exception as e:  # the server keeps running; the page shows why
                self._send(500, "text/plain", str(e).encode())
                return
            self._send(200, "image/png", png)

    return Handler


def build_parser():
    p = argparse.ArgumentParser(
        prog="hmrt-serve",
        description="interactive fly-camera viewer (localhost HTTP)")
    p.add_argument("heightmap", nargs="?", default=None)
    p.add_argument("--size", type=int, default=1024,
                   help="procedural terrain size when no file given")
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--width", type=int, default=960)
    p.add_argument("--height", type=int, default=540)
    p.add_argument("--draft-scale", type=int, default=4,
                   help="resolution divisor while the camera is moving")
    p.add_argument("--shading", choices=["lambert", "phong"], default="phong")
    p.add_argument("--albedo", default=None, metavar="IMAGE",
                   help="albedo texture draped over the terrain")
    p.add_argument("--shadows", action="store_true")
    p.add_argument("--fog", action="store_true")
    p.add_argument("--backend", choices=["auto", "oracle", "pallas", "compact"],
                   default="auto")
    p.add_argument("--tile", type=int, default=0, metavar="CELLS",
                   help="fly over an out-of-core map: stream CELLS^2-cell tiles "
                        "(api/tiled.py) instead of a resident scene; a .raw/.r32 "
                        "heightmap is mmap'd, never fully loaded")
    p.add_argument("--tile-cache", type=int, default=8, metavar="N",
                   help="tile sub-scenes kept resident in --tile mode")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--cpu", action="store_true",
                   help="render on the CPU (the kernels' plain versions) instead of the card")
    return p


def make_session(args) -> ViewerSession:
    import hmrt_tpu_torch as T
    from hmrt_tpu_torch.device import resolve

    device = resolve("cpu" if getattr(args, "cpu", False) else None)
    tile = getattr(args, "tile", 0)
    if tile:
        # out-of-core viewing: keep the map on disk or in host memory and
        # stream tiles per frame, warmed by the LRU scene cache
        from hmrt_tpu_torch.api.tiled import TileSceneCache

        if args.albedo:
            raise SystemExit("--albedo is not supported with --tile")
        if args.heightmap and args.heightmap.lower().endswith((".raw", ".r32")):
            from hmrt_tpu_torch.io.native import RawTileMap
            source = RawTileMap(args.heightmap)
            n = source.side
            probe = source.tile(0, 0, min(n, 512), min(n, 512))
            zmax = float(probe.max())
        elif args.heightmap:
            source = T.load_heightmap(args.heightmap)
            side = min(source.shape)
            source = np.asarray(source[:side, :side], np.float32)
            n, zmax = side, float(source.max())
        else:
            source = T.procedural_terrain(args.size, seed=args.seed)
            n, zmax = source.shape[0], float(source.max())
        cfg = T.RenderConfig(width=args.width, height=args.height, shading=args.shading,
                             shadows=args.shadows, fog=args.fog, backend=args.backend)
        return ViewerSession(
            None, cfg, eye=(n * 0.5, -n * 0.2, zmax + n * 0.05),
            yaw=math.pi / 2, pitch=-0.2, speed=n / 100.0,
            draft_scale=args.draft_scale,
            tiled=(source, tile, TileSceneCache(args.tile_cache)), device=device)

    if args.heightmap:
        terr = T.load_heightmap(args.heightmap)
        side = min(terr.shape)
        terr = terr[:side, :side]
    else:
        terr = T.procedural_terrain(args.size, seed=args.seed)
    n = terr.shape[0]
    zmax = float(terr.max())
    albedo = None
    if args.albedo:
        from hmrt_tpu_torch.io.heightmap import load_texture
        albedo = load_texture(args.albedo, n)
    scene = T.make_scene(terr, albedo=albedo, device=device)
    cfg = T.RenderConfig(width=args.width, height=args.height, shading=args.shading,
                         shadows=args.shadows, fog=args.fog, texture=albedo is not None,
                         backend=args.backend)
    return ViewerSession(scene, cfg, eye=(n * 0.5, -n * 0.2, zmax + n * 0.05),
                         yaw=math.pi / 2, pitch=-0.2, speed=n / 100.0,
                         draft_scale=args.draft_scale)


def main(argv=None):
    from http.server import ThreadingHTTPServer

    args = build_parser().parse_args(argv)
    session = make_session(args)
    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(session))
    print(f"viewer on http://{args.host}:{args.port}/  (ctrl-c to stop)", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
