"""The port's viewer server (hmrt_tpu_torch/cli/serve.py) on the CPU: the
same page, state, frames and answers to bad requests as the JAX package's
server, over real HTTP on 127.0.0.1."""

import argparse
import json
import math
import tempfile
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import hmrt_tpu as H
import hmrt_tpu_torch as T
from hmrt_tpu.cli.serve import ViewerSession as JaxViewerSession
from hmrt_tpu.cli.serve import make_handler as jax_make_handler
from hmrt_tpu_torch.api.tiled import TileSceneCache
from hmrt_tpu_torch.cli.serve import ViewerSession, build_parser, make_handler, make_session
from hmrt_tpu_torch.io.image import read_png

torch.set_num_threads(2)  # the suite runs several workers at once

CAM = dict(yaw=math.pi / 2, pitch=-0.2, speed=1.0)


def _eye(terr):
    n = terr.shape[0]
    return (n * 0.5, -n * 0.2, float(terr.max()) + 6.0)


@pytest.fixture(scope="module")
def sessions():
    terr = H.procedural_terrain(64, seed=3)
    ours = ViewerSession(T.make_scene(terr, device="cpu"),
                         T.RenderConfig(width=96, height=64, backend="oracle"),
                         eye=_eye(terr), draft_scale=2, **CAM)
    theirs = JaxViewerSession(H.make_scene(terr, pack=False),
                              H.RenderConfig(width=96, height=64, backend="oracle"),
                              eye=_eye(terr), draft_scale=2, **CAM)
    return ours, theirs


def _decode(png_bytes):
    with tempfile.NamedTemporaryFile(suffix=".png") as f:
        f.write(png_bytes)
        f.flush()
        return read_png(f.name)


def _lsb(a, b):
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def test_frames_equal_jax(sessions):
    ours, theirs = sessions
    assert ours.page() == theirs.page() and ours.state_json() == theirs.state_json()
    params = json.loads(ours.state_json())
    for draft, shape in ((False, (64, 96, 3)), (True, (36, 64, 3))):
        params["draft"] = draft
        img = _decode(ours.render_frame_png(params))
        assert img.shape == shape and img.max() > 0
        assert _lsb(img, _decode(theirs.render_frame_png(params))) <= 1


class _Server:
    """A session's server on 127.0.0.1, port 0, in a thread; shut down on exit."""

    def __init__(self, session, handler=make_handler):
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler(session))
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def __enter__(self):
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()

    def get(self, path):
        return urllib.request.urlopen(self.base + path, timeout=30)

    def post(self, path, body):
        req = urllib.request.Request(self.base + path, data=body, method="POST")
        return urllib.request.urlopen(req, timeout=120)


def test_http_round_trip(sessions):
    ours, theirs = sessions
    with _Server(ours) as srv, _Server(theirs, jax_make_handler) as jsrv:
        page = srv.get("/").read()
        assert b"hmrt_tpu viewer" in page and page == jsrv.get("/index.html").read()
        state = json.loads(srv.get("/state").read())
        assert len(state["eye"]) == 3
        body = json.dumps({"eye": state["eye"], "yaw": state["yaw"], "pitch": state["pitch"],
                           "draft": True}).encode()
        resp = srv.post("/frame", body)
        assert resp.headers["Content-Type"] == "image/png"
        img = _decode(resp.read())
        assert img.shape == (36, 64, 3)
        assert _lsb(img, _decode(jsrv.post("/frame", body).read())) <= 1


@pytest.mark.parametrize("path,body,code", [
    ("/nope", None, 404),
    ("/frame", b"not json", 500),
    ("/frame", json.dumps({"eye": [0, "nan", 1], "yaw": 0, "pitch": 0}).encode(), 500),
    ("/frame", json.dumps({"eye": [0, 0, 1]}).encode(), 500),
    ("/state2", b"{}", 404),
    ("/frame", b" " * ((1 << 16) + 1), 413),
])
def test_bad_requests_answer_as_jax(sessions, path, body, code):
    for srv_args in ((sessions[0],), (sessions[1], jax_make_handler)):
        with _Server(*srv_args) as srv:
            with pytest.raises(urllib.error.HTTPError) as e:
                srv.get(path) if body is None else srv.post(path, body)
            assert e.value.code == code


def test_tiled_viewer_session():
    """Frames stream through render_frame_tiled with the scene cache and
    match the resident session's within 1 LSB; a second frame builds nothing."""
    terr = H.procedural_terrain(65, seed=3)
    cfg = T.RenderConfig(width=96, height=64, backend="oracle")
    cache = TileSceneCache(8)
    tiled = ViewerSession(None, cfg, eye=_eye(terr), tiled=(terr, 32, cache), device="cpu",
                          **CAM)
    resident = ViewerSession(T.make_scene(terr, device="cpu"), cfg, eye=_eye(terr), **CAM)
    params = json.loads(tiled.state_json())
    a = _decode(tiled.render_frame_png(params))
    assert a.shape == (64, 96, 3)
    assert _lsb(a, _decode(resident.render_frame_png(params))) <= 1
    assert cache.built > 0
    before = cache.built
    tiled.render_frame_png(params)
    assert cache.built == before


def _args(*argv):
    return build_parser().parse_args(list(argv))


def test_make_session_like_jax(monkeypatch):
    from hmrt_tpu.cli.serve import build_parser as jax_build_parser
    from hmrt_tpu.cli.serve import make_session as jax_make_session
    argv = ["--size", "64", "--width", "96", "--height", "64", "--shadows"]
    ours = make_session(_args(*argv, "--cpu"))
    theirs = jax_make_session(jax_build_parser().parse_args(argv))
    assert ours.state_json() == theirs.state_json()
    assert (ours.draft_config.width, ours.draft_config.height) == (
        theirs.draft_config.width, theirs.draft_config.height)
    tiled = make_session(_args(*argv, "--cpu", "--tile", "32"))
    assert tiled.tiled is not None and tiled.device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_session(_args(*argv))
    assert isinstance(_args(), argparse.Namespace)
