"""The port's tools (``tools/``), the counterparts of tests/test_tools.py,
on the CPU: the installer, the dedicated server CLI (in a thread, as the
JAX test runs it, its worldgen on the CPU), the logging knob, the web
viewer and the terminal client's frame command.

The web viewer's pump is driven in the test's thread (a ``ViewerState``
whose pump thread is never started, its ``pump_once()`` called) after
each post, at the time of the last ``/input`` post: the viewer drops held
keys 0.5 s after that post, so a test that reads the wall clock, or waits
on a pump thread, depends on the machine's load.
"""

import json
import logging
import os
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from voxelraytracing_tpu_torch.client import ServerConn
from voxelraytracing_tpu_torch.engine import EngineApp
from voxelraytracing_tpu_torch.engine.ui import UiState
from voxelraytracing_tpu_torch.net import ServerCmd
from voxelraytracing_tpu_torch.tools import client_cli, servercli, web_viewer
from voxelraytracing_tpu_torch.tools.installer import install
from voxelraytracing_tpu_torch.utils import log as vlog

from torch_one_thread import torch_one_thread  # noqa: F401 (autouse)
from torch_served import ServedWorld, flat_root, stream_window


def test_installer_copies_packs(tmp_path):
    dest, installed = install(str(tmp_path))
    assert "datapacks/terra" in installed
    assert os.path.isfile(os.path.join(dest, "datapacks", "terra",
                                       "voxels.ron"))
    _, installed2 = install(str(tmp_path))  # second run: no overwrite
    assert installed2 == []


def test_servercli_serves_and_saves(tmp_path, monkeypatch):
    """``run_server`` in a thread: a client's chunk request is answered
    and the server stops at its tick budget. Its device comes from
    ``VOXELTPU_DEVICE``, the card by default."""
    monkeypatch.delenv(servercli.DEVICE_ENV, raising=False)
    assert servercli.server_device() == "cuda"
    monkeypatch.setenv(servercli.DEVICE_ENV, "cpu")
    assert servercli.server_device() == "cpu"
    assert servercli.server_device("cuda:1") == "cuda:1"
    root = flat_root(tmp_path)
    ready = threading.Event()
    info = {}

    def on_ready(state, port):
        info["port"], info["state"] = port, state
        ready.set()

    t = threading.Thread(
        target=servercli.run_server, args=(root, "Flat"),
        kwargs=dict(port=0, max_ticks=1500, quiet=True, on_ready=on_ready,
                    cli=False),
        daemon=True)
    t.start()
    assert ready.wait(timeout=120)
    assert info["state"].world.gen.device.type == "cpu"

    conn = ServerConn.establish(("127.0.0.1", info["port"]), "cli-test")
    assert len(conn.voxel_pack) > 50
    conn.write(ServerCmd.LOAD_CHUNKS, chunks=[(0, 0, 0)])
    got = []
    for _ in range(1200):
        got.extend(conn.try_read())
        if got:
            break
        time.sleep(0.05)
    assert got and got[0][1]["pos"] == (0, 0, 0)
    conn.write(ServerCmd.DISCONNECT_NOTICE)
    conn.close()
    t.join(timeout=120)
    assert not t.is_alive()
    assert info["state"].spawn is not None


def test_logging_env_knob(monkeypatch):
    """VOXELTPU_LOG controls the port's package logger. Its handler,
    level and propagation are restored afterwards, so a later test of this
    process still reads records through ``caplog``."""
    root = logging.getLogger("voxelraytracing_tpu_torch")
    saved = (list(root.handlers), root.propagate, root.level)
    monkeypatch.setenv("VOXELTPU_LOG", "debug")
    monkeypatch.setattr(vlog, "_initialized", False)
    try:
        logger = vlog.init_logging()
        assert logger.level == logging.DEBUG
        child = vlog.get_logger("server.state")
        assert child.name == "voxelraytracing_tpu_torch.server.state"
        assert child.getEffectiveLevel() == logging.DEBUG
        vlog._initialized = False
        logger = vlog.init_logging("off")
        assert logger.level > logging.CRITICAL
    finally:
        root.handlers[:] = saved[0]
        root.propagate = saved[1]
        root.setLevel(saved[2])


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    """An engine session on the CPU joined to a served "Flat" world, its
    2³ window streamed."""
    root = flat_root(tmp_path_factory.mktemp("tools"))
    sw = ServedWorld(root)
    app = EngineApp.join(("127.0.0.1", sw.port), "viewer", resource_root=root,
                         resolution=(128, 64), world_size_chunks=2,
                         device="cpu", max_nodes=1 << 20)
    stream_window(app, n=8)
    yield app
    app.close()
    sw.stop()


def _get(base, path):
    return urllib.request.urlopen(base + path, timeout=10)


def _post(base, path, body):
    urllib.request.urlopen(urllib.request.Request(
        base + path, data=json.dumps(body).encode(), method="POST"),
        timeout=10)


def test_web_viewer_serves_frames_and_input(session):
    """The browser frontend streams engine frames and applies posted
    input, palette and visuals actions; a deliberate panic stops the pump
    and surfaces in /stats."""
    app = session
    state = web_viewer.ViewerState(app, max_fps=10.0)  # no pump thread
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                web_viewer.make_handler(state))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        assert b"/stream" in _get(base, "/").read()
        with pytest.raises(urllib.error.HTTPError):
            _get(base, "/frame")  # no frame yet: 503
        state.pump_once()
        r = _get(base, "/frame")
        assert r.headers["Content-Type"] in ("image/jpeg", "image/bmp")
        assert r.read()
        s0 = json.loads(_get(base, "/stats").read())

        _post(base, "/input", {"keys": {"forward": True},
                               "look": [120.0, 0.0]})
        _post(base, "/act", {"toggle_fly": True})
        for _ in range(5):
            state.pump_once(now=state.last_input)  # the keys still held
        s1 = json.loads(_get(base, "/stats").read())
        assert s1["pos"] != s0["pos"]

        _post(base, "/act", {"scroll": 1})
        _post(base, "/act", {"crosshair": {"style": "dot", "size": 12}})
        state.pump_once()
        s2 = json.loads(_get(base, "/stats").read())
        assert s2["placing"] != s1["placing"]
        assert app.crosshair.style == "dot" and app.crosshair.size == 12
        assert s2["world_size"] == 2

        _post(base, "/act", {"panic": True})
        with pytest.raises(RuntimeError, match="panic") as e:
            state.pump_once()
        state.crash(e.value)
        assert not state.running
        s3 = json.loads(_get(base, "/stats").read())
        assert "panic" in s3.get("error", "")
    finally:
        httpd.shutdown()
        httpd.server_close()
        state.stop()
        app.crosshair.style = "cross"


def test_frames_without_pil(session, tmp_path, monkeypatch, capsys):
    """Where PIL is missing (as on the card's machine) the viewer sends
    uncompressed BMP and the terminal client's ``frame`` writes NPY."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    img = (np.arange(2 * 3 * 3) * 10).astype(np.uint8).reshape(2, 3, 3)
    data, ctype = web_viewer._encode_jpeg(img)
    assert ctype == "image/bmp" and data[:2] == b"BM"
    assert int.from_bytes(data[18:22], "little") == 3  # width
    assert int.from_bytes(data[22:26], "little") == 2  # height
    row = data[54:54 + 12]  # bottom row first, BGR, padded to 4 bytes
    assert row[:3] == bytes(img[1, 0, ::-1])
    path = str(tmp_path / "frame.png")
    client_cli._game_cmd(session, UiState(), None, "frame", [path])
    assert f"wrote {path}.npy" in capsys.readouterr().out
    frame = np.load(path + ".npy")
    assert frame.shape == (64, 128, 3) and np.isfinite(frame).all()
