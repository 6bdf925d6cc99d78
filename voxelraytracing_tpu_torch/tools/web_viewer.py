"""Browser frontend: MJPEG frame stream + keyboard/mouse input over HTTP.

Port of ``voxelraytracing_tpu/tools/web_viewer.py``. The graphical shell
for a windowless host — the analog of the
reference's winit window + egui overlay (clientdesktop/src/main.rs:113-740)
for machines where the renderer lives behind an SSH/tunnel boundary.
Frames come off the engine's device once each, after the draw. A
single-page app streams engine frames (multipart JPEG, any browser) and
posts WASD/mouse input back; the debug overlay (fps, position, chunk and
node-pool occupancy — ui.rs:105-178) renders as HTML.

Usage:
  python -m voxelraytracing_tpu_torch.tools.web_viewer [resource_root]
      [--world NAME] [--port 8765] [--resolution 640x360] [--device cuda]

stdlib-only (http.server + PNG via PIL if present, else raw BMP).
"""

import io
import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..models.raytracer import to_srgb8

_PAGE = """<!doctype html>
<html><head><title>voxelraytracing_tpu_torch</title><style>
body { background:#111; color:#ddd; font-family:monospace; margin:0 }
#wrap { display:flex } #hud { padding:12px; min-width:260px }
img { image-rendering:pixelated; width:70vw }
kbd { background:#333; padding:1px 5px; border-radius:3px }
</style></head><body>
<div id=wrap>
<img id=frame src="/stream" tabindex=0>
<div id=hud><h3>BlockWorld / GPU</h3>
<div id=stats>connecting…</div>
<p><kbd>WASD</kbd> move · <kbd>Space</kbd> jump · <kbd>F</kbd> fly ·
<kbd>Shift</kbd> sprint · drag = look · wheel = palette ·
<kbd>B</kbd> break · <kbd>P</kbd> place · <kbd>H</kbd> heatmap</p>
<h4>Visuals</h4>
<label>crosshair
<select id=chstyle onchange="visuals()">
<option>cross</option><option>dot</option><option>off</option>
</select></label>
<label> size <input id=chsize type=range min=2 max=24 value=8
 onchange="visuals()"></label><br>
<label>world size <input id=wsize type=range min=10 max=80 value=30
 onchange="post('/act',{world_size:+this.value})"></label>
<span id=wsizev>30</span> chunks
</div></div>
<script>
const keys = {};
const map = {w:'forward', a:'left', s:'backward', d:'right',
             ' ':'jump', shift:'sprint'};
let look = [0, 0];
onkeydown = e => { if (e.repeat) return; const k = e.key.toLowerCase();
  if (k === 'f') post('/act', {toggle_fly: true});
  else if (k === 'b') post('/act', {break_voxel: true});
  else if (k === 'p') post('/act', {place_voxel: true});
  else if (k === 'h') post('/act', {heatmap: true});
  else if (k === 'f7' && e.shiftKey) post('/act', {panic: true});
  else if (map[k]) keys[map[k]] = true; };
onkeyup = e => { const k = e.key.toLowerCase();
  if (map[k]) keys[map[k]] = false; };
let drag = null;
onmousedown = e => drag = [e.clientX, e.clientY];
onmouseup = () => drag = null;
onmousemove = e => { if (drag) {
  look[0] += e.clientX - drag[0]; look[1] += e.clientY - drag[1];
  drag = [e.clientX, e.clientY]; } };
onwheel = e => post('/act', {scroll: e.deltaY < 0 ? 1 : -1});
function visuals() {
  post('/act', {crosshair: {style: chstyle.value, size: +chsize.value}}); }
function post(u, body) { fetch(u, {method:'POST', body:JSON.stringify(body)}); }
setInterval(() => { post('/input', {keys, look}); look = [0, 0]; }, 50);
setInterval(async () => {
  const s = await (await fetch('/stats')).json();
  document.getElementById('wsizev').textContent = s.world_size;
  document.getElementById('stats').innerHTML =
    `fps ${s.fps.toFixed(1)}<br>pos ${s.pos.map(x=>x.toFixed(1)).join(', ')}`
    + `<br>chunks ${s.chunks}<br>node pool ${s.pool_pct.toFixed(1)}%`
    + `<br>placing voxel ${s.placing}`;
}, 500);
</script></body></html>"""


def _encode_jpeg(img_u8):
    """f32/u8 [H,W,3] -> JPEG bytes (PIL), falling back to uncompressed
    BMP (stdlib-only hosts; browsers accept image/bmp in MJPEG parts)."""
    try:
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(img_u8).save(buf, "JPEG", quality=85)
        return buf.getvalue(), "image/jpeg"
    except ImportError:
        h, w, _ = img_u8.shape
        row = (w * 3 + 3) & ~3
        size = 54 + row * h
        hdr = (b"BM" + size.to_bytes(4, "little") + b"\0\0\0\0" +
               (54).to_bytes(4, "little") + (40).to_bytes(4, "little") +
               w.to_bytes(4, "little") + h.to_bytes(4, "little") +
               (1).to_bytes(2, "little") + (24).to_bytes(2, "little") +
               b"\0" * 24)
        body = bytearray()
        pad = b"\0" * (row - w * 3)
        for y in range(h - 1, -1, -1):
            body += img_u8[y, :, ::-1].tobytes() + pad
        return bytes(hdr) + bytes(body), "image/bmp"


class ViewerState:
    """Engine pump: one thread owns the EngineApp (its builder, node
    mirror and frame tokens are not shared across threads) and produces
    frames + stats. :meth:`pump_once` is one iteration of that loop, for
    callers that drive it from their own thread instead."""

    def __init__(self, app, max_fps=20.0):
        from ..client import PlayerInput

        self.app = app
        self._PlayerInput = PlayerInput
        self.keys = {}
        self.look = [0.0, 0.0]
        self.lock = threading.Lock()
        self.frame = None          # latest encoded frame
        self.ctype = "image/jpeg"
        self.stats = {}
        self.actions = []
        self.last_input = 0.0   # staleness: keys expire without /input
        self.max_fps = max_fps
        self.running = True
        self.thread = threading.Thread(target=self._loop, daemon=True)

    def _loop(self):
        # crash-only: a pump exception (including the deliberate panic
        # action) stops frame production and surfaces in /stats; the
        # owner's shutdown path (server stop, app.close) still runs.
        try:
            self._pump()
        except Exception as e:  # noqa: BLE001 — crash path by design
            self.crash(e)

    def _pump(self):
        while self.running:
            t0 = time.monotonic()
            self.pump_once(t0)
            dt = time.monotonic() - t0
            wait = 1.0 / self.max_fps - dt
            if wait > 0:
                time.sleep(wait)

    def pump_once(self, now=None):
        """Apply the input and actions posted since the last call, step
        the game and draw, encode and publish one frame."""
        app = self.app
        t0 = time.monotonic() if now is None else now
        with self.lock:
            # a closed tab stops POSTing /input; expire held keys so
            # the player doesn't walk forever on a dead connection
            if t0 - self.last_input > 0.5:
                self.keys = {}
            keys = dict(self.keys)
            lx, ly = self.look
            self.look = [0.0, 0.0]
            actions = self.actions
            self.actions = []
        for act in actions:
            if act.get("toggle_fly"):
                keys["toggle_fly"] = True
            if act.get("break_voxel"):
                app.break_voxel()
            if act.get("place_voxel"):
                app.place_voxel()
            if act.get("heatmap"):
                app.toggle_step_heatmap()
            if act.get("scroll"):
                app.cycle_placing_voxel(int(act["scroll"]))
            if act.get("crosshair"):
                ch = act["crosshair"]
                if ch.get("style") in ("off", "dot", "cross"):
                    app.crosshair.style = ch["style"]
                if "size" in ch:
                    app.crosshair.size = max(1, int(ch["size"]))
            if act.get("world_size"):
                app.resize_world(int(act["world_size"]))
            if act.get("panic"):
                # the reference's deliberate Shift+F7 panic
                # (main.rs:374-376): crash the frame pump on purpose
                # to exercise the shutdown path
                raise RuntimeError(
                    "deliberate panic (Shift+F7 crash-path test)"
                )
        app.update(net_budget_s=0.02)
        app.update_input(
            self._PlayerInput(
                cursor_movement=(float(lx), float(ly)),
                forward=bool(keys.get("forward")),
                backward=bool(keys.get("backward")),
                left=bool(keys.get("left")),
                right=bool(keys.get("right")),
                jump=bool(keys.get("jump")),
                sprint=bool(keys.get("sprint")),
                toggle_fly=bool(keys.get("toggle_fly")),
            )
        )
        app.update_game()
        img = to_srgb8(app.draw_frame())
        data, ctype = _encode_jpeg(np.ascontiguousarray(img))
        ov = app.debug_overlay()
        with self.lock:
            self.frame = data
            self.ctype = ctype
            self.stats = {
                "fps": float(ov["fps"]),
                "pos": list(ov["player_pos"]),
                "chunks": int(ov["chunks_populated"]),
                "pool_pct": 100.0 * float(ov["node_space_used_frac"]),
                "placing": int(ov["placing_voxel"]),
                "world_size": int(ov["world_size_chunks"]),
            }

    def stop(self):
        self.running = False
        # join before the caller closes the app: a pump iteration may be
        # mid draw_frame()/update() and must not race the teardown
        if self.thread.is_alive():
            self.thread.join(timeout=30.0)

    def crash(self, e):
        """Stop frame production and surface ``e`` in /stats."""
        with self.lock:
            self.stats = dict(self.stats or {}, error=str(e))
        self.running = False


def make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            if self.path == "/":
                body = _PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/stats":
                with state.lock:
                    body = json.dumps(state.stats or {
                        "fps": 0.0, "pos": [0, 0, 0], "chunks": 0,
                        "pool_pct": 0.0, "placing": 0,
                        "world_size": 0}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/frame":
                # single frame (tests / curl)
                with state.lock:
                    data, ctype = state.frame, state.ctype
                if data is None:
                    self.send_response(503)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif self.path == "/stream":
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "multipart/x-mixed-replace; boundary=FRAME",
                )
                self.end_headers()
                try:
                    while state.running:
                        with state.lock:
                            data, ctype = state.frame, state.ctype
                        if data is not None:
                            self.wfile.write(
                                b"--FRAME\r\nContent-Type: "
                                + ctype.encode() + b"\r\n\r\n" + data
                                + b"\r\n"
                            )
                        time.sleep(1.0 / state.max_fps)
                except (BrokenPipeError, ConnectionResetError):
                    pass
            else:
                self.send_response(404)
                self.end_headers()

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            try:
                body = json.loads(self.rfile.read(n) or b"{}")
            except ValueError:
                body = {}
            if self.path == "/input":
                with state.lock:
                    state.last_input = time.monotonic()
                    state.keys = {
                        k: bool(v)
                        for k, v in (body.get("keys") or {}).items()
                    }
                    lk = body.get("look") or [0, 0]
                    state.look[0] += float(lk[0])
                    state.look[1] += float(lk[1])
            elif self.path == "/act":
                with state.lock:
                    state.actions.append(body)
            self.send_response(204)
            self.end_headers()

    return Handler


def serve(app, port=8765, max_fps=20.0):
    """Start the pump + HTTP server; returns (server, state). Caller owns
    shutdown: server.shutdown(); state.stop(); app.close()."""
    state = ViewerState(app, max_fps=max_fps)
    state.thread.start()
    httpd = ThreadingHTTPServer(("127.0.0.1", port), make_handler(state))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd, state


def main(argv=None):
    import argparse

    from ..engine import EngineApp
    from ..resources.packs import builtin_respack_path
    from ..utils.log import init_logging

    init_logging()
    ap = argparse.ArgumentParser()
    ap.add_argument("resource_root", nargs="?", default=builtin_respack_path())
    ap.add_argument("--world", default=None)
    ap.add_argument("--port", type=int, default=8765)
    ap.add_argument("--resolution", default="640x360")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    w, h = (int(x) for x in a.resolution.split("x"))

    from ..resources.packs import Resources

    res = Resources.load_from(a.resource_root)
    world = a.world or (res.worlds[0].name if res.worlds else None)
    if world is None:
        print("no worlds found; create one with the terminal client first")
        return 1
    app = EngineApp.host_singleplayer(
        a.resource_root, world, port=61800, resolution=(w, h),
        device=a.device,
    )
    httpd, state = serve(app, port=a.port)
    print(f"viewer at http://127.0.0.1:{a.port}/  (ctrl-c to stop)",
          flush=True)
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        state.stop()
        app.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
