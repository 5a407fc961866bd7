"""Zero-dependency HTTP viewer for trained scenes: port of
``das3r_tpu/gui/server.py``, the browser-based stand-in for the
reference's desktop GUI (train_gui.py:57-465, dearpygui) and its socket
viewer (gaussian_renderer/network_gui.py): drag to orbit, wheel to dolly,
panel switcher for RGB / staticness / trajectory.

    python -m das3r_tpu_torch.gui.server -m <model_dir> --iteration 4000 \
        [--device cpu]

Renders run on the card unless ``--device`` names another device; one
render lock serializes requests — the device is a serial resource
exactly like the reference's single CUDA stream.
"""
from __future__ import annotations

import io
import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from das3r_tpu_torch.gui.viewer import PANEL_MODES, ViewerScene

_PAGE = """<!doctype html>
<html><head><title>DAS3R-TPU viewer</title><style>
 body { background:#161616; color:#ddd; font-family:sans-serif;
        display:flex; flex-direction:column; align-items:center }
 #view { border:1px solid #444; cursor:grab; touch-action:none }
 #bar  { margin:8px } button { margin:0 4px }
</style></head><body>
<div id="bar">
  <button data-m="rgb">RGB</button>
  <button data-m="confidence">staticness</button>
  <button data-m="no_soft">no-conf</button>
  <button data-m="traj">trajectory</button>
  <span id="stat"></span>
</div>
<img id="view" draggable="false">
<script>
let yaw=0, pitch=0, radius=null, mode="rgb", busy=false, queued=false;
const img=document.getElementById("view"),
      stat=document.getElementById("stat");
function refresh(){
  if(busy){queued=true;return} busy=true;
  const t0=performance.now();
  let u = mode==="traj" ? "/traj" :
    `/render?mode=${mode}&yaw=${yaw}&pitch=${pitch}`+
    (radius!==null?`&radius=${radius}`:"");
  fetch(u).then(r=>r.blob()).then(b=>{
    img.src=URL.createObjectURL(b);
    stat.textContent=` ${(performance.now()-t0).toFixed(0)} ms`;
    busy=false; if(queued){queued=false; refresh();}
  });
}
let drag=null;
img.addEventListener("pointerdown",e=>{drag=[e.clientX,e.clientY];});
window.addEventListener("pointerup",()=>{drag=null;});
window.addEventListener("pointermove",e=>{
  if(!drag) return;
  yaw+=(e.clientX-drag[0])*1.0; pitch+=(e.clientY-drag[1])*1.0;
  drag=[e.clientX,e.clientY]; refresh();
});
img.addEventListener("wheel",e=>{
  e.preventDefault();
  fetch(`/state`).then(r=>r.json()).then(s=>{
    radius=(radius===null?s.radius:radius)*(e.deltaY>0?1.1:0.9);
    refresh();
  });
});
for(const b of document.querySelectorAll("button"))
  b.onclick=()=>{mode=b.dataset.m; refresh();};
refresh();
</script></body></html>"""


class ViewerApp:
    """Holds the scene + one orbit camera; thread-safe render entry."""

    def __init__(self, scene: ViewerScene):
        self.scene = scene
        self.orbit = scene.default_orbit()
        self._lock = threading.Lock()

    def render_png(self, mode: str, yaw=None, pitch=None,
                   radius=None) -> bytes:
        from PIL import Image
        with self._lock:
            if yaw is not None:
                self.orbit.yaw = 0.005 * float(yaw)
            if pitch is not None:
                self.orbit.pitch = float(np.clip(
                    0.005 * float(pitch), -np.pi / 2 + 1e-3,
                    np.pi / 2 - 1e-3))
            if radius is not None:
                self.orbit.radius = max(float(radius), 1e-3)
            arr = self.scene.render_panel(self.orbit, mode)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        return buf.getvalue()

    def traj_png(self) -> bytes:
        from PIL import Image
        buf = io.BytesIO()
        Image.fromarray(self.scene.trajectory_panel()).save(buf,
                                                           format="PNG")
        return buf.getvalue()

    def state(self) -> dict:
        return {"yaw": self.orbit.yaw, "pitch": self.orbit.pitch,
                "radius": self.orbit.radius,
                "center": [float(c) for c in self.orbit.center],
                "modes": list(PANEL_MODES) + ["traj"],
                "n_gaussians": int(self.scene.meta.alive.sum())}


def make_server(app: ViewerApp, host: str = "127.0.0.1", port: int = 0
                ) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            parsed = urllib.parse.urlparse(self.path)
            q = dict(urllib.parse.parse_qsl(parsed.query))
            try:
                if parsed.path == "/":
                    self._send(200, _PAGE.encode(), "text/html")
                elif parsed.path == "/state":
                    self._send(200, json.dumps(app.state()).encode(),
                               "application/json")
                elif parsed.path == "/traj":
                    self._send(200, app.traj_png(), "image/png")
                elif parsed.path == "/render":
                    mode = q.get("mode", "rgb")
                    if mode not in PANEL_MODES:
                        self._send(400, b"bad mode", "text/plain")
                        return
                    png = app.render_png(
                        mode, yaw=q.get("yaw"), pitch=q.get("pitch"),
                        radius=q.get("radius"))
                    self._send(200, png, "image/png")
                else:
                    self._send(404, b"not found", "text/plain")
            except BrokenPipeError:
                pass
            except Exception as e:   # surface render errors to the client
                self._send(500, f"{type(e).__name__}: {e}".encode(),
                           "text/plain")

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-m", "--model_path", required=True)
    ap.add_argument("--iteration", type=int, required=True)
    ap.add_argument("--port", type=int, default=8008)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--height", type=int, default=320)
    ap.add_argument("--sh_degree", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (fails without it)")
    args = ap.parse_args(argv)

    scene = ViewerScene.from_model_dir(
        args.model_path, args.iteration, sh_degree=args.sh_degree,
        resolution=(args.width, args.height), device=args.device)
    app = ViewerApp(scene)
    srv = make_server(app, args.host, args.port)
    print(f"viewer on http://{args.host}:{srv.server_address[1]}/ "
          f"({app.state()['n_gaussians']} Gaussians)", flush=True)
    srv.serve_forever()


if __name__ == "__main__":
    main()
