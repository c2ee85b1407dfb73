"""Live reconstruction viewer: the reference's pangolin window, headless.

Counterpart of bnv_fusion_tpu/utils/live_viewer.py (stdlib HTTP only; the
preview PNG is written by ``vis.encode_png`` instead of cv2):

* ``/``            auto-refreshing page showing the latest preview render
* ``/preview.png`` latest software-rendered mesh image (``vis``'s z-buffer)
* ``/mesh.ply``    latest mesh, downloadable mid-run
* ``/status.json`` frame counter / vertex count / phase timings

``run_e2e`` with ``model.mode=demo`` publishes every event's mesh when
``trainer.live_viewer_port`` is set.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

_PAGE = b"""<!doctype html>
<html><head><title>bnv_fusion_tpu live</title>
<meta http-equiv="refresh" content="2">
<style>body{background:#111;color:#ddd;font-family:monospace}</style>
</head><body>
<h3>bnv_fusion_tpu &mdash; live reconstruction</h3>
<img src="/preview.png" style="max-width:95vw"/>
<pre id="s"></pre>
<p><a href="/mesh.ply" style="color:#8cf">download current mesh</a></p>
<script>fetch('/status.json').then(r=>r.json()).then(
  j=>{document.getElementById('s').textContent=JSON.stringify(j,null,1)})
</script>
</body></html>"""


class LiveViewer:
    """Publish meshes and preview renders to a background HTTP server;
    ``close`` stops it."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self._lock = threading.Lock()
        self._png: Optional[bytes] = None
        self._ply: Optional[bytes] = None
        self._status = {"frames": 0, "vertices": 0}
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silent
                pass

            def do_GET(self):
                if self.path == "/" or self.path.startswith("/index"):
                    self._send(200, "text/html", _PAGE)
                elif self.path == "/preview.png":
                    with viewer._lock:
                        png = viewer._png
                    if png is None:
                        self._send(404, "text/plain", b"no preview yet")
                    else:
                        self._send(200, "image/png", png)
                elif self.path == "/mesh.ply":
                    with viewer._lock:
                        ply = viewer._ply
                    if ply is None:
                        self._send(404, "text/plain", b"no mesh yet")
                    else:
                        self._send(200, "application/octet-stream", ply)
                elif self.path == "/status.json":
                    with viewer._lock:
                        body = json.dumps(viewer._status).encode()
                    self._send(200, "application/json", body)
                else:
                    self._send(404, "text/plain", b"not found")

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def publish(self, mesh, status: Optional[dict] = None) -> None:
        """Publish a Mesh and, when it has vertices, a fresh preview."""
        from bnv_fusion_tpu_torch import mesh as mesh_mod
        from bnv_fusion_tpu_torch.utils import vis

        buf = io.BytesIO()
        mesh_mod.write_ply(buf, mesh)
        ply = buf.getvalue()
        png = None
        if len(mesh.vertices):
            png = vis.encode_png(np.asarray(vis.render_mesh_preview(mesh)))
        with self._lock:
            self._ply = ply
            if png is not None:
                self._png = png
            st = dict(self._status)
            st["vertices"] = int(len(mesh.vertices))
            if status:
                st.update(status)
            self._status = st

    def close(self):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=10)
