"""Live progressive-render viewer — the Qt window's watching role
(counterpart of ``rayito_tpu/utils/viewer.py``, which imports no JAX; this
copy reads the port's ``utils/image``).

A stdlib-only HTTP server serves the CURRENT progressive accumulation
(render/progressive.py ``on_preview`` feed) as an auto-refreshing page:

    python -m rayito_tpu_torch.cli --scene stage6 ... --view 8652
    ->  http://localhost:8652/        (auto-refreshing page)
        http://localhost:8652/frame.png   (latest tone-mapped frame)
        http://localhost:8652/stats.json  (progress numbers)

No external image library: frames are encoded as valid RGB8 PNGs with
zlib + struct (stdlib). The server runs in a daemon thread and costs the
render loop only one tone-map + PNG deflate per sample chunk.
"""

from __future__ import annotations

import json
import queue
import struct
import threading
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def encode_png(rgb8: np.ndarray) -> bytes:
    """Minimal RGB8 PNG encoder (stdlib only). rgb8: [H, W, 3] uint8."""
    h, w, _ = rgb8.shape

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload))
            + tag
            + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    # filter byte 0 (None) per scanline
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), rgb8.reshape(h, w * 3)], axis=1
    ).tobytes()
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


_PAGE = """<!doctype html>
<html><head><title>rayito_tpu_torch live render</title>
<style>body{background:#111;color:#ddd;font-family:monospace;text-align:center}
img{image-rendering:pixelated;max-width:95vw;border:1px solid #444}
#k label{display:inline-block;margin:2px 6px;font-size:12px}
#k input{width:5em;background:#222;color:#ddd;border:1px solid #555}
#k button{margin:4px;padding:2px 14px}</style>
</head><body>
<h3>rayito_tpu_torch progressive render</h3>
<img id="f" src="/frame.png"><p id="s"></p>
<div id="k"></div>
<script>
setInterval(async () => {
  document.getElementById('f').src = '/frame.png?' + Date.now();
  try {
    const st = await (await fetch('/stats.json')).json();
    document.getElementById('s').textContent =
      `samples ${st.samples_done}/${st.samples_total}  ` +
      `${st.seconds.toFixed(1)}s  ${st.mrays_per_sec.toFixed(2)} Mrays/s` +
      (st.state ? `  [${st.state}]` : '');
  } catch (e) {}
}, 1000);
// interactive knobs (the Qt spinboxes): present only when the server was
// started with a knob set (cli --interactive)
(async () => {
  const r = await fetch('/knobs.json');
  if (!r.ok) return;
  const knobs = await r.json();
  const k = document.getElementById('k');
  for (const [name, val] of Object.entries(knobs)) {
    const l = document.createElement('label');
    l.textContent = name + ' ';
    const i = document.createElement('input');
    i.id = 'kn_' + name; i.value = val;
    l.appendChild(i); k.appendChild(l);
  }
  const b = document.createElement('button');
  b.textContent = 'Render';
  b.onclick = async () => {
    const body = {};
    for (const name of Object.keys(knobs))
      body[name] = document.getElementById('kn_' + name).value;
    await fetch('/render', {method: 'POST', body: JSON.stringify(body)});
  };
  k.appendChild(document.createElement('br'));
  k.appendChild(b);
})();
</script></body></html>"""


class LiveViewer:
    """Threaded HTTP preview server. Call :meth:`update` with the current
    mean-radiance image; :meth:`on_preview` plugs straight into
    render_progressive."""

    def __init__(self, port: int = 8652, exposure: float = 0.0,
                 gamma: float = 2.2, host: str | None = None,
                 knobs: dict | None = None):
        # Watch-only servers bind all interfaces (a read-only frame feed,
        # like the Qt window on a shared screen); a KNOB-enabled server
        # also exposes an unauthenticated POST /render that triggers
        # expensive re-renders and rewrites the output file, so it binds
        # loopback unless the caller explicitly opts into a wider host.
        if host is None:
            host = "127.0.0.1" if knobs is not None else "0.0.0.0"
        self._lock = threading.Lock()
        self._png = encode_png(np.zeros((2, 2, 3), np.uint8))
        self._stats = {
            "samples_done": 0, "samples_total": 0, "seconds": 0.0,
            "rays_traced": 0, "mrays_per_sec": 0.0, "state": "rendering",
        }
        self.exposure = exposure
        self.gamma = gamma
        # interactive re-render (the Qt GUI's knob-change loop,
        # MainWindow.cpp:139-236): when a knob dict is supplied, "/" shows
        # editable fields and POST /render enqueues the submitted values;
        # the CLI's interactive loop consumes them via wait_knobs() and
        # re-renders.
        self.knobs = dict(knobs) if knobs is not None else None
        self._knob_queue: queue.Queue = queue.Queue()
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silent server
                pass

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/frame.png":
                    with viewer._lock:
                        body, ctype = viewer._png, "image/png"
                elif path == "/stats.json":
                    with viewer._lock:
                        body = json.dumps(viewer._stats).encode()
                    ctype = "application/json"
                elif path == "/knobs.json":
                    if viewer.knobs is None:
                        self.send_response(404)
                        self.end_headers()
                        return
                    with viewer._lock:
                        body = json.dumps(viewer.knobs).encode()
                    ctype = "application/json"
                elif path == "/":
                    body, ctype = _PAGE.encode(), "text/html"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                if self.path.split("?")[0] != "/render" or viewer.knobs is None:
                    self.send_response(404)
                    self.end_headers()
                    return
                n = int(self.headers.get("Content-Length", "0"))
                try:
                    req = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(req, dict):
                        raise ValueError("knob payload must be an object")
                except ValueError:
                    self.send_response(400)
                    self.end_headers()
                    return
                viewer._knob_queue.put(req)
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        t = threading.Thread(target=self._server.serve_forever, daemon=True)
        t.start()

    def update(self, img: np.ndarray, stats=None) -> None:
        """img: [H, W, 3] float mean radiance (pre-tonemap)."""
        from .image import quantize_ppm, tone_map

        rgb8 = quantize_ppm(tone_map(np.asarray(img), self.exposure,
                                     self.gamma))
        png = encode_png(np.asarray(rgb8, np.uint8))
        with self._lock:
            self._png = png
            if stats is not None:
                self._stats = {
                    "samples_done": stats.samples_done,
                    "samples_total": stats.samples_total,
                    "seconds": stats.seconds,
                    "rays_traced": stats.rays_traced,
                    "mrays_per_sec": stats.mrays_per_sec,
                }

    # signature matches render_progressive's on_preview
    def on_preview(self, img: np.ndarray, stats) -> None:
        self.update(img, stats)

    def set_state(self, state: str) -> None:
        """'rendering' | 'idle' — shown on the page."""
        with self._lock:
            self._stats["state"] = state

    def wait_knobs(self, poll: float = 0.25):
        """Block until the page submits a knob set (POST /render); returns
        the raw {name: string} dict. Polls so Ctrl-C interrupts promptly."""
        while True:
            try:
                req = self._knob_queue.get(timeout=poll)
            except queue.Empty:
                continue
            with self._lock:
                self.knobs.update(
                    {k: v for k, v in req.items() if k in self.knobs}
                )
            return req

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
