"""Live 3D viewer: the canvas page over HTTP, poses over Server-Sent Events.

Port of ``mpe3d_tpu/viz/live_viewer.py`` (``LiveViewerServer`` :62) on the
standard library's ``ThreadingHTTPServer``: ``/`` serves the viewer page
of ``viz/html_viewer.py`` with a live-mode script, ``/events`` streams
each pushed frame as one SSE event (the JAX package's bytes for the same
poses).  A new client gets the history first (a bounded ring; a
reconnecting browser sends Last-Event-ID and gets only what it lacks),
then frames as they are pushed.  ``close`` ends every stream and stops the
server.  Usage::

    server = LiveViewerServer(rig_config, camera_centers=..., port=8090)
    for fa in frames:
        out = pipe.infer_fused(fa)
        server.push(out.poses, quality=out.quality)
    server.close()

or ``python -m mpe3d_tpu_torch show-results --testfiles ... --live 8090``.
"""

from __future__ import annotations

import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np

from mpe3d_tpu_torch.config import COCO_BONES, RigConfig
from mpe3d_tpu_torch.viz.html_viewer import (_HEX_COLORS, _frame_payload,
                                       build_viewer_html)
from mpe3d_tpu_torch.viz.viewer import VIEW_LIM, remap_axes

# frames kept for new clients; past it the oldest half is dropped
_MAX_HISTORY = 2000

_LIVE_JS = """
if(D.live){
  let follow=true;
  seek.addEventListener('input',()=>{follow=false;});
  const liveBtn=document.createElement('button');
  liveBtn.textContent='LIVE';liveBtn.style.color='#f66';
  liveBtn.title='follow the newest frame';
  liveBtn.addEventListener('click',()=>{follow=true;
    fi=Math.max(0,D.frames.length-1);draw();});
  document.getElementById('bar').appendChild(liveBtn);
  const es=new EventSource('/events');
  es.onmessage=e=>{D.frames.push(JSON.parse(e.data));
    seek.max=Math.max(0,D.frames.length-1);
    if(follow)fi=D.frames.length-1;
    draw();};
}
"""


class LiveViewerServer:
    """Threaded HTTP server: ``/`` = the canvas viewer, ``/events`` = SSE
    pose stream.  ``push`` is safe from any thread; axis remap
    (rig_config.axes_3d) is applied here like every other renderer."""

    def __init__(self, rig_config: RigConfig,
                 camera_centers: Optional[np.ndarray] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 fps: int = 10, title: str = "mpe3d_tpu live"):
        self._rig_config = rig_config
        self._history: List[tuple] = []     # (event_id, sse_line)
        self._clients: List[queue.Queue] = []
        self._lock = threading.Lock()

        cams = (np.round(remap_axes(np.asarray(camera_centers, np.float64),
                                    rig_config), 3).tolist()
                if camera_centers is not None and len(camera_centers)
                else [])
        payload = {"frames": [], "live": True,
                   "bones": [list(b) for b in COCO_BONES],
                   "colors": _HEX_COLORS, "cams": cams,
                   "lim": VIEW_LIM, "fps": max(1, int(fps)),
                   "axes": [lbl for lbl, _ in rig_config.axes_3d],
                   "title": title}
        self._html = build_viewer_html(payload, title,
                                       live_js=_LIVE_JS).encode()
        self._next_id = 0          # SSE event ids: reconnecting clients
        # send Last-Event-ID and the backlog replay skips what they have

        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):     # quiet: stderr is the CLI's
                pass

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/html; charset=utf-8")
                    self.send_header("Content-Length",
                                     str(len(outer._html)))
                    self.end_headers()
                    self.wfile.write(outer._html)
                    return
                if self.path == "/events":
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.end_headers()
                    # browsers send Last-Event-ID on EventSource
                    # auto-reconnect: replay only what the client lacks
                    # (a full-backlog replay would duplicate the whole
                    # timeline client-side on every transient drop)
                    try:
                        last_id = int(self.headers.get("Last-Event-ID",
                                                       "-1"))
                    except ValueError:
                        last_id = -1
                    # bounded: a stalled client loses frames instead of
                    # growing server memory without limit
                    q: queue.Queue = queue.Queue(maxsize=1024)
                    with outer._lock:
                        backlog = [ln for i, ln in outer._history
                                   if i > last_id]
                        outer._clients.append(q)
                    try:
                        for line in backlog:
                            self.wfile.write(line.encode())
                        self.wfile.flush()
                        while True:
                            try:
                                line = q.get(timeout=15.0)
                            except queue.Empty:
                                line = ": keepalive\n\n"   # SSE comment
                            if line is None:               # close()
                                return
                            self.wfile.write(line.encode())
                            self.wfile.flush()
                    except (BrokenPipeError, ConnectionResetError,
                            OSError):
                        return                             # client gone
                    finally:
                        with outer._lock:
                            if q in outer._clients:
                                outer._clients.remove(q)
                    return
                self.send_response(404)
                self.end_headers()

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name="mpe3d-live-viewer")
        self._thread.start()

    # ------------------------------------------------------------------
    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}/"

    def push(self, poses: np.ndarray, gt: Optional[np.ndarray] = None,
             track_ids: Optional[np.ndarray] = None,
             quality: Optional[np.ndarray] = None) -> None:
        """Queue one frame ([P, J, 3] world metres + optional overlays)
        to every connected client (and the new-client backlog)."""
        disp = (remap_axes(np.asarray(poses, np.float64), self._rig_config)
                if len(poses) else np.zeros((0, 0, 3)))
        g = (remap_axes(np.asarray(gt, np.float64), self._rig_config)
             if gt is not None and len(gt) else None)
        payload = _frame_payload(disp, g, track_ids, quality)
        with self._lock:
            fid = self._next_id
            self._next_id += 1
            line = (f"id: {fid}\ndata: "
                    + json.dumps(payload, separators=(",", ":")) + "\n\n")
            self._history.append((fid, line))
            if len(self._history) > _MAX_HISTORY:
                # keep the newest frames; scrub history shrinks, the
                # stream itself is unaffected
                del self._history[: len(self._history) // 2]
            clients = list(self._clients)
        for q in clients:
            try:
                q.put_nowait(line)
            except queue.Full:
                pass        # stalled client: drop its frame, not memory

    def close(self) -> None:
        with self._lock:
            clients = list(self._clients)
        for q in clients:
            try:
                q.put_nowait(None)
            except queue.Full:
                pass        # handler dies with the server shutdown below
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=10)
