"""Long-lived pose-serving front end over stdio or TCP.

Port of ``mpe3d_tpu/serve.py``.  A client streams wire-format frames (the
reference's recorded-JSON schema, one frame per line) and receives one JSON
result line per frame: poses, stable track ids and the per-pose quality
column.

Protocol: newline-delimited JSON, strictly ordered.

  request line   one wire-format frame dict
                 (``{"camera_id": [skeletons_json, timestamp, ...], ...}``),
                 or a control object ``{"cmd": "ping"|"stats"|"close"}``,
                 or ``{"cmd": "reload", "modelsdir": "..."}`` (hot weight
                 swap from a checkpoint directory, ``reload_from_dir``)
  response line  ``{"seq": n, "n_persons": P, "track_ids": [...],
                 "quality_px": [...], "poses_m": [...], "latency_ms": x}``
                 (track_ids only when tracking is on); a malformed input
                 gets ``{"seq": n, "error": "..."}`` and the server keeps
                 serving.

``latency_ms`` is the stream latency of one frame: from the start of its
line's parse to its formatted response line.

Frames are dispatched ahead through ``PoseEstimationPipeline.submit_fused``
with at most ``depth`` in flight; a collector thread waits on each ticket
in order (``collect_fused``), gates and tracks its poses and writes the
line, so the device's work on a frame overlaps the host's parse and format
work on its neighbours.  Control commands drain the window first, so
responses never reorder.  Frame lines go through the port's C++ parser
(``mpe3d_tpu_torch/native``); lines it cannot read (for example skeletons
sent as JSON lists instead of strings) take the python parser, which also
validates and raises on malformed frames.

Micro-batching (``batch_window`` > 1, ``mpe3d_tpu/serve.py:95-103``,
:373-560): consecutive frames gather into one ``submit_batch`` of the
window (padded to it, so one set of plans serves every fill), submitted
when the window fills, when the oldest pending frame has waited
``batch_linger_ms`` (a flusher thread), or before a control command or an
error answer; a batch that fails to submit answers each of its frames with
an error through the FIFO, in order, and a host failure on one frame of a
collected batch answers that frame alone.  A rig with one matching camera
cannot run the pair decode: each frame goes through the pipeline's staged
``__call__`` (``single_camera_bypass``) synchronously.
"""

from __future__ import annotations

import json
import os
import queue
import socketserver
import sys
import threading
import time
from typing import Optional

import numpy as np

from mpe3d_tpu_torch import native
from mpe3d_tpu_torch.data import frames as frames_mod

# consecutive frame lines the C++ parser fails to read before a stream
# stops trying it (a client whose encoding it cannot read pays no failed
# scan a frame)
NATIVE_MISS_LIMIT = 3


def quality_keep_mask(quality, gate: float):
    """Which poses survive a quality gate: residual within ``gate`` px, or
    -1 (no observation to judge by: kept)."""
    return (quality < 0) | (quality <= gate)


def gate_and_track(poses, quality, gate=None, tracker=None, persons=None):
    """The output epilogue of every serving surface (``PoseServer``, the
    CLI's ``infer``): drop poses whose quality exceeds ``gate`` before
    tracking, so ghosts never open tracks, then update the tracker.

    Returns ``(poses, quality, persons, track_ids, n_dropped)``; quality,
    persons and track_ids are None when not given or not enabled.  The
    quality describes the raw pose; with tracker smoothing the returned
    poses are EMA-blended."""
    poses = np.asarray(poses)
    dropped = 0
    if gate is not None and quality is not None:
        quality = np.asarray(quality)
        keep = quality_keep_mask(quality, gate)
        if not keep.all():
            dropped = int((~keep).sum())
            poses, quality = poses[keep], quality[keep]
            if persons is not None:
                persons = np.asarray(persons)[keep]
    ids = None
    if tracker is not None:
        ids, poses = tracker.update(poses)
    return poses, quality, persons, ids, dropped


class PoseServer:
    """Drive a :class:`~mpe3d_tpu_torch.pipeline.PoseEstimationPipeline`
    over a line-oriented stream.

    ``depth`` is the in-flight window (1 = synchronous).  ``tracker`` is a
    :class:`~mpe3d_tpu_torch.tracking.PoseTracker` shared by every stream;
    ``tracker_factory`` makes a fresh one for each stream (each TCP
    connection is its own camera feed).  ``quality_gate`` (px) drops poses
    whose quality exceeds it, before tracking.  ``batch_window`` > 1
    gathers up to that many frames into one ``submit_batch``; a partial
    window is submitted after ``batch_linger_ms`` (at least 1 ms: the
    flusher wakes at half of it), the latency the batcher may add."""

    def __init__(self, pipe, rig_config, max_skeletons: int = 10,
                 depth: int = 3, tracker=None, tracker_factory=None,
                 quality_gate: Optional[float] = None,
                 batch_window: int = 1, batch_linger_ms: float = 5.0):
        self.pipe = pipe
        self.rig_config = rig_config
        self.max_skeletons = max_skeletons
        self.depth = max(1, int(depth))
        self.tracker = tracker
        self.tracker_factory = tracker_factory
        self.quality_gate = quality_gate
        self.batch_window = max(1, int(batch_window))
        self.batch_linger_ms = max(1.0, float(batch_linger_ms))
        # one matching camera: the staged path's bypass, synchronously
        self._bypass = len(pipe.match_idx) <= 1
        self.frames_served = 0
        self.errors = 0
        self.dropped_low_quality = 0
        self._latency_sum_ms = 0.0
        # frame lines parsed by the C++ parser and by the python path
        self.parsed = {"native": 0, "python": 0}
        # the miss counter of direct _parse_line callers; handle_stream
        # keeps one a stream, so one client's encoding never turns the
        # fast path off for another
        self._native_misses = {"n": 0}
        # counters are bumped from the reader and the collector threads
        self._stats_lock = threading.Lock()
        self._reload_lock = threading.Lock()

    # ------------------------------------------------------------------
    def _bump(self, counter: str) -> None:
        with self._stats_lock:
            setattr(self, counter, getattr(self, counter) + 1)

    def _parsed_by(self, path: str) -> None:
        with self._stats_lock:
            self.parsed[path] += 1

    def _parse_line(self, line: str, misses=None):
        """One wire line -> FrameArrays: the C++ parser on the raw bytes,
        or, where it is unavailable, cannot read the line, or has missed
        ``NATIVE_MISS_LIMIT`` lines in a row on this stream, the python
        parser, which raises on malformed frames.  ``misses`` is the
        stream's miss counter ({"n": int})."""
        if misses is None:
            misses = self._native_misses
        if (line.startswith("{") and misses["n"] < NATIVE_MISS_LIMIT
                and native.load_library() is not None):
            rc, S = self.rig_config, self.max_skeletons
            out = native.parse_frames_native(("[" + line + "]").encode(),
                                             rc.camera_names, S, rc.n_joints)
            if out is not None and len(out[0]) == 1:
                misses["n"] = 0
                self._parsed_by("native")
                return frames_mod.FrameArrays(*(a[0] for a in out))
            misses["n"] += 1
        obj = json.loads(line)
        if not isinstance(obj, dict):
            raise ValueError("frame must be a JSON object")
        fa = frames_mod.parse_frame(obj, self.rig_config, self.max_skeletons)
        self._parsed_by("python")
        return fa

    def _parse(self, frame, misses=None):
        """``frame``: a raw wire line (str) or an already-parsed dict."""
        if isinstance(frame, str):
            return self._parse_line(frame, misses)
        fa = frames_mod.parse_frame(frame, self.rig_config,
                                    self.max_skeletons)
        self._parsed_by("python")
        return fa

    def _submit(self, frame, misses=None):
        t0 = time.perf_counter()
        fa = self._parse(frame, misses)
        if self._bypass:
            return t0, self.pipe(fa)
        return t0, self.pipe.submit_fused(fa)

    def _collect(self, seq: int, t0: float, ticket, tracker=None):
        out = ticket if self._bypass else self.pipe.collect_fused(ticket)
        return self._finish(seq, t0, out, tracker)

    def _new_stream_tracker(self):
        if self.tracker_factory is not None:
            return self.tracker_factory()
        return self.tracker

    def _finish(self, seq: int, t0: float, out, tracker=None):
        """The response of one collected frame: a preformatted line (the
        C++ formatter) or, where it declines, a dict for ``json.dumps``."""
        poses, quality, _, ids, dropped = gate_and_track(
            out.poses, out.quality, gate=self.quality_gate,
            tracker=tracker)
        lat = (time.perf_counter() - t0) * 1e3
        with self._stats_lock:
            self.dropped_low_quality += dropped
            self.frames_served += 1
            self._latency_sum_ms += lat
        line = native.format_result_native(seq, poses, quality=quality,
                                           track_ids=ids, dropped=dropped,
                                           latency_ms=lat)
        if line is not None:
            return line
        rec = {"seq": seq}
        if dropped:
            rec["dropped_low_quality"] = dropped
        rec["n_persons"] = int(len(poses))
        if ids is not None:
            rec["track_ids"] = ids.tolist()
        if quality is not None:
            rec["quality_px"] = quality.round(2).tolist()
        rec["poses_m"] = poses.round(4).tolist()
        rec["latency_ms"] = round(lat, 3)
        return rec

    def reload_from_dir(self, modelsdir) -> dict:
        """Hot-swap the pipeline's weights from a checkpoint directory
        (``{"cmd": "reload", "modelsdir": "..."}``): read whichever of
        ``skeleton_matching`` / ``pose_estimator`` it holds and hand the
        trees to :meth:`PoseEstimationPipeline.reload_weights`.  The
        checkpoints' architectures and the lifter's packing prior must be
        the serving pipeline's.  Raises on any problem without touching the
        serving weights.

        Trust model: the client names a path the server process can read,
        as on the command line; the server binds localhost by default."""
        from mpe3d_tpu_torch.checkpoint import (checkpoint_exists,
                                                load_lifter_checkpoint,
                                                load_matcher_checkpoint)

        if not modelsdir or not isinstance(modelsdir, str):
            raise ValueError("reload needs a 'modelsdir' string")
        if not os.path.isdir(modelsdir):
            raise ValueError(f"no such directory: {modelsdir}")
        mstem = os.path.join(modelsdir, "skeleton_matching")
        lstem = os.path.join(modelsdir, "pose_estimator")
        mtree = ltree = None
        if checkpoint_exists(mstem):
            mtree, mcfg = load_matcher_checkpoint(mstem,
                                                  self.pipe.matcher.cfg)
            if mcfg != self.pipe.matcher.cfg:
                raise ValueError(
                    f"matcher checkpoint architecture {mcfg} does not "
                    f"match the serving pipeline's {self.pipe.matcher.cfg} "
                    f"(restart the server on the new modelsdir instead)")
        if checkpoint_exists(lstem):
            ltree, lcfg, prior = load_lifter_checkpoint(lstem,
                                                        self.pipe.lifter.cfg)
            if lcfg != self.pipe.lifter.cfg:
                raise ValueError(
                    f"lifter checkpoint architecture {lcfg} does not match "
                    f"the serving pipeline's {self.pipe.lifter.cfg} "
                    f"(restart the server on the new modelsdir instead)")
            if prior != self.pipe.lifter_prior:
                raise ValueError(
                    f"checkpoint prior={prior!r} does not match the serving "
                    f"pipeline's lifter_prior={self.pipe.lifter_prior!r} "
                    f"(restart with the matching --prior; the prior variant "
                    f"is part of the checkpoint contract)")
        if mtree is None and ltree is None:
            raise ValueError(f"no skeleton_matching/pose_estimator "
                             f"checkpoint under {modelsdir}")
        with self._reload_lock:
            self.pipe.reload_weights(matcher_tree=mtree, lifter_tree=ltree)
        return {"modelsdir": modelsdir, "matcher": mtree is not None,
                "lifter": ltree is not None}

    def _stats(self) -> dict:
        with self._stats_lock:
            n = max(self.frames_served, 1)
            rec = {"frames": self.frames_served, "errors": self.errors,
                   "mean_latency_ms": round(self._latency_sum_ms / n, 3),
                   "depth": self.depth,
                   "tracking": (self.tracker is not None
                                or self.tracker_factory is not None)}
            if self.batch_window > 1:
                rec["batch_window"] = self.batch_window
            if self.quality_gate is not None:
                rec["quality_gate_px"] = self.quality_gate
                rec["dropped_low_quality"] = self.dropped_low_quality
        return rec

    # ------------------------------------------------------------------
    def handle_stream(self, lines, write) -> None:
        """Serve newline-delimited JSON: ``lines`` is an iterable of input
        lines, ``write`` a callable taking one output line (newline
        included).  Returns when the input ends or a ``close`` command
        arrives.

        A collector thread writes each frame's response as soon as it is
        ready, so a synchronous client gets its answer while the reader
        waits on its next line; ``depth`` bounds the frames in flight (a
        full window blocks the reader).  Order is strict: the collector
        drains a FIFO, and control and error responses follow a drain."""
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        wlock = threading.Lock()
        dead = threading.Event()       # the client's write side is gone
        seq = 0
        tracker = self._new_stream_tracker()
        misses = {"n": 0}

        def emit(rec):
            if dead.is_set():
                return
            try:
                with wlock:
                    write(rec if isinstance(rec, str)
                          else json.dumps(rec) + "\n")
            except Exception:
                # the client disconnected (BrokenPipe on TCP, a closed
                # stdout): the collector must live on, or the final drain
                # would wait forever on frames it never marks done
                dead.set()

        def collect_batch(items, ticket):
            """Answer a batch's frames: an error for each when the batch
            fails, else each frame's record (a host failure of one frame
            answers that frame alone)."""
            try:
                outs = self.pipe.collect_batch(ticket)
            except Exception as e:
                self._bump("errors")
                for s, _, _ in items:
                    emit({"seq": s, "error": f"{type(e).__name__}: {e}"})
                return
            for (s, t0, _), out in zip(items, outs):
                try:
                    emit(self._finish(s, t0, out, tracker))
                except Exception as e:
                    self._bump("errors")
                    emit({"seq": s, "error": f"{type(e).__name__}: {e}"})

        def collector():
            while True:
                item = q.get()
                try:
                    if item is None:
                        return
                    if item[0] == "batch_error":
                        # a batch that failed to submit: its error lines
                        # ride the FIFO behind the batches before it
                        self._bump("errors")
                        for s, _, _ in item[1]:
                            emit({"seq": s, "error": item[2]})
                        continue
                    if item[0] == "batch":
                        collect_batch(item[1], item[2])
                        continue
                    s, t0, ticket = item
                    try:
                        emit(self._collect(s, t0, ticket, tracker))
                    except Exception as e:   # device or host failure of
                        self._bump("errors")  # one frame: report it
                        emit({"seq": s, "error": f"{type(e).__name__}: {e}"})
                finally:
                    q.task_done()

        thread = threading.Thread(target=collector, daemon=True)
        thread.start()

        # the micro-batcher: frames waiting for a batch, oldest first
        batching = self.batch_window > 1 and not self._bypass
        pending: list = []            # [(seq, t0, FrameArrays)]
        plock = threading.Lock()
        stop_flush = threading.Event()

        def flush_pending(min_age_s: Optional[float] = None) -> None:
            """Submit the pending frames as one batch padded to the
            window (only if the oldest has waited ``min_age_s``).  The
            queue put stays under the lock, so batches enter the FIFO in
            seq order."""
            with plock:
                if not pending or (min_age_s is not None
                                   and time.perf_counter() - pending[0][1]
                                   < min_age_s):
                    return
                items = pending[:]
                pending.clear()
                try:
                    ticket = self.pipe.submit_batch(
                        [fa for _, _, fa in items], pad_to=self.batch_window)
                except Exception as e:
                    q.put(("batch_error", items, f"{type(e).__name__}: {e}"))
                    return
                q.put(("batch", items, ticket))

        def flusher() -> None:
            while not stop_flush.wait(self.batch_linger_ms / 2e3):
                flush_pending(min_age_s=self.batch_linger_ms / 1e3)

        flush_thread = None
        if batching:
            flush_thread = threading.Thread(target=flusher, daemon=True,
                                            name="mpe3d-batch-flusher")
            flush_thread.start()

        def drain() -> None:
            """Every frame before this point answered."""
            if batching:
                flush_pending()
            q.join()

        def submit(frame) -> None:
            """Parse and submit one frame (or add it to the pending
            batch), or answer its error."""
            nonlocal seq
            try:
                if batching:
                    t0 = time.perf_counter()
                    fa = self._parse(frame, misses)
                else:
                    ticket = self._submit(frame, misses)
            except Exception as e:   # malformed frame payloads
                drain()
                self._bump("errors")
                emit({"seq": seq, "error": f"{type(e).__name__}: {e}"})
            else:
                if batching:
                    with plock:
                        pending.append((seq, t0, fa))
                        full = len(pending) >= self.batch_window
                    if full:
                        flush_pending()
                else:
                    q.put((seq, *ticket))   # blocks while the window is full
            seq += 1

        try:
            for line in lines:
                if dead.is_set():
                    break
                line = line.strip()
                if not line:
                    continue
                # frame lines skip json.loads (the C++ parser reads the raw
                # bytes); a line with '"cmd"' anywhere may be a control
                # object (member order is not significant) and takes the
                # python parse; a frame that merely contains the substring
                # is still served below
                if line.startswith("{") and '"cmd"' not in line:
                    submit(line)
                    continue
                try:
                    obj = json.loads(line)
                except (ValueError, RecursionError) as e:
                    # RecursionError: hostile deep nesting; answer and go on
                    drain()
                    self._bump("errors")
                    emit({"seq": seq, "error": f"bad json: {e}"})
                    seq += 1
                    continue
                if isinstance(obj, dict) and "cmd" in obj:
                    drain()   # strict ordering around control responses
                    cmd = obj["cmd"]
                    if cmd == "ping":
                        emit({"pong": True})
                    elif cmd == "stats":
                        emit(self._stats())
                    elif cmd == "close":
                        emit({"closed": True, **self._stats()})
                        return
                    elif cmd == "reload":
                        # the drain above makes the reload an ordering
                        # barrier of this stream: earlier frames answered
                        # with the old weights, later ones with the new
                        try:
                            info = self.reload_from_dir(obj.get("modelsdir"))
                            emit({"reloaded": True, **info})
                        except Exception as e:
                            self._bump("errors")
                            emit({"error": f"reload failed: "
                                  f"{type(e).__name__}: {e}"})
                    else:
                        self._bump("errors")
                        emit({"error": f"unknown cmd: {cmd}"})
                    continue
                if isinstance(obj, dict):
                    submit(obj)
                    continue
                drain()
                self._bump("errors")
                emit({"seq": seq, "error": "frame must be a JSON object"})
                seq += 1
        finally:
            drain()
            stop_flush.set()
            # a flush still running finishes its submit_batch and puts its
            # ticket before the collector's stop mark; an unjoined flusher
            # could be inside submit_batch while the interpreter shuts down
            if flush_thread is not None:
                flush_thread.join()
            q.put(None)
            thread.join(timeout=30)

    def serve_stdio(self) -> None:
        """Serve stdin -> stdout (one process a client)."""
        out = sys.stdout

        def write(s):
            out.write(s)
            out.flush()

        self.handle_stream(sys.stdin, write)


# ---------------------------------------------------------------------------
# TCP front end
# ---------------------------------------------------------------------------


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        server: PoseServer = self.server.pose_server  # type: ignore
        slots = getattr(self.server, "client_slots", None)

        def write(s: str):
            self.wfile.write(s.encode())
            self.wfile.flush()

        # errors="replace": a mis-encoded line becomes a malformed-JSON
        # error response instead of closing the connection unanswered
        lines = (raw.decode(errors="replace") for raw in self.rfile)
        if slots is None:
            server.handle_stream(lines, write)
            return
        with slots:
            server.handle_stream(lines, write)


class PoseTCPServer(socketserver.TCPServer):
    """One connection at a time.  Each stream's track state is its own
    (``handle_stream`` builds it per connection, given a
    ``tracker_factory``)."""

    allow_reuse_address = True

    def __init__(self, pose_server: PoseServer, host: str = "127.0.0.1",
                 port: int = 0):
        super().__init__((host, port), _Handler)
        self.pose_server = pose_server

    @property
    def port(self) -> int:
        return self.server_address[1]


class PoseThreadingTCPServer(socketserver.ThreadingMixIn, PoseTCPServer):
    """Concurrent clients: one handler thread a connection, each with its
    own seq counter, window of ``depth`` and tracker (given a
    ``tracker_factory``).  Their submits share the pipeline, which
    serialises them (``PoseEstimationPipeline.submit_fused``); each ticket
    owns its download buffer.  ``max_clients`` bounds the connections
    served at once; more wait in accept order."""

    daemon_threads = True

    def __init__(self, pose_server: PoseServer, host: str = "127.0.0.1",
                 port: int = 0, max_clients: int = 4):
        super().__init__(pose_server, host, port)
        self.client_slots = threading.BoundedSemaphore(max(1, max_clients))


def serve_tcp(pose_server: PoseServer, host: str = "127.0.0.1",
              port: int = 0, ready: Optional[list] = None,
              max_clients: int = 1) -> None:
    """Blocking TCP serve loop.  ``ready`` (if given) receives the bound
    server before it accepts, for its ephemeral port and ``shutdown()``.
    ``max_clients > 1`` serves that many connections at once."""
    if max_clients <= 1:
        srv = PoseTCPServer(pose_server, host, port)
    else:
        srv = PoseThreadingTCPServer(pose_server, host, port,
                                     max_clients=max_clients)
    with srv:
        if ready is not None:
            ready.append(srv)
        print(f"[mpe3d_torch] serving on {host}:{srv.port}", file=sys.stderr)
        srv.serve_forever(poll_interval=0.1)
