"""HTTP serving of an exported artifact, with micro-batching.

Counterpart of ``pointnet2_tpu/serving.py``: ``ServingModel``, ``_Pending``,
``ServerStats``, ``MicroBatcher``, the handler and ``PredictServer``, with
the same wire format, status codes and padding rule, on the artifacts of
``pointnet2_tpu_torch.export``:

- **Micro-batching.** A batcher thread coalesces concurrent requests (up to
  the artifact's batch, within ``max_delay_ms``), runs them as one device
  batch, and hands each request its rows back.
- **Padding.** A fixed-batch artifact takes its batch only: a short call is
  padded with copies of its first cloud. A symbolic-batch artifact takes any
  batch; the runner pads to the next power of two, up to ``max_batch``, so
  that the launch plans and the allocator see O(log max_batch) shapes.
- **Certificates.** An artifact exported with calibrated windows returns
  ``(labels, ok)``; ``ok`` False means a window left out neighbour
  candidates on that batch, and the request gets a 503 (recalibrate and
  re-export).

Wire format: ``POST /v1/predict`` with JSON ``{"points": [...]}`` (one
``(num_point, point_dim)`` cloud or a ``(b, num_point, point_dim)`` batch)
or a ``.npy`` body (``Content-Type: application/x-npy``, same shapes).
Responses are JSON, or ``.npy`` with ``Accept: application/x-npy``.
``GET /healthz`` gives the manifest, ``GET /stats`` the batching counters.

Five faults of the JAX module are repaired here:

- a POST to an unknown path reads its body before the 404, so the next
  request on a kept-alive connection is parsed from its own bytes;
- when a round of more than one request fails its certificate or raises,
  each request is run again alone before it is failed, so one client's
  cloud does not fail another's;
- a request of zero clouds is a 400, not a 500;
- a request submitted after the batcher stopped fails at once, and a
  handler waits for its request for ``REQUEST_TIMEOUT_S`` at most;
- ``ServingModel.run`` returns each device call's certificate, so
  ``/stats`` counts device calls (``device_batches``) and failed calls
  (``certificate_failures``), not rounds.

Standard library ``http.server`` and ``torch``; no model code is needed,
only the artifact directory and the ``pn2`` operators.
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np
import torch

from pointnet2_tpu_torch.export import load_exported

_NPY = "application/x-npy"
_JSON = "application/json"
# The longest a handler waits for its request's round; past it, a 500.
REQUEST_TIMEOUT_S = 300.0


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class ServingModel:
    """A loaded artifact and the padding and splitting around its batch.

    ``run(points)`` takes any ``(b, num_point, point_dim)`` float32 batch,
    cuts it into calls of at most the artifact's batch (padding each call's
    tail with its first cloud; padded rows are dropped), and returns
    ``(labels (b, num_point) int32, ok, oks)``: ``oks`` holds each device
    call's certificate (True without one), ``ok`` is their AND.
    ``device`` None serves on the artifact's device; another one raises.
    """

    def __init__(self, artifact_dir: str, *, max_batch: int = 64, device: Optional[str] = None):
        fn, manifest = load_exported(artifact_dir)
        if device is not None and torch.device(device).type != manifest["device"]:
            raise ValueError(f"{artifact_dir} was exported for {manifest['device']} and is served there, not {device}")
        self.manifest = manifest
        self.device = torch.device(manifest["device"])
        self.checked = bool(manifest.get("window_certificate"))
        self.num_point = int(manifest["input_shape"][1])
        self.point_dim = int(manifest["input_shape"][2])
        fixed = manifest["input_shape"][0]
        self.fixed_batch: Optional[int] = int(fixed) if fixed else None
        self.max_batch = self.fixed_batch or max_batch
        self._fn = fn
        self._lock = threading.Lock()  # device calls are serialised

    def _call_padded(self, chunk: np.ndarray) -> tuple[np.ndarray, bool]:
        """One device call at an artifact batch covering ``chunk``."""
        b = chunk.shape[0]
        target = self.fixed_batch or min(_next_pow2(b), self.max_batch)
        if b < target:
            pad = np.broadcast_to(chunk[:1], (target - b,) + chunk.shape[1:])
            chunk = np.concatenate([chunk, pad], axis=0)
        out = self._fn(torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device))
        if self.checked:
            labels, ok = out
            return labels[:b].cpu().numpy(), bool(ok)
        return out[:b].cpu().numpy(), True

    def run(self, points: np.ndarray) -> tuple[np.ndarray, bool, List[bool]]:
        points = np.ascontiguousarray(points, dtype=np.float32)
        if points.shape[0] == 0:
            raise ValueError("no clouds to label")
        labels, oks = [], []
        with self._lock:
            for s in range(0, points.shape[0], self.max_batch):
                lab, call_ok = self._call_padded(points[s : s + self.max_batch])
                labels.append(lab)
                oks.append(call_ok)
        return np.concatenate(labels, axis=0), all(oks), oks

    def warmup(self) -> None:
        """One call at the full batch before traffic: the kernels' first
        launches, the launch plans and the allocator."""
        self.run(np.zeros((self.max_batch, self.num_point, self.point_dim), np.float32))


class _Pending:
    """One enqueued request: points in, (labels, ok) or an exception out."""

    __slots__ = ("points", "event", "labels", "ok", "error")

    def __init__(self, points: np.ndarray):
        self.points = points
        self.event = threading.Event()
        self.labels: Optional[np.ndarray] = None
        self.ok = True
        self.error: Optional[BaseException] = None

    def fail(self, error: BaseException) -> None:
        self.error = error
        self.event.set()


@dataclass
class ServerStats:
    requests: int = 0
    clouds: int = 0
    device_batches: int = 0  # device calls, several in a round larger than the batch
    batched_clouds: int = 0  # clouds that shared a round with another request's
    certificate_failures: int = 0  # device calls whose certificate failed
    lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def snapshot(self) -> dict:
        with self.lock:
            return {
                "requests": self.requests,
                "clouds": self.clouds,
                "device_batches": self.device_batches,
                "batched_clouds": self.batched_clouds,
                "certificate_failures": self.certificate_failures,
            }


class MicroBatcher:
    """Coalesce concurrent requests into shared device batches.

    One consumer thread takes a request, then more for up to ``max_delay_ms``
    (or until the batch is full), runs them as one ``ServingModel.run`` and
    hands each its rows. Requests never see each other's data. A round of
    several requests that fails its certificate or raises runs each request
    again alone, and only a request that fails alone is failed.
    """

    def __init__(self, model: ServingModel, stats: ServerStats, max_delay_ms: float = 5.0):
        self.model = model
        self.stats = stats
        self.max_delay = max_delay_ms / 1000.0
        self._q: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self._stop_lock = threading.Lock()  # no request enters the queue behind the stop sentinel
        self._stopped = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, points: np.ndarray) -> _Pending:
        p = _Pending(points)
        with self._stop_lock:
            if self._stopped:
                p.fail(RuntimeError("the server is stopping"))
            else:
                self._q.put(p)
        return p

    def stop(self) -> None:
        with self._stop_lock:
            self._stopped = True
            self._q.put(None)
        self._thread.join(timeout=5)

    def _drain(self, first: _Pending) -> list:
        batch = [first]
        total = first.points.shape[0]
        deadline = time.monotonic() + self.max_delay
        while total < self.model.max_batch:
            try:
                nxt = self._q.get(timeout=max(deadline - time.monotonic(), 0))
            except queue.Empty:
                break
            if nxt is None:
                self._q.put(None)  # the sentinel again, for _loop
                break
            batch.append(nxt)
            total += nxt.points.shape[0]
        return batch

    def _serve(self, batch: list) -> bool:
        """Run ``batch`` as one round and hand each request its rows. Returns
        False, handing nothing, when a round of several requests failed its
        certificate or raised: the caller then runs each request alone."""
        try:
            labels, ok, oks = self.model.run(np.concatenate([p.points for p in batch], axis=0))
        except Exception as e:  # the batcher keeps serving; the error goes to the waiter
            if len(batch) > 1:
                return False
            batch[0].error = e
            return True
        with self.stats.lock:
            self.stats.device_batches += len(oks)
            self.stats.certificate_failures += oks.count(False)
        if not ok and len(batch) > 1:
            return False
        s = 0
        for p in batch:
            n = p.points.shape[0]
            p.labels, p.ok = labels[s : s + n], ok
            s += n
        return True

    def _loop(self) -> None:
        while True:
            first = self._q.get()
            if first is None:  # stop(): every request queued before it has been served
                return
            batch = self._drain(first)
            clouds = sum(p.points.shape[0] for p in batch)
            with self.stats.lock:
                self.stats.clouds += clouds
                if len(batch) > 1:
                    self.stats.batched_clouds += clouds
            try:
                if not self._serve(batch):
                    for p in batch:
                        self._serve([p])
            finally:
                for p in batch:
                    p.event.set()


def _make_handler(model: ServingModel, batcher: MicroBatcher, stats: ServerStats):
    manifest = model.manifest

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet; /stats covers it
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj: dict) -> None:
            self._send(code, json.dumps(obj).encode(), _JSON)

        def _read_body(self) -> bytes:
            return self.rfile.read(int(self.headers.get("Content-Length", 0)))

        def do_GET(self) -> None:
            if self.path == "/healthz":
                self._send_json(200, {"status": "ok", "manifest": manifest})
            elif self.path == "/stats":
                self._send_json(200, stats.snapshot())
            else:
                self._send_json(404, {"error": "not_found"})

        def _parse_points(self, body: bytes) -> np.ndarray:
            ctype = (self.headers.get("Content-Type") or _JSON).split(";")[0]
            if ctype == _NPY:
                pts = np.load(io.BytesIO(body), allow_pickle=False)
            else:
                pts = np.asarray(json.loads(body)["points"], dtype=np.float32)
            if pts.ndim == 2:
                pts = pts[None]
            if pts.ndim != 3 or pts.shape[1:] != (model.num_point, model.point_dim):
                raise ValueError(
                    f"expected (b, {model.num_point}, {model.point_dim}) or "
                    f"({model.num_point}, {model.point_dim}), got {pts.shape}"
                )
            if pts.shape[0] == 0:
                raise ValueError("the request holds no cloud")
            return np.ascontiguousarray(pts, dtype=np.float32)

        def do_POST(self) -> None:
            body = self._read_body()  # read whatever the path: the connection stays in step
            if self.path != "/v1/predict":
                self._send_json(404, {"error": "not_found"})
                return
            try:
                pts = self._parse_points(body)
            except Exception as e:  # outside input: whatever it breaks is the client's 400
                self._send_json(400, {"error": "bad_request", "detail": str(e)})
                return
            with stats.lock:
                stats.requests += 1
            pending = batcher.submit(pts)
            if not pending.event.wait(REQUEST_TIMEOUT_S):
                self._send_json(500, {"error": "inference_timeout", "detail": f"no answer in {REQUEST_TIMEOUT_S} s"})
                return
            if pending.error is not None:
                self._send_json(500, {"error": "inference_failed", "detail": str(pending.error)})
                return
            if not pending.ok:
                # The calibrated window left out neighbour candidates on this
                # request's clouds: the labels may differ from the exact path's.
                self._send_json(
                    503,
                    {
                        "error": "window_certificate_failed",
                        "detail": "a calibrated window dropped neighbour candidates on this request; "
                        "recalibrate (--bq_window/--fp_window auto) and re-export",
                    },
                )
                return
            if _NPY in (self.headers.get("Accept") or ""):
                buf = io.BytesIO()
                np.save(buf, pending.labels)
                self._send(200, buf.getvalue(), _NPY)
            else:
                self._send_json(200, {"labels": pending.labels.tolist()})

    return Handler


class PredictServer:
    """Owns the model, the batcher, the counters and the HTTP server."""

    def __init__(
        self,
        artifact_dir: str,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        max_batch: int = 64,
        max_delay_ms: float = 5.0,
        warmup: bool = True,
        device: Optional[str] = None,
    ):
        self.artifact_dir = artifact_dir
        self.model = ServingModel(artifact_dir, max_batch=max_batch, device=device)
        if warmup:
            self.model.warmup()
        self.stats = ServerStats()
        self.batcher = MicroBatcher(self.model, self.stats, max_delay_ms)
        self.httpd = ThreadingHTTPServer((host, port), _make_handler(self.model, self.batcher, self.stats))
        self.port = self.httpd.server_address[1]

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.stop()
