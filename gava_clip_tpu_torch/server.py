"""HTTP inference server around serve.VideoClassifier (port of
gava_clip_tpu/server.py; stdlib + numpy + the port's classifier).

A ThreadingHTTPServer front end with cross-request micro-batching:
concurrent requests are coalesced into one fixed-batch device forward, so
concurrency adds one coalescing window to latency, not one forward per
request.

Endpoints:
  GET  /healthz               -> {"status": "ok"}
  GET  /v1/model              -> classifier metadata
  GET  /v1/stats              -> batcher + handler phase counters
  POST /v1/classify_clip      -> body: .npy of (T, S, S, 3) uint8
  POST /v1/classify_clip_raw  -> body: raw C-order uint8 pixels (no header)
  POST /v1/classify_video     -> body: raw video file bytes (any cv2 format)
Responses: JSON {"label": str, "probs": [...]}.

Run: python -m gava_clip_tpu_torch.server --port 8000 [--device cuda]
         [--quantize w8 | --quantize w8a8 --patch_major]
The device defaults to the card; without one the server fails at start-up
(pass --device cpu to serve from the host).
"""

import argparse
import io
import json
import os
import queue
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from .data.video import parse_classes_file


class _Pending:
    __slots__ = ("clip", "event", "result", "error")

    def __init__(self, clip):
        self.clip = clip
        self.event = threading.Event()
        self.result = None
        self.error: Optional[str] = None


class MicroBatcher:
    """Coalesce concurrent classify requests into fixed-batch forwards."""

    def __init__(self, classifier, max_wait_ms: float = 5.0):
        self.clf = classifier
        self.max_wait = max_wait_ms / 1e3
        self.q: "queue.Queue[_Pending]" = queue.Queue()
        # occupancy counters: mean requests per device forward is the whole
        # point of micro-batching. stack_s / infer_s decompose the
        # per-forward host cost: numpy batch assembly vs device transfer +
        # forward + sync
        self.stats = {"batches": 0, "requests": 0,
                      "stack_s": 0.0, "infer_s": 0.0}
        self._stop = threading.Event()
        self.worker = threading.Thread(target=self._loop, daemon=True)
        self.worker.start()

    def _loop(self):
        import time
        while not self._stop.is_set():
            try:
                first = self.q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            # Absolute deadline: the coalescing window is bounded by one
            # max_wait total, not restarted per queued request (a slow
            # trickle must not hold the first request (batch-1)*max_wait).
            deadline = time.monotonic() + self.max_wait
            while len(batch) < self.clf.batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self.q.get(timeout=remaining))
                except queue.Empty:
                    break
            t_st = time.perf_counter()
            clips = np.stack([p.clip for p in batch])
            t_in = time.perf_counter()
            self.stats["batches"] += 1
            self.stats["requests"] += len(batch)
            self.stats["stack_s"] += t_in - t_st
            try:
                probs = self.clf.classify_clips(clips)
                self.stats["infer_s"] += time.perf_counter() - t_in
                for p, pr in zip(batch, probs):
                    p.result = pr
            except Exception as e:  # surface device errors per request
                for p in batch:
                    p.error = str(e)
            for p in batch:
                p.event.set()

    def classify(self, clip: np.ndarray, timeout: float = 30.0) -> np.ndarray:
        pending = _Pending(clip)
        self.q.put(pending)
        if not pending.event.wait(timeout):
            raise TimeoutError("inference timed out")
        if pending.error:
            raise RuntimeError(pending.error)
        return pending.result

    def stop(self):
        self._stop.set()
        self.worker.join(timeout=2)


def make_handler(batcher: MicroBatcher, classifier):
    # handler-side phase accumulators (all handler threads share them; the
    # lock is uncontended relative to MB-scale body reads)
    hstats = {"read_s": 0.0, "parse_s": 0.0, "respond_s": 0.0, "posts": 0}
    hlock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet by default
            pass

        def _json(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                return self._json(200, {"status": "ok"})
            if self.path == "/v1/stats":
                with hlock:
                    h = dict(hstats)
                return self._json(200, {**batcher.stats, **h})
            if self.path == "/v1/model":
                return self._json(200, {
                    "classes": classifier.classnames,
                    "num_frames": classifier.num_frames,
                    "spatial_size": classifier.spatial_size,
                    "batch_size": classifier.batch_size,
                })
            return self._json(404, {"error": "not found"})

        def _read_body(self) -> bytes:
            n = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(n)

        def do_POST(self):
            import time as _time
            try:
                want = (classifier.num_frames, classifier.spatial_size,
                        classifier.spatial_size, 3)
                if self.path == "/v1/classify_clip":
                    t0 = _time.perf_counter()
                    body = self._read_body()
                    t1 = _time.perf_counter()
                    clip = np.load(io.BytesIO(body), allow_pickle=False)
                    t2 = _time.perf_counter()
                    with hlock:
                        hstats["read_s"] += t1 - t0
                        hstats["parse_s"] += t2 - t1
                        hstats["posts"] += 1
                    if clip.shape != want or clip.dtype != np.uint8:
                        return self._json(400, {
                            "error": f"clip must be uint8 {want}, "
                                     f"got {clip.dtype} {clip.shape}"})
                elif self.path == "/v1/classify_clip_raw":
                    # fast path: body IS the C-order uint8 pixel buffer —
                    # no .npy header, no np.load copy (frombuffer is a view;
                    # the batcher's np.stack is the single copy)
                    t0 = _time.perf_counter()
                    body = self._read_body()
                    t1 = _time.perf_counter()
                    n_want = int(np.prod(want))
                    if len(body) != n_want:
                        return self._json(400, {
                            "error": f"raw body must be {n_want} bytes "
                                     f"(uint8 {want}), got {len(body)}"})
                    clip = np.frombuffer(body, np.uint8).reshape(want)
                    with hlock:
                        hstats["read_s"] += t1 - t0
                        hstats["parse_s"] += _time.perf_counter() - t1
                        hstats["posts"] += 1
                elif self.path == "/v1/classify_video":
                    with tempfile.NamedTemporaryFile(suffix=".mp4",
                                                     delete=False) as f:
                        f.write(self._read_body())
                        tmp = f.name
                    try:
                        clip = classifier.prepare_video(tmp)
                    finally:
                        os.unlink(tmp)
                else:
                    return self._json(404, {"error": "not found"})
                probs = batcher.classify(clip)
                label = classifier.classnames[int(np.argmax(probs))]
                t_r = _time.perf_counter()
                r = self._json(200, {"label": label,
                                     "probs": probs.tolist()})
                with hlock:
                    hstats["respond_s"] += _time.perf_counter() - t_r
                return r
            except Exception as e:
                return self._json(500, {"error": str(e)})

    return Handler


def serve(classifier, host: str = "0.0.0.0", port: int = 8000,
          max_wait_ms: float = 5.0) -> ThreadingHTTPServer:
    """Start the server (returns it; call .serve_forever() or use the CLI)."""
    batcher = MicroBatcher(classifier, max_wait_ms=max_wait_ms)
    httpd = ThreadingHTTPServer((host, port),
                                make_handler(batcher, classifier))
    httpd.batcher = batcher
    return httpd


def make_server(argv=None):
    """Parse the flags, build and warm up the classifier, and return the
    (not yet serving) HTTP server."""
    import torch

    from .serve import VideoClassifier
    from .utils.device import resolve_device
    from .utils.flagship import build_zero_shot

    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--classes", default="./classes/k400_classes.txt")
    ap.add_argument("--text_features", default="",
                    help=".npy (n_cls, E) precomputed text features")
    ap.add_argument("--num_frames", type=int, default=8)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--patch_major", action="store_true",
                    help="ship clips as uint8 patch rows with normalization "
                         "folded into the patch-embed weights")
    ap.add_argument("--quantize", default="", choices=["", "w8", "w8a8"],
                    help="w8: weight-only int8 projections; w8a8: int8 "
                         "weights + per-row int8 activations (the "
                         "throughput mode)")
    ap.add_argument("--max_wait_ms", type=float, default=5.0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) fails at start-up without a "
                         "card; 'cpu' serves from the host")
    ap.add_argument("--data_parallel", type=int, default=0,
                    help="shard the serving batch over this many devices "
                         "(cuda:0..N-1; one weight copy each; 0 = one "
                         "device)")
    args = ap.parse_args(argv)

    resolve_device(args.device)         # fail before anything is built
    devices = None
    if args.data_parallel:
        if torch.device(args.device).type == "cuda":
            have = torch.cuda.device_count()
            if args.data_parallel > have:
                raise RuntimeError(f"--data_parallel {args.data_parallel} "
                                   f"needs {args.data_parallel} cards, "
                                   f"{have} visible")
            devices = [f"cuda:{i}" for i in range(args.data_parallel)]
        else:
            devices = [args.device] * args.data_parallel
    _, labels = parse_classes_file(args.classes)
    tf = np.load(args.text_features) if args.text_features else None
    # built on the host; the classifier places the weights on the device
    model = build_zero_shot(num_frames=args.num_frames,
                            num_classes=len(labels), text_features=tf,
                            device="cpu")
    clf = VideoClassifier.from_model(
        model, classnames=labels, batch_size=args.batch_size,
        patch_major=args.patch_major, quantize=args.quantize,
        device=args.device, devices=devices).warmup()
    httpd = serve(clf, args.host, args.port, args.max_wait_ms)
    print(f"serving on {args.host}:{httpd.server_address[1]} "
          f"(batch={args.batch_size}, {args.quantize or 'bf16'}, "
          f"device={args.device})")
    return httpd


def main(argv=None):
    make_server(argv).serve_forever()


if __name__ == "__main__":
    main()
