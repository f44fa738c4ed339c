"""Tracing and profiling (counterpart of the JAX package's
utils/profiling.py): `torch.profiler` traces of the host and the card, a
step timer that synchronizes the device, named trace regions, and an
on-demand capture endpoint (`start_server`)."""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch


def sync(tree):
    """Hard device sync: wait for the device of the tree's last tensor
    (a device executes its stream in order)."""
    last = None
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, torch.Tensor):
            last = x
    if last is not None and last.is_cuda:
        torch.cuda.synchronize(last.device)
    return tree


class StepTimer:
    """Rolling per-step wall-clock stats (ref prints time/batch per
    iteration)."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times = []
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)
        if len(self.times) > self.window:
            self.times.pop(0)

    @property
    def mean(self):
        return float(np.mean(self.times)) if self.times else 0.0

    @property
    def p50(self):
        return float(np.median(self.times)) if self.times else 0.0


def activities():
    """What a trace records: the host, and the card when there is one."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def all_threads_config():
    """The profiler option that records the operations of every host
    thread, not only of the thread that starts the profiler; None where
    this torch has no such option (`profile_all_threads`)."""
    try:
        return torch.profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


class Trace:
    """A `torch.profiler` trace of the host and the card, written into
    `log_dir` as a Chrome trace (`path`) when it stops.  With `all_threads`
    the host operations of every thread are recorded (`all_threads_config`;
    `self.all_threads` says whether this torch could); else those of the
    thread that starts it.  The card's kernels are recorded whichever
    thread launched them."""

    def __init__(self, log_dir: str, all_threads: bool = False):
        self.log_dir = log_dir
        self.path = os.path.join(log_dir,
                                 f"trace_{time.strftime('%Y%m%d_%H%M%S')}_"
                                 f"{os.getpid()}_{time.monotonic_ns()}.json")
        config = all_threads_config() if all_threads else None
        self.all_threads = config is not None
        self.prof = torch.profiler.profile(activities=activities(),
                                           experimental_config=config)

    def start(self):
        self.prof.start()
        return self

    def stop(self) -> str:
        self.prof.stop()
        os.makedirs(self.log_dir, exist_ok=True)
        self.prof.export_chrome_trace(self.path)
        return self.path


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace of the host and the card into `log_dir`."""
    t = Trace(log_dir).start()
    try:
        yield t
    finally:
        t.stop()


class ProfilerServer:
    """An on-demand capture endpoint (the counterpart of
    `jax.profiler.start_server`): HTTP on 127.0.0.1:`port`, served by a
    daemon thread while the program's own threads keep running.

    GET /capture?duration_ms=N&log_dir=DIR records a `Trace` of the host's
    threads and the card for N ms, writes it into DIR and answers
    {"path": ..., "all_threads": ..., "duration_ms": ...}; 409 while
    another capture runs, 400 for a malformed request, 500 (with the
    error) where the profiler fails.  `stop()` ends the server."""

    def __init__(self, port: int = 9999):
        self._busy = threading.Lock()
        server = self

        class Handler(BaseHTTPRequestHandler):
            def _send(self, code, payload):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet by default
                pass

            def do_GET(self):
                url = urlparse(self.path)
                if url.path != "/capture":
                    return self._send(404, {"error": "not found"})
                query = parse_qs(url.query)
                try:
                    duration_ms = float(query["duration_ms"][0])
                    log_dir = query["log_dir"][0]
                except (KeyError, ValueError) as e:
                    return self._send(400, {"error": f"bad request: {e!r}"})
                if not server._busy.acquire(blocking=False):
                    return self._send(409, {"error": "a capture is running"})
                try:
                    self._send(200, server.capture(duration_ms, log_dir))
                except Exception as e:  # the server keeps serving
                    self._send(500, {"error": repr(e),
                                     "traceback": traceback.format_exc()})
                finally:
                    server._busy.release()

        self.httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       name="profiler-server", daemon=True)
        self.thread.start()

    @staticmethod
    def capture(duration_ms: float, log_dir: str) -> dict:
        t = Trace(log_dir, all_threads=True).start()
        try:
            time.sleep(max(duration_ms, 0.0) / 1e3)
        finally:
            path = t.stop()
        return {"path": path, "all_threads": t.all_threads,
                "duration_ms": duration_ms}

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join()


def start_server(port: int = 9999) -> ProfilerServer:
    """Start the on-demand capture endpoint on `port` (0: any free port,
    then `.port`); returns the server, whose `stop()` ends it."""
    return ProfilerServer(port)


def annotate(name: str):
    """Named region for traces (a `record_function` range)."""
    return torch.profiler.record_function(name)
