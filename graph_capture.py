"""Capture one call of a launching wrapper into a CUDA graph, replay it once,
and say what the graph holds: its nodes, its edges and how many of them are
programmatic (a kernel launched as its predecessor's programmatic
dependent).  A check for chip_smoke.py and att_stream_bench.py, not part of
the package: the attention's stream must stay the pre-pass's programmatic
dependent inside the fused training chunks' graphs.

    proc = graph_capture.start(out_dir)   # nvcc on graph_capture.cu
    lib = graph_capture.load(proc)
    out, held = graph_capture.captured(lib, attention_kernel, *args)
"""

from __future__ import annotations

import ctypes
import os
import subprocess

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "graph_capture.cu")


def start(out_dir):
    """Start nvcc on graph_capture.cu into out_dir/libgraph_capture.so (a
    plain C file: seconds).  Returns the running process and the library's
    path, for `load`."""
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _build
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "libgraph_capture.so")
    proc = subprocess.Popen(
        [_build.nvcc_path(), "-O2", "-Xcompiler", "-fPIC", "-shared", "-o",
         path, SRC], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    return proc, path


def load(started):
    """Wait for `start`'s nvcc and load the library it built."""
    proc, path = started
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SRC}:\n{log}")
    lib = ctypes.CDLL(path)
    lib.graph_capture_begin.argtypes = [ctypes.c_void_p]
    lib.graph_capture_end.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int)]
    lib.graph_capture_error.argtypes = [ctypes.c_int]
    lib.graph_capture_error.restype = ctypes.c_char_p
    return lib


def _check(lib, code, what):
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} "
                           f"({lib.graph_capture_error(code).decode()})")


def captured(lib, kernel, *args):
    """kernel(*args) -- a launching wrapper, e.g. the package's
    `att_step.attention_kernel` -- captured into a CUDA graph on a side
    stream (relaxed mode, after one call outside the capture that makes the
    side stream's allocations), then the graph launched once.  Returns (the
    call's output, {"nodes", "edges", "programmatic"}: what the graph holds;
    "programmatic" is -1 where the CUDA runtime cannot tell an edge's
    type)."""
    import torch
    side = torch.cuda.Stream()
    counts = (ctypes.c_int * 3)()
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        kernel(*args)
        torch.cuda.synchronize()
        _check(lib, lib.graph_capture_begin(side.cuda_stream), "capture")
        try:
            out = kernel(*args)
        finally:
            code = lib.graph_capture_end(side.cuda_stream, counts)
    _check(lib, code, "captured graph")
    torch.cuda.synchronize()
    return out, dict(zip(("nodes", "edges", "programmatic"), counts))
