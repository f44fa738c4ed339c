"""Build the package's CUDA kernels with nvcc and load them with ctypes.

At first use, every `.cu` under the package's `csrc/` is compiled for
Hopper (`sm_90a`; one nvcc process per source, in parallel, then one link)
into `kernels/libcic_kernels.so` under `utils/build_dirs.build_root()` (the
checkout's `build/`, or a per-user cache directory for an installed copy),
and loaded with ctypes.  The sources have a plain C interface and include
no PyTorch header, so no PyTorch build machinery is involved.  A hash of
the sources, the flags and `nvcc --version` is kept beside the library;
the library is rebuilt when it changes.  Only the package's own sources are
used.

Every C entry point launches on the stream it is given, allocates nothing,
and returns `cudaGetLastError()` after its launches; `check` raises on a
non-zero code.  Pointers and the stream pass as `ctypes.c_void_p`: without
declared argtypes ctypes would cut a 64-bit pointer to 32 bits.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

from cooperativeimagecaptioning_tpu_torch.utils import build_dirs

CSRC = build_dirs.PACKAGE / "csrc"
BUILD_DIR = build_dirs.build_root() / "kernels"
LIB_NAME = "libcic_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -Xptxas -v: each kernel's registers, stack and spills go to the compile log
COMPILE_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v"]
LINK_FLAGS = ARCH_FLAGS + ["-shared"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes; every entry returns a cudaError_t as int
SIGNATURES = {
    # h, w_h2att, b_h2att, att_h (f32 [B,A] out), B, H, A, is_bf16, vec, stream
    "cic_att_h": [_P] * 4 + [_I] * 5 + [_P],
    # is_bf16, layout (0 b-major, 1 K-major, 2 int8), vec, slots, stages, K,
    # H, A -> resident blocks an SM (the one entry that returns a count;
    # negative: minus a cudaError_t)
    "cic_attention_blocks_per_sm": [_I] * 8,
    # h, emb, p_att, w_h2att, b_h2att, w_alpha, b_alpha, mask|NULL,
    # att_h (f32 [B,A] scratch), out, B, K, H, A, is_bf16, vec, grid, slots,
    # stages, dependent, stream
    "cic_attention": [_P] * 10 + [_I] * 10 + [_P],
    # as cic_attention, with emb [K,B,H] and p_att [K,B,A]
    "cic_attention_kmajor": [_P] * 10 + [_I] * 10 + [_P],
    # h, emb_q, emb_scale, p_q, p_scale, w_h2att, b_h2att, w_alpha, b_alpha,
    # mask|NULL, att_h, out, B, K, H, A, is_bf16, vec, grid, slots, stages,
    # dependent, stream
    "cic_attention_q": [_P] * 12 + [_I] * 10 + [_P],
    # h, w, b, part_val, part_id, part_m, part_s, it, lp,
    # R, H, V, splits, split_cols, is_bf16, first_pass (0 FMA, 1 wgmma,
    # 2 split TF32), stream
    "cic_greedy_head": [_P] * 9 + [_I] * 7 + [_P],
    # h, w, b, part_val, part_id, part_m, part_s, vals, idx, lse, thr|NULL,
    # R, H, V, kk, kk_slots, splits, split_cols, is_bf16, first_pass, stream
    "cic_beam_head": [_P] * 11 + [_I] * 9 + [_P],
    # h, w, b, part_val, part_id, part_m, part_s, rec (f32 [R, 2kk+1]),
    # thr|NULL, R, H, V, kk, kk_slots, splits, split_cols, is_bf16,
    # first_pass, stream
    "cic_beam_head_records": [_P] * 9 + [_I] * 9 + [_P],
    # xt, h, c, att|NULL, wi, bi, wh, bh, wc|NULL, bc|NULL, h_out, c_out,
    # B, D, H, is_bf16, first_pass (0 FMA, 2 split TF32, 3 wgmma bf16), cols
    # and rows (a block's tile: the split-TF32 kernel's j; the wgmma
    # kernel's j and rows), stream
    "cic_cell": [_P] * 12 + [_I] * 7 + [_P],
    # rec (f32 [n, R, W]), out0, out1|NULL, out2|NULL, R, n, m, v_local,
    # mode (0 beam, 1 greedy, 2 argmax), stream; the floor: an empty kernel
    # on the merge's grid
    "cic_head_merge": [_P] * 4 + [_I] * 5 + [_P],
    "cic_head_merge_floor": [_P] * 4 + [_I] * 5 + [_P],
}

_lock = threading.Lock()
_lib = None


def sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash(compiler: str = "") -> str:
    """Hash of the sources, the flags and `compiler` (nvcc's version)."""
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    h.update(compiler.encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels are built from source at first use")


def kernel_resources(log: str) -> dict:
    """{mangled kernel name: {'registers', 'stack_bytes', 'spill_bytes'}}
    from the output of nvcc -Xptxas -v (spill stores plus spill loads)."""
    out = {}
    pattern = re.compile(
        r"Compiling entry function '(\w+)'.*?(\d+) bytes stack frame, "
        r"(\d+) bytes spill stores, (\d+) bytes spill loads.*?"
        r"Used (\d+) registers", re.S)
    for name, stack, stores, loads, regs in pattern.findall(log):
        out[name] = {"registers": int(regs), "stack_bytes": int(stack),
                     "spill_bytes": int(stores) + int(loads)}
    return out


def serialized_wgmma(log: str) -> list:
    """The kernels whose wgmma instructions ptxas serialized, by mangled
    name, from its C7515 info lines in the output of nvcc -Xptxas -v ("?"
    where a line names no function).  ptxas does so when, for example, an
    instruction other than wgmma writes an accumulator register while
    products are in flight."""
    out = []
    for line in log.splitlines():
        if "C7515" in line:
            m = re.search(r"function '(\w+)'", line)
            out.append(m.group(1) if m else "?")
    return out


def build() -> dict:
    """Compile csrc/*.cu into BUILD_DIR/libcic_kernels.so unless an
    up-to-date build is there.  Returns {'compiled', 'seconds', 'path',
    'resources', 'serialized'}: `kernel_resources` and `serialized_wgmma`
    of the compile logs (empty when nothing was compiled)."""
    nvcc = nvcc_path()
    lib_path = BUILD_DIR / LIB_NAME
    hash_path = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = source_hash(subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True,
        check=True).stdout)
    if (lib_path.is_file() and hash_path.is_file()
            and hash_path.read_text().strip() == digest):
        return {"compiled": False, "seconds": 0.0, "path": str(lib_path),
                "resources": {}, "serialized": []}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    base = [nvcc, *COMPILE_FLAGS, f"-I{CSRC}"]
    t0 = time.perf_counter()
    # one nvcc per source, in parallel, then one link
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            base + ["-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate()[0] for p in procs]
    failed = [(p.returncode, log) for p, log in zip(procs, logs)
              if p.returncode != 0]
    tmp = BUILD_DIR / f"{LIB_NAME}.{tag}"
    if not failed:
        link = subprocess.run(
            [nvcc, *LINK_FLAGS, "-o", str(tmp)]
            + [str(o) for o in objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            failed.append((link.returncode, link.stdout))
    for obj in objs:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError(f"nvcc failed ({failed[0][0]}):\n{failed[0][1]}")
    os.replace(tmp, lib_path)
    hash_path.write_text(digest)
    log = "\n".join(logs)
    return {"compiled": True, "seconds": seconds, "path": str(lib_path),
            "resources": kernel_resources(log),
            "serialized": serialized_wgmma(log)}


def library():
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            info = build()
            lib = ctypes.CDLL(info["path"])
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.cic_error_string.argtypes = [ctypes.c_int]
            lib.cic_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib, code: int, name: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if code != 0:
        msg = lib.cic_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} "
                           f"({msg})")


def ptr(t) -> int:
    """A tensor's device address (None -> NULL)."""
    return 0 if t is None else t.data_ptr()


def stream(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
