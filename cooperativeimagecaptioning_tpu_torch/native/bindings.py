"""ctypes bindings for the port's C++ host library (cic_native.cpp,
cic_io.cpp, cic_spice.cpp; the JAX package's native/bindings.py).

At first use the three sources are compiled with
`g++ -O2 -std=c++17 -shared -fPIC ... -lz` into
`native/libcic_native-<hash>.so` under `utils/build_dirs.build_root()` (the
checkout's `build/`, or a per-user cache directory for an installed copy),
the hash taken over the sources, the flags and `g++ --version`, so that a
changed source or compiler builds a new library and nothing is written
beside the sources.  Every entry point has a pure-Python counterpart in
metrics/ (and np.load for the readers), used while the library is not
built; `available()` says which tier runs, and `build_log()` keeps the
compiler's output of a failed build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

from cooperativeimagecaptioning_tpu_torch.utils import build_dirs

_HERE = Path(__file__).resolve().parent
SOURCES = [_HERE / "cic_native.cpp", _HERE / "cic_io.cpp",
           _HERE / "cic_spice.cpp"]
BUILD_DIR = build_dirs.build_root() / "native"
FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]
LIBS = ["-lz"]
_lock = threading.Lock()
_lib = None
_tried = False
_log = [""]  # the compiler's output of the last failed build


def library_path(compiler_version: str) -> Path:
    h = hashlib.sha256(" ".join(FLAGS + LIBS).encode())
    h.update(compiler_version.encode())
    for p in SOURCES:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libcic_native-{h.hexdigest()[:16]}.so"


def build(force: bool = False):
    """Compile the library unless a build of these sources is there.
    Returns its path, or None when the compiler is missing or fails (its
    output then in `build_log()`)."""
    try:
        version = subprocess.run(["g++", "--version"], capture_output=True,
                                 text=True, check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as e:
        _log[0] = f"g++ not usable: {e}"
        return None
    so = library_path(version)
    if so.is_file() and not force:
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(
            ["g++", *FLAGS, *map(str, SOURCES), "-o", str(tmp), *LIBS],
            capture_output=True, text=True, timeout=300)
    except subprocess.SubprocessError as e:
        _log[0] = f"g++ did not finish: {e}"
        tmp.unlink(missing_ok=True)
        return None
    if proc.returncode != 0:
        _log[0] = f"g++ exited {proc.returncode}:\n{proc.stderr}"
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, so)  # atomic: concurrent builds each install a whole file
    return so


def build_log() -> str:
    """Why the library is not available ('' when it is, or before a try)."""
    return _log[0]


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = build()
        if so is None:
            return None
        lib = ctypes.CDLL(str(so))
        lib.cic_tokenize.argtypes = [ctypes.c_char_p]
        lib.cic_tokenize.restype = ctypes.c_char_p
        lib.cic_meteor.argtypes = [ctypes.c_char_p]
        lib.cic_meteor.restype = ctypes.c_double
        lib.cic_meteor_stats.argtypes = [ctypes.c_char_p,
                                         ctypes.POINTER(ctypes.c_double)]
        lib.cic_meteor_stats.restype = ctypes.c_double
        lib.cic_meteor_corpus.argtypes = [ctypes.POINTER(ctypes.c_double)]
        lib.cic_meteor_corpus.restype = ctypes.c_double
        lib.cic_meteor_configure.argtypes = [ctypes.c_char_p]
        lib.cic_meteor_configure.restype = ctypes.c_int
        lib.cic_porter_stem.argtypes = [ctypes.c_char_p]
        lib.cic_porter_stem.restype = ctypes.c_char_p
        lib.cic_version.argtypes = []
        lib.cic_version.restype = ctypes.c_int
        for fn in (lib.cic_read_npy, lib.cic_read_npz_feat):
            fn.argtypes = [ctypes.c_char_p,
                           ctypes.POINTER(ctypes.c_float),
                           ctypes.c_int64,
                           ctypes.POINTER(ctypes.c_int64)]
            fn.restype = ctypes.c_int
        lib.cic_spice.argtypes = [ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.c_double)]
        lib.cic_spice.restype = ctypes.c_int
        lib.cic_spice_configure.argtypes = [ctypes.c_char_p]
        lib.cic_spice_configure.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def ptb_tokenize(captions_for_image: dict) -> dict:
    """Same contract as metrics.tokenizer.tokenize."""
    lib = _load()
    keys, lines = [], []
    for k, caps in captions_for_image.items():
        for c in caps:
            keys.append(k)
            lines.append(c["caption"].replace("\n", " "))
    payload = "\n".join(lines).encode("utf-8", "replace")
    out_lines = lib.cic_tokenize(payload).decode("utf-8").split("\n") \
        if lines else []
    # the C line loop drops trailing empty lines (e.g. a model emitting an
    # empty caption); pad — tokenize("") == "" so this is exact
    out_lines += [""] * (len(keys) - len(out_lines))
    out = {k: [] for k in captions_for_image}
    for k, line in zip(keys, out_lines):
        out[k].append(line)
    return out


_meteor_cfg = [None]  # last-configured resource serialization


def meteor(gts: dict, res: dict, resources=None):
    """Same contract as metrics.meteor.compute_meteor: per-segment scores +
    the jar's micro-averaged corpus score over summed stats.  `resources`
    (metrics.meteor.MeteorResources) activates the synonym/paraphrase stages
    via cic_meteor_configure; the serialization is cached so repeated corpus
    calls don't re-push the table."""
    import numpy as np
    lib = _load()
    wire = resources.serialize() if resources is not None else ""
    if wire != _meteor_cfg[0]:
        lib.cic_meteor_configure(wire.encode("utf-8", "replace"))
        _meteor_cfg[0] = wire
    ids = sorted(gts.keys(), key=lambda x: str(x))
    scores = []
    total = np.zeros(6)
    out7 = (ctypes.c_double * 7)()
    for i in ids:
        payload = (res[i][0] + "\x02" + "\x01".join(gts[i])).encode(
            "utf-8", "replace")
        scores.append(lib.cic_meteor_stats(payload, out7))
        total += np.asarray(out7[1:7])
    summed = (ctypes.c_double * 6)(*total)
    return float(lib.cic_meteor_corpus(summed)), np.array(scores)


def porter_stem(word: str) -> str:
    lib = _load()
    return lib.cic_porter_stem(word.encode("utf-8")).decode("utf-8")


_scratch = threading.local()


def _scratch_buf(max_elems):
    """Per-thread reusable scratch for the native readers (thread-local
    because the train and val prefetch workers read concurrently).  The
    readers copy out of it before returning."""
    import numpy as np
    buf = getattr(_scratch, "buf", None)
    if buf is None or buf.size < max_elems:
        buf = _scratch.buf = np.empty(max_elems, np.float32)
    return buf


def _read(fn, path, max_elems):
    import numpy as np
    buf = _scratch_buf(max_elems)
    shape = np.zeros(8, np.int64)
    ndim = fn(path.encode(),
              buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_elems,
              shape.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if ndim <= 0:
        return None
    shp = tuple(int(s) for s in shape[:ndim])
    n = int(np.prod(shp))
    return buf[:n].reshape(shp).copy()


def read_npy(path: str, max_elems: int = 1 << 24):
    """Native npy reader (f32, C-order).  Returns ndarray or None on
    unsupported input (caller falls back to np.load)."""
    return _read(_load().cic_read_npy, path, max_elems)


def read_npz_feat(path: str, max_elems: int = 1 << 24):
    """Native npz['feat'] reader (stored or deflated member)."""
    return _read(_load().cic_read_npz_feat, path, max_elems)


_spice_cfg = [None]  # last-pushed synonym serialization


def spice_configure(groups) -> None:
    """Push SPICE synonym groups (iterable of word lists) to the C++ tier;
    metrics.spice keeps this in lockstep with its own table.  Empty clears
    back to exact matching.  Idempotent pushes are skipped."""
    lib = _load()
    if lib is None:
        return
    payload = "\x01".join(" ".join(g) for g in groups)
    if _spice_cfg[0] == payload:
        return
    lib.cic_spice_configure(payload.encode("utf-8", "replace"))
    _spice_cfg[0] = payload


def spice_sentence(hyp: str, refs: list) -> dict:
    """Same contract as metrics.spice.sentence_spice (synonym matching
    follows the last spice_configure push — metrics.spice pushes whenever
    its own table changes)."""
    lib = _load()
    out = (ctypes.c_double * 12)()
    payload = (hyp + "\x02" + "\x01".join(refs)).encode("utf-8", "replace")
    if lib.cic_spice(payload, out) != 0:
        raise ValueError("bad spice payload")
    cats = ("All", "Object", "Attribute", "Relation")
    return {c: {"p": out[3 * i], "r": out[3 * i + 1], "f": out[3 * i + 2]}
            for i, c in enumerate(cats)}
