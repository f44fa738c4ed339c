"""A small ctypes binding to the system's zstd library (`libzstd.so.1`),
for the orbax tier's reader (training/orbax_tier.py): tensorstore
compresses OCDBT nodes and zarr chunks with zstd.

The library is found with `ctypes.util.find_library("zstd")` at the first
call, not at import.  Where it is missing, `decompress` raises OSError
naming it: nothing falls back to another decoder.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading

LIBRARY = "zstd"
_CONTENTSIZE_UNKNOWN = 2 ** 64 - 1
_CONTENTSIZE_ERROR = 2 ** 64 - 2
_ERROR_DST_SIZE_TOO_SMALL = 70  # ZSTD_error_dstSize_tooSmall
_lock = threading.Lock()
_lib = None


def library():
    """The loaded library; OSError where the system has none."""
    global _lib
    with _lock:
        if _lib is None:
            name = ctypes.util.find_library(LIBRARY)
            if name is None:
                raise OSError(f"lib{LIBRARY} not found "
                              f"(ctypes.util.find_library({LIBRARY!r})): "
                              "zstd-compressed orbax data cannot be read")
            lib = ctypes.CDLL(name)
            lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_void_p,
                                                     ctypes.c_size_t]
            lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
            lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                            ctypes.c_void_p, ctypes.c_size_t]
            lib.ZSTD_decompress.restype = ctypes.c_size_t
            lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
            lib.ZSTD_isError.restype = ctypes.c_uint
            lib.ZSTD_getErrorCode.argtypes = [ctypes.c_size_t]
            lib.ZSTD_getErrorCode.restype = ctypes.c_int
            lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
            lib.ZSTD_getErrorName.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def available() -> bool:
    try:
        library()
    except OSError:
        return False
    return True


def decompress(data: bytes, size: int | None = None) -> bytes:
    """The frames of `data` decompressed.  `size` is the decompressed size
    where the caller knows it (zarr chunks: their frames carry none); else
    the frame's own, or a buffer that grows until the output fits."""
    lib = library()
    src = bytes(data)
    if size is None:
        known = lib.ZSTD_getFrameContentSize(src, len(src))
        if known == _CONTENTSIZE_ERROR:
            raise ValueError("zstd: not a zstd frame")
        if known != _CONTENTSIZE_UNKNOWN:
            size = int(known)
    cap = size if size is not None else max(4 * len(src), 1 << 16)
    while True:
        dst = ctypes.create_string_buffer(max(cap, 1))
        n = lib.ZSTD_decompress(dst, cap, src, len(src))
        if not lib.ZSTD_isError(n):
            if size is not None and n != size:
                raise ValueError(f"zstd: {n} bytes decompressed, {size} "
                                 "expected")
            return dst.raw[:n]
        if size is None and \
                lib.ZSTD_getErrorCode(n) == _ERROR_DST_SIZE_TOO_SMALL:
            cap *= 4
            continue
        raise ValueError("zstd: " + lib.ZSTD_getErrorName(n).decode())
