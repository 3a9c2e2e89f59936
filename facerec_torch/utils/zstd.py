"""Zstandard decompression through the system's ``libzstd.so.1``.

The orbax checkpoint tree compresses every OCDBT structure file and every
zarr chunk with zstd. The library is bound with ``ctypes`` (three functions
and the error name), loaded once at the first call, as ``facerec_torch.build``
loads the kernels' shared objects. Nothing here runs at import time.

A frame that records its content size decodes in one call. One that does
not (tensorstore writes the B+tree nodes and the zarr chunks that way), or
concatenated frames, decode into a buffer of ``size_hint`` bytes, or four
times the input, doubled until it fits or ``MAX_BYTES`` is passed.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from types import SimpleNamespace

from facerec_torch import build

LIBRARY = "libzstd.so.1"
_CONTENTSIZE_UNKNOWN = 2**64 - 1
_CONTENTSIZE_ERROR = 2**64 - 2
_ERROR_DST_TOO_SMALL = 70  # ZSTD_error_dstSize_tooSmall
MAX_BYTES = 1 << 31  # the largest output tried: a bound on what a corrupt frame can claim

_lib: SimpleNamespace | None = None


def library() -> SimpleNamespace:
    """The bound functions of ``libzstd``; RuntimeError naming it when it is
    missing."""
    global _lib
    if _lib is None:
        name = ctypes.util.find_library("zstd") or LIBRARY
        try:
            lib = ctypes.CDLL(name)
        except OSError as e:
            raise RuntimeError(
                f"zstd decompression needs the system library {LIBRARY} (Debian/Ubuntu "
                f"package libzstd1), which could not be loaded: {e}") from e
        size_t = ctypes.c_size_t
        _lib = SimpleNamespace(**{sym: build.function(lib, sym, args, res) for sym, args, res in (
            ("ZSTD_getFrameContentSize", (ctypes.c_char_p, size_t), ctypes.c_ulonglong),
            ("ZSTD_decompress", (ctypes.c_void_p, size_t, ctypes.c_char_p, size_t), size_t),
            ("ZSTD_isError", (size_t,), ctypes.c_uint),
            ("ZSTD_getErrorName", (size_t,), ctypes.c_char_p))})
    return _lib


def _error_code(ret: int) -> int:
    """ZSTD_getErrorCode: an error return is ``(size_t)-code``."""
    return (2**64 - ret) if ret else 0


def decompress(frame: bytes, size_hint: int | None = None) -> bytes:
    """The content of one or more concatenated zstd frames. ``size_hint``:
    the expected decoded size when the frame does not record it."""
    lib = library()
    frame = bytes(frame)
    size = lib.ZSTD_getFrameContentSize(frame, len(frame))
    if size == _CONTENTSIZE_ERROR:
        raise ValueError("not a zstd frame (bad magic or header)")
    cap = size if size != _CONTENTSIZE_UNKNOWN else max(size_hint or 4 * len(frame), 64)
    while True:
        if cap > MAX_BYTES:
            raise ValueError(f"zstd frame decodes to more than {MAX_BYTES} bytes")
        out = ctypes.create_string_buffer(max(cap, 1))
        ret = lib.ZSTD_decompress(out, cap, frame, len(frame))
        if not lib.ZSTD_isError(ret):
            return ctypes.string_at(out, ret)
        if _error_code(ret) != _ERROR_DST_TOO_SMALL:
            raise ValueError("zstd: " + lib.ZSTD_getErrorName(ret).decode())
        cap *= 2  # a second frame follows, or the size was not recorded
