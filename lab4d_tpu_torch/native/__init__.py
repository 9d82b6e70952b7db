"""Native (C++) pixel gathers of the training batch pipeline: the port's
copy of lab4d_tpu/native.

`src/sampler.cpp` is built with g++ at first use into
`build/lab4d_tpu_torch/libsampler-<hash>.so` beside the package, the hash
taken over the source and the flags, and loaded with ctypes under a lock.
A failed build raises with the compiler's output; nothing falls back to
numpy on its own. Beside each C entry point is a plain numpy version
(`gather_pixels_reference`, `gather_features_bilinear_reference`) that
computes the same float32 values in the same order, so that the two agree
exactly: the library is built with `-ffp-contract=off`, so no product is
fused into a multiply-add that numpy would round twice.

`backend(name)` gives the pair of gathers that
`VidData.load_pairs_batch` uses: "native" (the library) or "reference"
(numpy).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import types
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "sampler.cpp"
BUILD_DIR = SRC.parents[3] / "build" / "lab4d_tpu_torch"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-ffp-contract=off")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_DTYPE_CODE = {
    np.dtype(np.float32): 0,
    np.dtype(np.float16): 1,
    np.dtype(np.uint8): 2,
    np.dtype(np.bool_): 2,
}


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libsampler-{digest[:16]}.so"


def _build(out: Path):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"the native sampler did not build: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"the native sampler did not build: {' '.join(cmd)}:\n{proc.stderr}")
    os.replace(tmp, out)


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if it is missing."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not out.exists():
            _build(out)
        lib = ctypes.CDLL(str(out))
        c_i64, c_p = ctypes.c_int64, ctypes.c_void_p
        lib.gather_pixels.argtypes = [
            c_p, c_i64, c_i64, c_i64, c_i64, ctypes.c_int, c_p, c_p,
            c_i64, c_i64, c_i64, c_i64, c_p,
        ]
        lib.gather_features_bilinear.argtypes = [
            c_p, c_i64, c_i64, c_i64, c_i64, ctypes.c_int, c_p, c_p,
            c_i64, c_i64, ctypes.c_float, c_p,
        ]
        _lib = lib
        return _lib


def _as_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _source(src: np.ndarray, ndim: int = 4):
    """src as a C-contiguous array of a dtype the library reads, and its code."""
    arr = src if src.ndim == ndim else src.reshape(src.shape + (1,))
    code = _DTYPE_CODE.get(arr.dtype)
    if code is None:
        raise TypeError(f"the native sampler reads float32, float16, uint8 or bool, not {arr.dtype}")
    return np.ascontiguousarray(arr), code


def _indices(fids, xys):
    return (np.ascontiguousarray(fids, dtype=np.int32),
            np.ascontiguousarray(xys, dtype=np.int32))


def gather_pixels(src: np.ndarray, fids: np.ndarray, xys: np.ndarray,
                  c_begin: int = 0, c_end: Optional[int] = None) -> np.ndarray:
    """Pixels of a (T, H, W, C) or (T, H, W) array: fids (F,) frame ids,
    xys (F, P, 2) pixel (x, y); returns (F, P, c_end - c_begin) float32."""
    lib = get_lib()
    arr, code = _source(src)
    T, H, W, C = arr.shape
    c_end = C if c_end is None else c_end
    fids, xys = _indices(fids, xys)
    F, P = xys.shape[0], xys.shape[1]
    out = np.empty((F, P, c_end - c_begin), np.float32)
    lib.gather_pixels(_as_ptr(arr), T, H, W, C, code, _as_ptr(fids), _as_ptr(xys),
                      F, P, c_begin, c_end, _as_ptr(out))
    return out


def gather_features_bilinear(src: np.ndarray, fids: np.ndarray, xys: np.ndarray,
                             scale: float) -> np.ndarray:
    """Bilinear samples of (T, Hf, Wf, C) features at the image pixels xys
    (F, P, 2) times `scale`; returns (F, P, C) float32."""
    lib = get_lib()
    arr, code = _source(src)
    T, Hf, Wf, C = arr.shape
    fids, xys = _indices(fids, xys)
    F, P = xys.shape[0], xys.shape[1]
    out = np.empty((F, P, C), np.float32)
    lib.gather_features_bilinear(_as_ptr(arr), T, Hf, Wf, C, code, _as_ptr(fids),
                                 _as_ptr(xys), F, P, ctypes.c_float(scale), _as_ptr(out))
    return out


def gather_pixels_reference(src: np.ndarray, fids: np.ndarray, xys: np.ndarray,
                            c_begin: int = 0, c_end: Optional[int] = None) -> np.ndarray:
    """gather_pixels in numpy: the same float32 values."""
    arr = src if src.ndim == 4 else src.reshape(src.shape + (1,))
    fids, xys = _indices(fids, xys)
    px = arr[fids[:, None], xys[..., 1], xys[..., 0]]  # (F, P, C)
    return np.ascontiguousarray(px[..., c_begin:c_end], dtype=np.float32)


def gather_features_bilinear_reference(src: np.ndarray, fids: np.ndarray, xys: np.ndarray,
                                       scale: float) -> np.ndarray:
    """gather_features_bilinear in numpy: float32 arithmetic in the C++'s
    order (each product and sum rounded to float32), so the same values."""
    _, Hf, Wf, _ = src.shape
    fids, xys = _indices(fids, xys)
    one, s = np.float32(1), np.float32(scale)
    fx = xys[..., 0].astype(np.float32) * s
    fy = xys[..., 1].astype(np.float32) * s
    x0, y0 = fx.astype(np.int64), fy.astype(np.int64)  # truncation, as the C++ cast
    ax = (fx - x0.astype(np.float32))[..., None]
    ay = (fy - y0.astype(np.float32))[..., None]
    x0 = np.minimum(np.maximum(x0, 0), Wf - 2)
    y0 = np.minimum(np.maximum(y0, 0), Hf - 2)
    f = fids[:, None]

    def tap(y, x):
        return src[f, y, x].astype(np.float32)

    v11, v12 = tap(y0, x0), tap(y0, x0 + 1)
    v21, v22 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    out = v11 * (one - ax) * (one - ay) + v21 * (one - ax) * ay
    out = out + v12 * ax * (one - ay)
    out = out + v22 * ax * ay
    return np.ascontiguousarray(out, dtype=np.float32)


_BACKENDS = {
    "native": types.SimpleNamespace(gather_pixels=gather_pixels,
                                    gather_features_bilinear=gather_features_bilinear),
    "reference": types.SimpleNamespace(gather_pixels=gather_pixels_reference,
                                       gather_features_bilinear=gather_features_bilinear_reference),
}


def backend(name: str = "native"):
    """The gathers of `name`: "native" (the C++ library) or "reference"
    (numpy); each has gather_pixels and gather_features_bilinear."""
    if name not in _BACKENDS:
        raise ValueError(f"gather backend {name!r}: one of {sorted(_BACKENDS)}")
    return _BACKENDS[name]
