"""Native host library: a C++ source built with g++ at first use, bound with ctypes.

Counterpart of ``head_detector_tpu/native``.  ``csrc/hdt_native.cpp`` is a
byte-for-byte copy of the JAX package's source (a test holds the two equal)
with a plain C interface: a CPU z-buffer rasterizer, an OpenMP OBJ writer,
and letterbox.  ctypes releases the GIL for every call.

The library is built with ``-march=native``, so it runs only on a host like
the one that built it.  It goes into ``head_detector_tpu_torch/_build/``
(git-ignored) under a name keyed by the source, the flags and the host (its
machine type, CPU model and what ``-march=native`` means there): a tree copied to another machine builds anew
there and never loads a library built elsewhere.  Nothing is built or loaded
when the module is imported.

``available()`` is False when g++ or the build fails (``build_error()`` says
why); the consumers (``MeshSaver`` and ``StreamingDetector``'s host
letterbox) then keep their Python paths.  The card's paths never go through
it: the rasterizer there is the CUDA kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from typing import List, Optional, Tuple

import numpy as np

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(PACKAGE_DIR, "csrc", "hdt_native.cpp")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")
CXXFLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-fopenmp")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


@functools.lru_cache(maxsize=1)
def host_key() -> str:
    """The host a ``-march=native`` library is valid on: the machine type,
    the CPU model, and a digest of the target options g++ makes of
    ``-march=native`` here (a sandboxed host may not name its CPU model)."""
    model = platform.processor()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    try:
        target = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                                capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        target = ""
    return f"{platform.machine()}|{model}|{hashlib.sha256(target.encode()).hexdigest()[:16]}"


def library_path(host: Optional[str] = None) -> str:
    with open(SOURCE, "rb") as f:
        source = f.read()
    key = source + " ".join(CXXFLAGS).encode() + (host or host_key()).encode()
    return os.path.join(BUILD_DIR, f"libhdt_native-{hashlib.sha256(key).hexdigest()[:16]}.so")


def _build() -> Optional[ctypes.CDLL]:
    global _build_error
    so_path = library_path()
    if not os.path.isfile(so_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", *CXXFLAGS, SOURCE, "-o", tmp], check=True,
                           capture_output=True, timeout=300)
            os.replace(tmp, so_path)
        except (OSError, subprocess.SubprocessError) as e:
            stderr = getattr(e, "stderr", b"") or b""
            _build_error = f"{e}: {stderr.decode(errors='replace')[:500]}"
            return None
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    try:
        lib = ctypes.CDLL(so_path)
    except OSError as e:
        _build_error = str(e)
        return None

    f32, i32, u8 = (ctypes.POINTER(t) for t in (ctypes.c_float, ctypes.c_int, ctypes.c_uint8))
    lib.hdt_rasterize.argtypes = [f32, ctypes.c_int, i32, ctypes.c_int, f32, ctypes.c_int,
                                  ctypes.c_int, f32, u8, f32]
    lib.hdt_rasterize.restype = None
    lib.hdt_write_objs.argtypes = [ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
                                   ctypes.c_char_p, ctypes.c_long,
                                   ctypes.POINTER(ctypes.c_char_p), i32]
    lib.hdt_write_objs.restype = None
    lib.hdt_letterbox.argtypes = [u8, ctypes.c_int, ctypes.c_int, u8, ctypes.c_int]
    lib.hdt_letterbox.restype = ctypes.c_double
    lib.hdt_letterbox_batch.argtypes = [u8, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8,
                                        ctypes.c_int]
    lib.hdt_letterbox_batch.restype = None
    return lib


def _get() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None or _build_error is not None:
        return _lib
    with _lock:
        if _lib is None and _build_error is None:
            _lib = _build()
    return _lib


def available() -> bool:
    """True when the library built (or was already built for this host)."""
    return _get() is not None


def build_error() -> Optional[str]:
    return _build_error


def _require() -> ctypes.CDLL:
    lib = _get()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_build_error}")
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def rasterize_zbuffer_native(vertices: np.ndarray, triangles: np.ndarray, colors: np.ndarray,
                             height: int, width: int,
                             reverse: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Host twin of ``ops.rasterize.rasterize_zbuffer``: (color [H, W, 3]
    float32, hit [H, W] bool) of vertices [V, 3] (x, y in pixels, z depth),
    triangles [F, 3] and per-vertex colors [V, 3]; the nearest face wins, the
    lowest index on a depth tie."""
    lib = _require()
    v = np.ascontiguousarray(vertices, np.float32)
    t = np.ascontiguousarray(triangles, np.int32)
    c = np.ascontiguousarray(colors, np.float32)
    color = np.zeros((height, width, 3), np.float32)
    hit = np.zeros((height, width), np.uint8)
    zbuf = np.full((height, width), -1e8, np.float32)
    lib.hdt_rasterize(_ptr(v, ctypes.c_float), v.shape[0], _ptr(t, ctypes.c_int), t.shape[0],
                      _ptr(c, ctypes.c_float), height, width, _ptr(color, ctypes.c_float),
                      _ptr(hit, ctypes.c_uint8), _ptr(zbuf, ctypes.c_float))
    if reverse:
        color, hit = color[::-1], hit[::-1]
    return color, hit.astype(bool)


def write_objs_native(vertices: np.ndarray, faces_block: bytes, paths: List[str]) -> None:
    """Write ``vertices[i]`` [V, 3] as ``v %.8f %.8f %.8f`` lines (float64),
    then ``faces_block``, to ``paths[i]``: byte-equal to ``MeshSaver``'s
    Python writer."""
    lib = _require()
    v = np.ascontiguousarray(vertices, np.float64)
    if v.ndim != 3 or v.shape[-1] != 3 or v.shape[0] != len(paths):
        raise ValueError(f"expected [N={len(paths)}, V, 3] vertices, got {v.shape}")
    c_paths = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    status = np.zeros((len(paths),), np.int32)
    lib.hdt_write_objs(_ptr(v, ctypes.c_double), v.shape[0], v.shape[1], faces_block,
                       len(faces_block), c_paths, _ptr(status, ctypes.c_int))
    bad = np.nonzero(status)[0]
    if bad.size:
        raise OSError(f"failed to write {[paths[i] for i in bad[:5]]}")


def letterbox_native(image: np.ndarray, size: int,
                     out: Optional[np.ndarray] = None) -> Tuple[np.ndarray, float]:
    """Aspect-preserving bilinear resize of an HWC uint8 image pasted at the
    centre of a 127-filled ``size`` square, and its scale: the layout of
    ``StreamingDetector``'s host letterbox; within 2 counts of cv2's
    ``INTER_LINEAR`` (fixed-point weights) and equal to it in the padding.
    ``out`` (a C-contiguous [size, size, 3] uint8 array) takes the square in
    place of a new one."""
    lib = _require()
    img = np.ascontiguousarray(image, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected HWC uint8 image, got {img.shape}")
    if out is None:
        out = np.empty((size, size, 3), np.uint8)
    elif out.shape != (size, size, 3) or out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError(f"expected a contiguous [{size}, {size}, 3] uint8 out, got "
                         f"{out.shape} {out.dtype}")
    scale = lib.hdt_letterbox(_ptr(img, ctypes.c_uint8), img.shape[0], img.shape[1],
                              _ptr(out, ctypes.c_uint8), size)
    return out, float(scale)


def letterbox_batch_native(images: np.ndarray, size: int) -> np.ndarray:
    """:func:`letterbox_native` of same-shape images [N, H, W, 3] -> [N, s, s, 3]."""
    lib = _require()
    imgs = np.ascontiguousarray(images, np.uint8)
    if imgs.ndim != 4 or imgs.shape[3] != 3:
        raise ValueError(f"expected [N, H, W, 3] uint8 batch, got {imgs.shape}")
    out = np.empty((imgs.shape[0], size, size, 3), np.uint8)
    lib.hdt_letterbox_batch(_ptr(imgs, ctypes.c_uint8), imgs.shape[0], imgs.shape[1],
                            imgs.shape[2], _ptr(out, ctypes.c_uint8), size)
    return out
