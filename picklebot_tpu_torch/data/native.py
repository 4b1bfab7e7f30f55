"""ctypes bridges to the port's C++ data cores (``data/native_src/*.cpp``).

The port's own copy of ``picklebot_tpu/data/native.py``, built from the
port's own copies of its two sources:

* ``collate.cpp``: the ragged-clip collate into the zeroed padded batch,
  a memcpy per clip on a small thread pool;
* ``videodec.cpp``: libavformat/libavcodec/libswscale decode to RGB24
  (T, H, W, 3), with frame-rate sampling, the analog of the reference's
  ``torchvision.read_video`` backend.

Each library builds at its first use with ``g++`` (``utils/build.py``
``build_host``) into ``picklebot_tpu_torch/_build/<name>-<hash>.so``, the
hash over the source, the flags below (the JAX package's) and the host,
so a copied tree builds anew on another machine. The GIL is
released for every foreign call. Where a library cannot be built the
collate answers False (``pad_collate`` then takes its numpy path, and
``COLLATES`` counts which path ran) and the decoder raises the JAX
package's RuntimeError naming the missing libraries; ``build_error`` keeps
the compiler's message.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from picklebot_tpu_torch.utils.build import build_host

SRC_DIR = Path(__file__).resolve().parent / "native_src"
# (source, g++ flags) by library: the JAX package's flags
LIBRARIES = {
    "collate": (SRC_DIR / "collate.cpp",
                ("-O3", "-march=native", "-shared", "-fPIC", "-lpthread")),
    "videodec": (SRC_DIR / "videodec.cpp",
                 ("-O2", "-shared", "-fPIC", "-lavformat", "-lavcodec",
                  "-lavutil", "-lswscale")),
}
# batches collated by each path: the C++ core, or numpy (pad_collate's
# fallback and its native=False)
COLLATES = {"native": 0, "numpy": 0}

_LOCK = threading.Lock()
_LIBS: Dict[str, Optional[ctypes.CDLL]] = {}
_ERRORS: Dict[str, str] = {}

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i64p = ctypes.POINTER(ctypes.c_int64)
_SIGNATURES = {
    "collate": {"collate_u8": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), _i64p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int])},
    "videodec": {
        "pb_decode_video_fps": (ctypes.c_int, [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_double,
            ctypes.POINTER(_u8p), _i64p, _i64p, _i64p]),
        "pb_video_free": (None, [_u8p])},
}


def _library(name: str) -> Optional[ctypes.CDLL]:
    """The loaded library ``name``, built at the first call; None (and
    the reason in ``build_error(name)``) where it cannot be built. One
    attempt per process."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        src, flags = LIBRARIES[name]
        try:
            lib = ctypes.CDLL(str(build_host(src, flags)))
        except (RuntimeError, OSError) as e:
            _ERRORS[name] = str(e)
            _LIBS[name] = None
            return None
        for fn, (restype, argtypes) in _SIGNATURES[name].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _LIBS[name] = lib
        return lib


def build_error(name: str) -> Optional[str]:
    """Why library ``name`` could not be built or loaded (after a failed
    attempt): the compiler's or the loader's message."""
    return _ERRORS.get(name)


def get_lib() -> Optional[ctypes.CDLL]:
    return _library("collate")


def get_videodec_lib() -> Optional[ctypes.CDLL]:
    return _library("videodec")


def ffmpeg_available() -> bool:
    return get_videodec_lib() is not None


def decode_video_ffmpeg(path: str, max_frames: int = 0,
                        sample_fps: float = 0.0) -> np.ndarray:
    """Decode a video via the libavcodec core -> (T, H, W, 3) uint8 RGB.
    ``sample_fps`` > 0 keeps every round-half-up(container_fps /
    sample_fps)-th frame (the stride is computed in the native core from
    the stream's frame rate, as ``dataset.sample_stride`` computes it;
    dropped frames skip color conversion). Raises RuntimeError when the
    native library is unavailable or the file can't be decoded."""
    lib = get_videodec_lib()
    if lib is None:
        raise RuntimeError(
            "ffmpeg decode backend unavailable: the native videodec "
            "library could not be built (needs g++ and the libavformat/"
            "libavcodec/libswscale dev libraries)")
    out = _u8p()
    t, h, w = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    ret = lib.pb_decode_video_fps(os.fsencode(path), max_frames,
                                  float(sample_fps), ctypes.byref(out),
                                  ctypes.byref(t), ctypes.byref(h),
                                  ctypes.byref(w))
    if ret != 0:
        raise RuntimeError(f"ffmpeg decode failed for {path!r} (code {ret})")
    try:
        n = t.value * h.value * w.value * 3
        arr = np.ctypeslib.as_array(out, shape=(n,)).copy()
    finally:
        lib.pb_video_free(out)
    return arr.reshape(t.value, h.value, w.value, 3)


def native_collate(dst: np.ndarray, clips: Sequence[np.ndarray],
                   num_threads: int = 4) -> bool:
    """Copy ragged clips into the zeroed (B, T, H, W, C) uint8 ``dst``:
    clip i's first min(T_i, T) frames, the rest left zero. True on
    success (counted in ``COLLATES["native"]``), False where the caller
    should take the numpy path (no library, mixed frame sizes)."""
    lib = get_lib()
    if lib is None:
        return False
    b, t_out = dst.shape[0], dst.shape[1]
    frame_bytes = int(np.prod(dst.shape[2:]))
    contiguous = [np.ascontiguousarray(c, np.uint8) for c in clips]
    if dst.dtype != np.uint8 or not dst.flags.c_contiguous or any(
            int(np.prod(c.shape[1:])) != frame_bytes for c in contiguous):
        return False
    src_ptrs = (ctypes.c_void_p * b)(*[c.ctypes.data for c in contiguous])
    t_lens = (ctypes.c_int64 * b)(*[c.shape[0] for c in contiguous])
    ret = lib.collate_u8(dst.ctypes.data, src_ptrs, t_lens, b, t_out,
                         frame_bytes, num_threads)
    if ret != 0:
        return False
    COLLATES["native"] += 1
    return True
