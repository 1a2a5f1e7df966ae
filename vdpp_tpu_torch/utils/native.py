"""ctypes binding of the repository's native video writer
(``native/videopack.cpp``), the port's own copy of
``vdpp_tpu/utils/native.py``.

The library is compiled from that source with ``g++`` at first use into
``build/vdpp_tpu_torch/`` (named by a hash of the source and flags, like the
CUDA kernels), never into ``native/``. Without a compiler every writer
returns None, or, for Y4M, falls back to numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from vdpp_tpu_torch.utils.kernels import BUILD_DIR

LOGGER = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parents[2] / "native" / "videopack.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared", "-pthread")

_U8P = ctypes.POINTER(ctypes.c_uint8)
_SIGNATURES = {
    "vdpp_write_y4m": [ctypes.c_char_p, _U8P] + [ctypes.c_int] * 5,
    "vdpp_write_gif": [ctypes.c_char_p, _U8P] + [ctypes.c_int] * 4,
    "vdpp_write_avi_mjpeg": [ctypes.c_char_p, _U8P] + [ctypes.c_int] * 6,
    "vdpp_write_mp4_mjpeg": [ctypes.c_char_p, _U8P] + [ctypes.c_int] * 6,
}

_lib: ctypes.CDLL | None = None
_tried = False
# One build at a time: a caller that comes while another builds waits for
# the library, rather than writing through numpy, whose bytes differ.
_load_lock = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libvideopack-{digest.hexdigest()[:16]}.so"


def _load() -> ctypes.CDLL | None:
    """The library, built first if needed; None without a compiler."""
    with _load_lock:
        return _build_and_load()


def _build_and_load() -> ctypes.CDLL | None:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not SOURCE.is_file():
        return None
    path = library_path()
    if not path.exists():
        if cxx is None:
            LOGGER.debug("no C++ compiler: the native video writer is unavailable")
            return None
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        try:
            subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)], check=True,
                           capture_output=True, timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            LOGGER.warning("native video writer build failed: %s", e)
            return None
        os.replace(tmp, path)
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        LOGGER.warning("native video writer load failed: %s", e)
        return None
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return _lib


def _frames(frames_uint8: np.ndarray) -> tuple[np.ndarray, int, int, int]:
    frames_uint8 = np.ascontiguousarray(frames_uint8, np.uint8)
    if frames_uint8.ndim != 4 or frames_uint8.shape[-1] != 3:
        raise ValueError(f"frames must be (F, H, W, 3), got {frames_uint8.shape}")
    f, h, w, _ = frames_uint8.shape
    return frames_uint8, f, h, w


def write_gif_native(path: str, frames_uint8: np.ndarray, fps: int = 7) -> str | None:
    """(F, H, W, 3) uint8 frames -> an animated GIF (median-cut palette,
    LZW); None when the library is unavailable or fails."""
    lib = _load()
    if lib is None:
        return None
    frames, f, h, w = _frames(frames_uint8)
    rc = lib.vdpp_write_gif(path.encode(), frames.ctypes.data_as(_U8P), f, h, w, int(fps))
    if rc != 0:
        LOGGER.warning("native gif writer failed rc=%d", rc)
        return None
    return path


def _write_mjpeg(fn_name: str, path: str, frames_uint8: np.ndarray, fps: int,
                 quality: int) -> str | None:
    lib = _load()
    if lib is None:
        return None
    frames, f, h, w = _frames(frames_uint8)
    rc = getattr(lib, fn_name)(path.encode(), frames.ctypes.data_as(_U8P), f, h, w, int(fps),
                               1, int(quality))
    if rc != 0:
        LOGGER.warning("native %s failed rc=%d", fn_name, rc)
        return None
    return path


def write_avi_mjpeg(path: str, frames_uint8: np.ndarray, fps: int = 7,
                    quality: int = 90) -> str | None:
    """Baseline JPEG frames in a RIFF AVI 'MJPG' stream; None when the
    library is unavailable."""
    return _write_mjpeg("vdpp_write_avi_mjpeg", path, frames_uint8, fps, quality)


def write_mp4_mjpeg(path: str, frames_uint8: np.ndarray, fps: int = 7,
                    quality: int = 90) -> str | None:
    """An ISO BMFF ``.mp4`` with one all-keyframe MJPEG track; None when the
    library is unavailable."""
    return _write_mjpeg("vdpp_write_mp4_mjpeg", path, frames_uint8, fps, quality)


def _rgb_to_yuv420_numpy(frame: np.ndarray) -> np.ndarray:
    """BT.601 studio-swing RGB888 -> planar YUV420."""
    h, w, _ = frame.shape
    f = frame.astype(np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 16.0 + 0.257 * r + 0.504 * g + 0.098 * b
    u = 128.0 - 0.148 * r - 0.291 * g + 0.439 * b
    v = 128.0 + 0.439 * r - 0.368 * g - 0.071 * b
    u = u.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
    v = v.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
    return np.concatenate([np.clip(c + 0.5, 0, 255).astype(np.uint8).ravel()
                           for c in (y, u, v)])


def write_y4m(path: str, frames_uint8: np.ndarray, fps: int = 7) -> str:
    """(F, H, W, 3) uint8 frames -> YUV4MPEG2 (odd sizes cropped to even),
    through the library when it loads, numpy otherwise."""
    frames, f, h, w = _frames(frames_uint8)
    if h % 2 or w % 2:
        frames, f, h, w = _frames(frames[:, : h - h % 2, : w - w % 2])
    lib = _load()
    if lib is not None:
        rc = lib.vdpp_write_y4m(path.encode(), frames.ctypes.data_as(_U8P), f, h, w, int(fps), 1)
        if rc == 0:
            return path
        LOGGER.warning("native y4m writer failed rc=%d; numpy fallback", rc)
    with open(path, "wb") as fp:
        fp.write(f"YUV4MPEG2 W{w} H{h} F{int(fps)}:1 Ip A1:1 C420jpeg\n".encode())
        for i in range(f):
            fp.write(b"FRAME\n")
            fp.write(_rgb_to_yuv420_numpy(frames[i]).tobytes())
    return path
