"""Reading and writing videos (the port's own copy of the reader and the
writers in ``vdpp_tpu/utils/video_io.py``).

``save_video_mp4`` picks the best container it can write: H.264 MP4 through
imageio when an ffmpeg backend is installed; else the native MJPEG-in-MP4
(with a lossless Y4M beside it); else MJPEG-AVI; else Y4M; else GIF. These
are format choices, not device fallbacks.
"""

from __future__ import annotations

import logging
import os
from datetime import datetime

import numpy as np

from vdpp_tpu_torch.utils import native

LOGGER = logging.getLogger(__name__)


def read_y4m(path: str) -> tuple[np.ndarray, int]:
    """A YUV4MPEG2 4:2:0 file -> (uint8 RGB frames (F, H, W, 3), fps).

    Inverts the native writer's conversion (``native/videopack.cpp``: BT.601
    studio swing, 2x2 box-averaged chroma) with a nearest chroma upsample;
    takes the 8-bit 4:2:0 siting variants. The input of the video->video
    restyle app.
    """
    with open(path, "rb") as f:
        header = f.readline().decode("ascii", "replace").strip()
        if not header.startswith("YUV4MPEG2"):
            raise ValueError(f"{path}: not a YUV4MPEG2 file ({header[:20]!r})")
        w = h = 0
        fps = 30
        colorspace = "C420jpeg"
        for tok in header.split()[1:]:
            if tok[0] == "W":
                w = int(tok[1:])
            elif tok[0] == "H":
                h = int(tok[1:])
            elif tok[0] == "F":
                num, den = tok[1:].split(":")
                fps = max(1, round(int(num) / max(int(den), 1)))
            elif tok[0] == "C":
                colorspace = tok
        if not w or not h:
            raise ValueError(f"{path}: header missing W/H: {header!r}")
        # 8-bit only: C420p10 and the like have two bytes a sample.
        if colorspace not in ("C420", "C420jpeg", "C420mpeg2", "C420paldv"):
            raise ValueError(f"{path}: only 8-bit 4:2:0 colorspaces supported "
                             f"(C420/C420jpeg/C420mpeg2/C420paldv), got {colorspace}")
        ch, cw = h // 2, w // 2
        frame_bytes = h * w + 2 * ch * cw
        frames = []
        while True:
            line = f.readline()
            if not line:
                break
            if not line.startswith(b"FRAME"):
                raise ValueError(f"{path}: bad frame marker {line[:20]!r}")
            raw = f.read(frame_bytes)
            if len(raw) != frame_bytes:
                raise ValueError(f"{path}: truncated frame {len(frames)}")
            planes = np.frombuffer(raw, np.uint8)
            y = planes[: h * w].reshape(h, w).astype(np.float32)
            u = planes[h * w: h * w + ch * cw].reshape(ch, cw).astype(np.float32)
            v = planes[h * w + ch * cw:].reshape(ch, cw).astype(np.float32)
            u = np.repeat(np.repeat(u, 2, axis=0), 2, axis=1)
            v = np.repeat(np.repeat(v, 2, axis=0), 2, axis=1)
            yp = (y - 16.0) * 1.164
            up, vp = u - 128.0, v - 128.0
            rgb = np.stack([yp + 1.596 * vp, yp - 0.813 * vp - 0.391 * up, yp + 2.018 * up],
                           axis=-1)
            frames.append(np.clip(rgb + 0.5, 0.0, 255.0).astype(np.uint8))
    if not frames:
        raise ValueError(f"{path}: no frames")
    return np.stack(frames), fps


def frames_to_uint8(video: np.ndarray) -> np.ndarray:
    """(F, H, W, 3) float in [-1, 1] -> uint8 [0, 255]."""
    video = np.asarray(video, np.float32)
    video = (video / 2.0 + 0.5).clip(0.0, 1.0)
    return (video * 255.0 + 0.5).astype(np.uint8)


def build_output_name(prefix: str, *, num_frames: int, steps: int, stages: int, fps: int,
                      seed: int, ext: str) -> str:
    ts = datetime.now().strftime("%Y%m%d_%H%M%S")
    return f"{prefix}_{ts}_f{num_frames}_s{steps}_st{stages}_fps{fps}_seed{seed}.{ext}"


def _try_write_y4m(path: str, frames_uint8: np.ndarray, fps: int) -> str | None:
    """A lossless Y4M next to ``path``; None on failure."""
    try:
        y4m_path = native.write_y4m(os.path.splitext(path)[0] + ".y4m", frames_uint8, fps=fps)
    except OSError as e:
        LOGGER.warning("y4m write failed: %s", e)
        return None
    LOGGER.info("wrote %s (%d frames)", y4m_path, len(frames_uint8))
    return y4m_path


def save_video_mp4(frames_uint8: np.ndarray, path: str, fps: int = 7) -> str:
    """Write (F, H, W, 3) uint8 frames as the best playable container
    available (see the module docstring); returns the path written."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        import imageio.v3 as iio

        iio.imwrite(path, frames_uint8, fps=fps, extension=".mp4")
        LOGGER.info("wrote %s (%d frames)", path, len(frames_uint8))
        return path
    except Exception as e:  # imageio or its ffmpeg backend missing
        LOGGER.info("mp4 through imageio unavailable (%s); native writer", e)
    if native.write_mp4_mjpeg(path, frames_uint8, fps=fps):
        LOGGER.info("wrote %s (%d frames, native MJPEG-in-MP4)", path, len(frames_uint8))
        _try_write_y4m(path, frames_uint8, fps)
        return path
    avi_path = os.path.splitext(path)[0] + ".avi"
    if native.write_avi_mjpeg(avi_path, frames_uint8, fps=fps):
        LOGGER.info("wrote %s (%d frames, native MJPEG)", avi_path, len(frames_uint8))
        _try_write_y4m(path, frames_uint8, fps)
        return avi_path
    y4m_path = _try_write_y4m(path, frames_uint8, fps)
    if y4m_path:
        return y4m_path
    return save_video_gif(frames_uint8, os.path.splitext(path)[0] + ".gif", fps=fps)


def save_video_gif(frames_uint8: np.ndarray, path: str, fps: int = 7) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if native.write_gif_native(path, frames_uint8, fps=fps):
        LOGGER.info("wrote %s (%d frames, native encoder)", path, len(frames_uint8))
        return path
    import imageio.v3 as iio

    iio.imwrite(path, frames_uint8, duration=int(1000 / fps), loop=0)
    LOGGER.info("wrote %s (%d frames)", path, len(frames_uint8))
    return path
