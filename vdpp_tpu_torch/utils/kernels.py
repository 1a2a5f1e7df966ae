"""Build and load the port's CUDA kernels.

Each ``vdpp_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, which the op
modules load with ``ctypes``. The sources include no PyTorch header, so a
build takes seconds. Libraries go to ``build/vdpp_tpu_torch/`` at the root of
the checkout, named by a hash of the sources and flags: an edited source
builds anew at its next use, an unchanged one is loaded as it is.

Nothing here runs at import time; a kernel is built at its first use (or by
``build()``, which starts one ``nvcc`` per stale source, all at once).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vdpp_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA kernels are "
        "built from source at first use and need the CUDA toolkit"
    )


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by its content and flags."""
    src = CSRC / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"no kernel source {src}")
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: list[str] | None = None) -> dict[str, dict]:
    """Compile the named sources (default: all) that have no current build.

    One ``nvcc`` per source, all started together. Returns, per source,
    ``{"path", "seconds", "log"}`` (``log`` holds ptxas' register and shared
    memory report; ``seconds`` is 0 for a library that was already built).
    Raises ``RuntimeError`` with the compiler's output if any build fails.
    """
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    result: dict[str, dict] = {}
    running = []
    for name in names:
        out = library_path(name)
        if out.exists():
            result[name] = {"path": str(out), "seconds": 0.0, "log": "up to date"}
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, out, tmp, proc, time.perf_counter()))
    failures = []
    for name, out, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc {name}.cu failed (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        result[name] = {"path": str(out), "seconds": seconds, "log": log.strip()}
    if failures:
        raise RuntimeError("\n".join(failures))
    return result


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib


def launch_counts() -> dict:
    """The kernel wrappers' launch counts in this process: flash by head
    dim, GroupNorm+SiLU and frame attention."""
    from vdpp_tpu_torch.ops import flash_attention, norm_kernel, temporal_attention_kernel

    return {"flash": dict(flash_attention.launches), "group_norm_silu": norm_kernel.launches,
            "frame_attention": temporal_attention_kernel.launches}


def launches_since(before: dict) -> dict:
    """The launches since :func:`launch_counts` gave ``before`` (flash only
    at the head dims that launched)."""
    after = launch_counts()
    flash = {d: n - before["flash"].get(d, 0) for d, n in after["flash"].items()}
    return {"flash": {d: n for d, n in flash.items() if n},
            **{k: after[k] - before[k] for k in ("group_norm_silu", "frame_attention")}}
