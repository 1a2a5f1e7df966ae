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
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vdpp_tpu_torch"
# --split-compile=8: the device code's kernels are optimised and assembled on
# up to 8 threads (the flash source's ~110 kernels: 102 s alone, 52 s split,
# on an H100 machine's 8-core host; chip_smoke.py prints the build's seconds).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "--split-compile=8",
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


def operand_strides(t) -> tuple[int, ...] | None:
    """The element strides the attention kernels are given for tensor ``t``,
    or None where ``t`` breaks their input rule.

    The rule: a 16-byte aligned data pointer, and either ``t`` contiguous or
    its innermost axis dense (stride 1) with every other stride a positive
    multiple of 16 bytes, as TMA's tensor maps and the 16-byte vector loads
    need. The fused QKV projection's chunks (a ``(..., 3, H, D)`` view with
    token stride ``3 H D``) pass it at every model width. An axis of size 1
    is never stepped along: its stride is passed as a contiguous tensor's
    would be there. A plain function of the tensor's layout, so the CPU
    tests can hold the models' tensors to it.
    """
    if t.data_ptr() % 16:
        return None
    return _layout_strides(tuple(t.shape), t.stride(), t.element_size(), t.is_contiguous())


@functools.lru_cache(maxsize=1024)
def _layout_strides(shape: tuple, strides: tuple, size: int,
                    contiguous: bool) -> tuple[int, ...] | None:
    """:func:`operand_strides` but for the pointer, by layout (cached: the
    wrappers ask it three times a launch, and a model has few layouts)."""
    if not contiguous:
        if shape[-1] > 1 and strides[-1] != 1:
            return None
        if any(n > 1 and (s <= 0 or s * size % 16) for n, s in zip(shape[:-1], strides[:-1])):
            return None
    out = [1]
    for i in range(len(shape) - 2, -1, -1):
        out.insert(0, strides[i] if shape[i] > 1 else out[0] * shape[i + 1])
    return tuple(out)


def kernel_operands(*tensors) -> tuple[list, ctypes.Array, int]:
    """``(tensors, strides, copies)`` for an attention kernel's launch: each
    tensor as it is where it passes :func:`operand_strides`, else a
    contiguous copy of it (fresh, so aligned), ``strides`` the operands'
    element strides in order but the innermost (1), as the C entries take
    them (a ``long long`` array, shared between calls: read, never written),
    and ``copies`` how many were copied."""
    out, strides, copies = [], (), 0
    for t in tensors:
        st = operand_strides(t)
        if st is None:
            import torch

            t = torch.empty_like(t, memory_format=torch.contiguous_format).copy_(t)
            st = operand_strides(t)
            copies += 1
        out.append(t)
        strides += st[:-1]
    return out, _c_strides(strides), copies


def padded_operands(*tensors) -> tuple[list, ctypes.Array, int]:
    """:func:`kernel_operands` for tensors whose innermost axis is no whole
    number of 16-byte words (bf16 d % 8, fp32 d % 4), which neither TMA nor
    the 16-byte copies can step along: each is copied into a zeroed buffer
    whose rows are that axis rounded up to 16 bytes, and the view of its
    first ``d`` columns is passed (the same values, head dim dense, every
    other stride a multiple of 16 bytes, axes of size 1 included). Every
    tensor counts as a copy."""
    import torch

    out, strides = [], ()
    for t in tensors:
        d = t.shape[-1]
        align = 16 // t.element_size()
        buf = torch.zeros((*t.shape[:-1], -(-d // align) * align), dtype=t.dtype,
                          device=t.device)
        view = buf[..., :d]
        view.copy_(t)
        out.append(view)
        strides += view.stride()[:-1]
    return out, _c_strides(strides), len(tensors)


@functools.lru_cache(maxsize=1024)
def _c_strides(strides: tuple) -> ctypes.Array:
    return (ctypes.c_longlong * len(strides))(*strides)


def variant_launches() -> dict:
    """This process's launches of the kernels' variants that no model
    reaches: flash attention at d > 512 and at B * H > 65,535, GroupNorm+SiLU
    past C = 4096, G = 256 or N = 65,535 (counters that only grow)."""
    from vdpp_tpu_torch.ops import flash_attention, norm_kernel

    return {"flash_wide": flash_attention.variant_launches["wide"],
            "flash_many_heads": flash_attention.variant_launches["many_heads"],
            "group_norm_silu_wide": norm_kernel.wide_launches}


def launch_counts() -> dict:
    """The kernel wrappers' launch counts in this process: flash by head
    dim, GroupNorm+SiLU, frame attention and the variants
    (:func:`variant_launches`)."""
    from vdpp_tpu_torch.ops import flash_attention, norm_kernel, temporal_attention_kernel

    return {"flash": dict(flash_attention.launches), "group_norm_silu": norm_kernel.launches,
            "frame_attention": temporal_attention_kernel.launches,
            "variants": variant_launches()}


def launches_since(before: dict) -> dict:
    """The launches since :func:`launch_counts` gave ``before`` (flash only
    at the head dims that launched)."""
    after = launch_counts()
    flash = {d: n - before["flash"].get(d, 0) for d, n in after["flash"].items()}
    return {"flash": {d: n for d, n in flash.items() if n},
            **{k: after[k] - before[k] for k in ("group_norm_silu", "frame_attention")},
            "variants": {k: n - before["variants"][k] for k, n in after["variants"].items()}}
