"""Per-rank memory statistics (port of ``vdpp_tpu/utils/memory.py``).

The JAX package reads every device's allocator from its one controller
process, and falls back to XLA's compile-time analysis of a program
(``compiled_memory_analysis``, ``jitted_memory_analysis``,
``StepPipeline.memory_analysis``) where the allocator reports nothing. The
port has a process per rank, so each rank reads its own card:

* :func:`peak_memory_gb` is ``torch.cuda.max_memory_allocated`` of the rank's
  card after :func:`reset_peak_memory` (the rank resets it once its weights
  are loaded, before the warm-up), returned with the rank's result and put in
  rank order by the caller;
* eager PyTorch compiles no program, so the fallback has no counterpart: on
  the CPU a rank reports 0.0 GB and the source ``"unavailable"``, and no
  ``program_memory_gb`` is given;
* :func:`params_bytes_per_device` counts the parameter bytes a rank holds,
  which under FSDP are its shards.
"""

from __future__ import annotations

import torch


def reset_peak_memory(device: torch.device) -> None:
    """Start the rank's peak over from what it holds now."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def peak_memory_gb(device: torch.device) -> float:
    """The most bytes the caching allocator held on ``device`` since the last
    :func:`reset_peak_memory`, in GB (1e9); 0.0 on the CPU."""
    if device.type != "cuda":
        return 0.0
    return torch.cuda.max_memory_allocated(device) / 1e9


def peak_memory_source(device: torch.device) -> str:
    """``"allocator"`` where :func:`peak_memory_gb` reads one, else
    ``"unavailable"``."""
    return "allocator" if device.type == "cuda" else "unavailable"


def bundle_modules(params) -> list[torch.nn.Module]:
    """The modules of a step function's ``params``: the module itself, or the
    module items of a bundle such as ``(unet, conditioning)``."""
    if isinstance(params, torch.nn.Module):
        return [params]
    return [p for p in params if isinstance(p, torch.nn.Module)]


def params_bytes_per_device(params) -> int:
    """Bytes of the parameters this rank holds in ``params`` (a module or a
    bundle): under FSDP its shards, not the gathered tensors a forward
    reads."""
    return sum(p.numel() * p.element_size()
               for m in bundle_modules(params) for p in m.parameters())
