"""Reference-API compatibility layer (port of ``vdpp_tpu/compat.py``).

Thin adapters under the original system's names and call shapes, so that
code written against it maps one to one: ``LatentSpec``, ``resolve_backend``,
``run_single_latent`` and ``run_pipeline_latents``. The pipelined runs go
through the port's :class:`~vdpp_tpu_torch.parallel.pipeline.StepPipeline`,
one process per stage (``parallel/mesh.py::run_stages``; one stage runs in
this process), and one call returns the finished latents here, where the
original returned None on every rank but the last.
"""

from __future__ import annotations

import os
from collections.abc import Callable, Sequence
from dataclasses import dataclass
from typing import Any

import torch

from vdpp_tpu_torch.parallel.mesh import Stage, make_pipeline_mesh, run_stages
from vdpp_tpu_torch.parallel.pipeline import PipelineConfig, StepPipeline
from vdpp_tpu_torch.parallel.step_assignment import StepRange, assign_steps  # noqa: F401


@dataclass(frozen=True)
class LatentSpec:
    """Shape and dtype of the pipeline latent. The original sized its
    receive buffers with it; here it is a shape contract and ``empty()``."""

    shape: tuple[int, ...]
    dtype: torch.dtype = torch.float32

    def empty(self) -> torch.Tensor:
        return torch.zeros(self.shape, dtype=self.dtype)


def resolve_backend(preferred: str | None = None, simulator: bool = False) -> str:
    """The original's backend resolution: the explicit argument, else
    ``VDPP_BACKEND``, else ``"cpu"`` for the simulator and ``"cuda"``
    otherwise. The JAX package resolves to ``cpu`` or ``tpu``; the port's
    devices are ``cpu`` and ``cuda``, so its ``tpu`` maps to the port's
    ``cuda``, and ``tpu`` itself is refused."""
    backend = preferred or os.environ.get("VDPP_BACKEND")
    if backend is None:
        backend = "cpu" if simulator else "cuda"
    if backend not in ("cpu", "cuda"):
        raise ValueError(f"unsupported backend {backend!r} (cpu|cuda; the JAX package's tpu is "
                         "this package's cuda)")
    return backend


class TimestepMapped:
    """``model(params, latent, timesteps[step])``: a step function that feeds
    the model custom step values (a class, not a closure, so that it pickles
    into spawned ranks)."""

    def __init__(self, model: Callable, timesteps: Sequence[int]):
        self.model = model
        self.timesteps = list(timesteps)

    def __call__(self, params, latent: torch.Tensor, step: int) -> torch.Tensor:
        return self.model(params, latent, self.timesteps[step])


def _pipeline_rank(stage: Stage, step_fn: Callable, params: Any, total_steps: int,
                   inputs: torch.Tensor) -> torch.Tensor | None:
    pipe = StepPipeline(stage, step_fn, PipelineConfig(total_steps, stage.num_stages))
    out = pipe.run(params, inputs)
    return None if out is None else out.cpu()


def run_single_latent(model: Callable[[Any, torch.Tensor, int], torch.Tensor], *, params: Any,
                      total_steps: int, world_size: int, input_latent: torch.Tensor,
                      timesteps: Sequence[int] | None = None,
                      device: str | torch.device | None = None) -> torch.Tensor:
    """One latent through the whole schedule on a ``world_size``-stage
    pipeline. ``model`` is a ``step_fn(params, latent, step)``; ``timesteps``
    feeds it custom (say descending) step values. ``device``: ``"cuda"`` (the
    default) or ``"cpu"``."""
    return run_pipeline_latents(model, params=params, total_steps=total_steps,
                                world_size=world_size, num_samples=1,
                                input_supplier=lambda i: input_latent, timesteps=timesteps,
                                device=device)[0]


def run_pipeline_latents(model: Callable[[Any, torch.Tensor, int], torch.Tensor], *,
                         params: Any, total_steps: int, world_size: int, num_samples: int,
                         input_supplier: Callable[[int], torch.Tensor],
                         timesteps: Sequence[int] | None = None,
                         device: str | torch.device | None = None) -> torch.Tensor:
    """Several samples pipelined over ``world_size`` stages; returns the
    finished latents ``(num_samples, *latent)`` (on the CPU when the stages
    ran in their own processes). ``model`` and ``params`` go to each spawned
    rank by pickling: ``model`` must be a module-level function or a
    picklable object."""
    if num_samples <= 0:
        raise ValueError("num_samples must be positive for pipeline execution")
    step_fn = model if timesteps is None else TimestepMapped(model, timesteps)
    mesh = make_pipeline_mesh(world_size, device=device)
    inputs = torch.stack([input_supplier(i) for i in range(num_samples)])
    if mesh.world_size == 1:
        return StepPipeline(Stage(mesh, 0), step_fn, PipelineConfig(total_steps, 1)).run(
            params, inputs)
    return run_stages(mesh, _pipeline_rank, step_fn, params, total_steps, inputs)[-1]
