"""The single-device reference run (port of
``vdpp_tpu/parallel/pipeline.py::run_reference_single_device``).

The multi-process step pipeline over NCCL point-to-point is a later slice of
the port; this is the oracle it will be held to: every step of the schedule
run in order on one device.
"""

from __future__ import annotations

from collections.abc import Callable
from typing import Any

import torch

StepFn = Callable[[Any, torch.Tensor, int], torch.Tensor]


def run_reference_single_device(
    step_fn: StepFn, params: Any, inputs: torch.Tensor, total_steps: int
) -> torch.Tensor:
    """Run ``step_fn(params, x, k)`` for ``k = 0 .. total_steps - 1`` on each
    sample of ``inputs`` (leading axis = samples); returns the stacked final
    latents."""
    with torch.inference_mode():
        outs = []
        for x in inputs:
            for k in range(total_steps):
                x = step_fn(params, x, k)
            outs.append(x)
        return torch.stack(outs)
