"""Classifier-free-guidance (branch-axis) parallelism (port of
``vdpp_tpu/parallel/cfg_parallel.py``).

A CFG step runs the UNet twice, once with zeroed conditioning and once
conditioned; only the outputs meet, in the guidance blend. On a size-2
``cfg`` axis the two branches run on two ranks at once, and one swap of the
outputs gives both ranks the same blend: a step costs one forward of wall
time and a latent-sized exchange. The branch choice and the swap live in the
wrapper (``StableVideoUNet.noise_pred(cfg_axis=...)``); this runner carries a
whole schedule on a mesh of one stage. Under the step pipeline the same
step function runs on a (stage, cfg) mesh, or (stage, seq, cfg), and so on.

The output equals the sequential-CFG single-device run: both ranks blend the
same two outputs, each computed as the sequential run computes it.
"""

from __future__ import annotations

import torch

from vdpp_tpu_torch.parallel.mesh import Stage


class CFGParallelRunner:
    """A whole schedule on a mesh of one stage with a size-2 cfg axis, as
    one rank sees it (every rank builds one and calls :meth:`run`).

    Args:
        stage: this rank's :class:`Stage` of a mesh with a cfg axis of 2.
        step_fn: a cfg-aware ``step_fn(bundle, latent, step)`` (a wrapper's
            ``pipeline_step_fn(**stage.axes)``).
        total_steps: the schedule's length.
    """

    def __init__(self, stage: Stage, step_fn, total_steps: int):
        if stage.cfg is None:
            raise ValueError("the mesh must have a 'cfg' axis")
        if stage.cfg.size != 2:
            raise ValueError("the cfg axis has exactly 2 branches (uncond, cond)")
        if stage.num_stages != 1:
            raise ValueError(f"a one-stage mesh runs the whole schedule, not "
                             f"{stage.num_stages} stages (use StepPipeline)")
        self.stage = stage
        self.step_fn = step_fn
        self.total_steps = total_steps

    def run(self, bundle, latent: torch.Tensor) -> torch.Tensor:
        """Denoise ``latent`` through every step; returns the finished
        latent, the same on both ranks."""
        x = latent.to(self.stage.device)
        with torch.inference_mode():
            for k in range(self.total_steps):
                x = self.step_fn(bundle, x, k)
        return x
