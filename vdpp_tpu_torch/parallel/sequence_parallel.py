"""Sequence (token-axis) parallelism for one sample's latency (port of
``vdpp_tpu/parallel/sequence_parallel.py``).

The step pipeline splits the schedule's steps, so one sample still takes a
whole schedule of wall time. Splitting the DiT's tokens over a ``seq`` axis
runs each step's forwards S ways at once: every rank keeps its slice of the
tokens after the patch embedding, gathers the other ranks' K and V in each
self-attention, and gathers the finished tokens once before the unpatchify
(``DiTVideo.forward(seq_axis=)``). The output is the same on every rank and
equals the unsharded run up to the order of sums.

This runner carries a whole schedule on a mesh of one stage; under the step
pipeline the same step function runs on a (stage, seq) mesh, or (stage, seq,
cfg) (``StepPipeline`` with ``wrapper.pipeline_step_fn(**stage.axes)``).
"""

from __future__ import annotations

import torch

from vdpp_tpu_torch.parallel.mesh import Stage


class SequenceParallelRunner:
    """A DiT's whole schedule with the token axis split over the mesh's
    ``seq`` axis, as one rank sees it (every rank builds one and calls
    :meth:`run`).

    Args:
        stage: this rank's :class:`Stage` of a one-stage mesh with a seq axis
            (a cfg axis beside it runs one CFG branch a rank, as well).
        wrapper: a ``DiTVideoWrapper`` (either attention mode: factorized
            splits each frame's tokens, joint3d all F * N).
    """

    def __init__(self, stage: Stage, wrapper):
        if stage.seq is None:
            raise ValueError("the mesh must have a 'seq' axis")
        if stage.num_stages != 1:
            raise ValueError(f"a one-stage mesh runs the whole schedule, not "
                             f"{stage.num_stages} stages (use StepPipeline)")
        self.stage = stage
        self.wrapper = wrapper
        self.shards = stage.seq.size
        self.step_fn = wrapper.pipeline_step_fn(**stage.axes)

    def run(self, params, latent: torch.Tensor, context=None, guidance=None) -> torch.Tensor:
        """Denoise ``latent (B, F, H, W, C)`` through the wrapper's whole
        schedule; returns the finished latent, the same on every rank."""
        x = latent.to(self.stage.device)
        with torch.inference_mode():
            for k in range(self.wrapper.schedule.num_steps):
                x = self.step_fn((params, context, guidance), x, k)
        return x
