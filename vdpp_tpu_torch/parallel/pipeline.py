"""The step pipeline, one process per stage (port of
``vdpp_tpu/parallel/pipeline.py``), and the single-device run it is held to.

The JAX package runs the schedule as one SPMD program: a ``shard_map`` over
the ``"stage"`` axis with ``ppermute`` for the hand-off. The port takes the
original system's shape: S processes (``parallel/mesh.py``), rank s holding
the whole model and running steps ``[s*K, (s+1)*K)`` of every sample, then
handing the payload to rank s+1. The schedule is the same:

    tick:      0         1          2        ...
    stage 0:  x0:0..K   x1:0..K    x2:0..K
    stage 1:     -      x0:K..2K   x1:K..2K
    ...
    stage S-1 finishes sample t-(S-1) at tick t;  total ticks = N + S - 1.

A stage with no sample in a fill or drain tick computes nothing; the bubble
fraction is still ``(S-1)/(N+S-1)`` of the stage-ticks. There is no edge
from the last stage back to the first (the JAX ring's wrap-around carries
only data nobody reads). On a (stage, data) mesh each of the D columns runs
this schedule on its own block of N / D samples, as a JAX column does. On a
(stage, seq, frame, cfg) mesh each stage is a block of ranks that run its
steps together (``step_fn`` splits each forward over the block's axes), the
payload the same on every rank of the block, and each rank hands it to its
counterpart in the next stage.
"""

from __future__ import annotations

import time
from collections.abc import Callable
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from vdpp_tpu_torch.parallel.mesh import Stage
from vdpp_tpu_torch.parallel.step_assignment import assign_steps

StepFn = Callable[[Any, torch.Tensor, int], torch.Tensor]


@dataclass(frozen=True)
class PipelineConfig:
    """Static configuration of a step pipeline: uniform splits only
    (``assign_steps`` raises on a bad or non-divisible one)."""

    total_steps: int
    num_stages: int

    def __post_init__(self) -> None:
        assign_steps(self.total_steps, self.num_stages, 0)

    @property
    def steps_per_stage(self) -> int:
        return self.total_steps // self.num_stages

    def num_ticks(self, num_samples: int) -> int:
        return num_samples + self.num_stages - 1

    def bubble_fraction(self, num_samples: int) -> float:
        """Exact fraction of stage-ticks spent in fill and drain."""
        s = self.num_stages
        return (s - 1) / (num_samples + s - 1)


class StepPipeline:
    """The step pipeline as seen from one rank; every rank of the group
    builds one and calls the same method.

    Every stage holds the whole model (``params``, the same on every rank)
    and runs ``step_fn(params, payload, step)`` for its contiguous slice of
    steps. ``inputs`` is ``(N, *payload)`` on every rank: stage 0 ingests its
    samples, and the other stages size their receive buffers from its shape
    and dtype (a solver whose state rides the payload, such as dpmpp2m's 8
    channels, has a payload wider than the latent).

    ``param_spec``: how ``params`` are laid out over the stage's inner axes,
    where the JAX package takes a ``PartitionSpec`` tree: a function
    ``(params, stage) -> params`` that leaves this rank its share (for
    expert parallelism ``ops.moe.expert_layout``, this rank's experts), run
    by :meth:`layout` before every run. None keeps ``params`` whole on every
    rank.
    """

    def __init__(self, stage: Stage, step_fn: StepFn, config: PipelineConfig,
                 param_spec: Callable[[Any, Stage], Any] | None = None):
        if param_spec is not None and not callable(param_spec):
            raise TypeError("param_spec must be a function (params, stage) -> params, such as "
                            "vdpp_tpu_torch.ops.moe.expert_layout")
        if stage.num_stages != config.num_stages:
            raise ValueError(f"mesh stage axis ({stage.num_stages}) != config.num_stages "
                             f"({config.num_stages})")
        # A step_fn whose full and cache steps make different collectives
        # (DeepCache over a seq or frame axis) declares its cadence: every
        # rank must then take the same branch at every tick, which holds at
        # one stage, or when each stage's steps start on the cadence and no
        # identity step shifts them. The reference refuses the rest, since
        # there they deadlock; the port refuses them alike.
        interval = getattr(step_fn, "collective_uniform_interval", 0)
        if interval and config.num_stages > 1:
            pad = getattr(step_fn, "collective_uniform_pad", 0)
            if pad or config.steps_per_stage % interval:
                raise ValueError(
                    f"step_fn declares branch-local collectives with cadence {interval} "
                    f"(deepcache x intra-sample axis): pipelining needs steps_per_stage "
                    f"({config.steps_per_stage}) % interval == 0 and an unpadded schedule "
                    f"(pad={pad}), or stages take different cond branches in the same tick and "
                    f"the branch collectives deadlock. Pick num_stages so "
                    f"total_steps/num_stages is a multiple of {interval}.")
        self.stage = stage
        self.step_fn = step_fn
        self.config = config
        self.param_spec = param_spec

    def layout(self, params):
        """``params`` laid out by ``param_spec`` for this rank (in place, so a
        caller may do it before moving the modules to the card, which then
        never holds what the rank drops)."""
        return params if self.param_spec is None else self.param_spec(params, self.stage)

    def _tick(self, params, inputs: torch.Tensor, t: int,
              x: torch.Tensor | None) -> tuple[torch.Tensor | None, torch.Tensor | None]:
        """Tick ``t`` on this rank, holding ``x`` (the payload received in the
        previous tick). Returns the payload received in this tick and, on the
        last stage, the sample it finished (else None)."""
        s, S, N = self.stage.index, self.config.num_stages, len(inputs)
        K = self.config.steps_per_stage
        active = 0 <= t - s < N
        if active:
            if s == 0:
                x = inputs[t].to(self.stage.device)
            for k in range(s * K, (s + 1) * K):
                x = self.step_fn(params, x, k)
            if x.shape != inputs.shape[1:] or x.dtype != inputs.dtype:
                raise ValueError(f"step_fn returned a {tuple(x.shape)} {x.dtype} payload for a "
                                 f"{tuple(inputs.shape[1:])} {inputs.dtype} one")
        receives = s > 0 and 0 <= t - (s - 1) < N
        nxt = self.stage.handoff(x if active and s < S - 1 else None,
                                 inputs[0] if receives else None)
        return nxt, (x if active and s == S - 1 else None)

    def run(self, params, inputs: torch.Tensor) -> torch.Tensor | None:
        """Pipeline ``inputs (N, *payload)`` through all ``total_steps``.
        Returns the finished ``(N, *payload)`` on the ranks of the last stage
        (on their devices) and None on the others. On a (stage, data) mesh each column
        pipelines its block of N / D samples (:meth:`Stage.column_shard`) and
        returns them on its last stage."""
        params = self.layout(params)
        inputs = self.stage.column_shard(inputs)
        outputs, x = [], None
        with torch.inference_mode():
            for t in range(self.config.num_ticks(len(inputs))):
                x, done = self._tick(params, inputs, t, x)
                if done is not None:
                    outputs.append(done)
        if self.stage.device.type == "cuda":  # the last send lands before the rank moves on
            torch.cuda.synchronize(self.stage.device)
        return torch.stack(outputs) if self.stage.is_last else None

    def run_ticked(self, params, inputs: torch.Tensor, on_sample=None, start_tick: int = 0,
                   initial_buf=None, on_tick=None, on_tick_every: int = 1):
        """Host-stepped run: every rank advances one tick at a time, with a
        barrier at the end of each (after its device work has finished).

        Returns ``(outputs, tick_seconds)`` on the ranks of the last stage
        and None on the others: ``outputs`` stacks the samples that finish at ticks >=
        ``max(start_tick, S - 1)`` (all N from tick 0; sample i finishes at
        tick i + S - 1), and ``tick_seconds`` has ``num_ticks(N) -
        start_tick`` entries. ``on_sample(i, latent)`` fires on the last stage's
        ranks, in order, the moment sample ``i`` finishes. On a (stage, data) mesh
        each column runs its block of N / D samples, ``i`` counting within
        it, and the barrier spans every column.

        Snapshot and resume (``utils/resume.py``), on a stage mesh, with or
        without intra-sample axes (not on a (stage, data) mesh). The
        state after tick t is the JAX package's ring ``buf (S, *payload)``:
        slot s >= 1 is the payload stage s steps at tick t + 1 (what rank s
        received in tick t, sample t + 1 - s), written as zeros unless 0 <= t
        + 1 - s < N; slot 0 is zeros (the JAX ring's last-to-first edge
        carries nothing that is read, and is not ported). ``on_tick(t, buf)``
        fires on the last rank with ``buf`` on the CPU after every tick t
        with ``(t + 1) % on_tick_every == 0``; the first rank of each stage
        sends its slot there then (a stage's ranks hold the same payload).
        The gather is collective, so every rank must know which
        ticks gather: that is what ``on_tick_every`` (not in the JAX
        package, whose ring is one array) says, so that a large payload
        (593.5 MB a slot under DeepCache at SVD-XT) crosses only on the ticks
        that are kept. ``start_tick``/``initial_buf`` resume after a
        snapshot: every rank takes its own slot of ``initial_buf`` (numpy or
        torch, ``(S, *payload)``; zeros when None), and a resume at or past
        the last tick returns an empty ``(0, *payload)`` and ``[]``; every
        rank of stage s takes slot s.
        ``self.gather_seconds`` then holds this rank's host seconds of each
        gather (outside ``tick_seconds``; the last rank's include the wait
        for every send).
        """
        resuming = start_tick or initial_buf is not None or on_tick is not None
        if resuming and self.stage.mesh.num_data > 1:
            raise NotImplementedError("start_tick, initial_buf and on_tick drive the stage "
                                      "mesh; a (stage, data) mesh runs without them, as the "
                                      "JAX package's run_ticked refuses a data axis")
        if on_tick_every < 1:
            raise ValueError(f"on_tick_every must be >= 1, got {on_tick_every}")
        params = self.layout(params)
        inputs = self.stage.column_shard(inputs)
        s, S, N = self.stage.index, self.config.num_stages, len(inputs)
        payload = tuple(inputs.shape[1:])
        dev = self.stage.device
        x = None
        if initial_buf is not None and tuple(initial_buf.shape) != (S, *payload):
            raise ValueError(f"initial_buf shape {tuple(initial_buf.shape)} != {(S, *payload)}")
        if s > 0 and 0 <= start_tick - s < N:  # this rank steps a sample at start_tick
            slot = (torch.zeros(payload, dtype=inputs.dtype) if initial_buf is None
                    else initial_buf[s])
            if not isinstance(slot, torch.Tensor):
                slot = torch.from_numpy(np.array(slot))
            x = slot.to(dev, inputs.dtype)
        outputs, ticks = [], []
        self.gather_seconds = []
        with torch.inference_mode():
            for t in range(start_tick, self.config.num_ticks(N)):
                t0 = time.perf_counter()
                x, done = self._tick(params, inputs, t, x)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                self.stage.barrier()
                ticks.append(time.perf_counter() - t0)
                if done is not None:
                    outputs.append(done)
                    if on_sample is not None:
                        on_sample(t - (S - 1), done)
                if on_tick is not None and (t + 1) % on_tick_every == 0:
                    # x: what this rank received in tick t, None unless sample t + 1 - s
                    # exists (and always on rank 0)
                    slot = x if x is not None else torch.zeros(payload, dtype=inputs.dtype,
                                                               device=dev)
                    t1 = time.perf_counter()
                    buf = self.stage.gather_to_last(slot)
                    self.gather_seconds.append(time.perf_counter() - t1)
                    if buf is not None:
                        on_tick(t, buf)
        if not self.stage.is_last:
            return None
        if not outputs:  # a resume at or past the last tick: nothing is left
            return torch.zeros((0, *payload), dtype=inputs.dtype), ticks
        return torch.stack(outputs), ticks

    def stream(self, params, latent_shape: tuple, dtype=torch.float32):
        """The streaming executor for serving is not ported."""
        raise NotImplementedError("PipelineStream comes with serving (ROADMAP A16)")


def run_reference_single_device(
    step_fn: StepFn, params: Any, inputs: torch.Tensor, total_steps: int
) -> torch.Tensor:
    """Run ``step_fn(params, x, k)`` for ``k = 0 .. total_steps - 1`` on each
    sample of ``inputs`` (leading axis = samples); returns the stacked final
    latents. The oracle every pipelined run must equal."""
    with torch.inference_mode():
        outs = []
        for x in inputs:
            for k in range(total_steps):
                x = step_fn(params, x, k)
            outs.append(x)
        return torch.stack(outs)
