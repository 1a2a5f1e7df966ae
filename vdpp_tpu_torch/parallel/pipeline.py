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

Serving streams the same tick: :class:`StreamRanks` keeps the ranks alive,
idle on their command pipes, and a controller thread in the serving process
sends every tick's plan (which sample each stage steps, stage 0's fresh
latent); the last stage sends each finished latent back over its pipe
(:class:`PipelineStream`).
"""

from __future__ import annotations

import contextlib
import os
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
        s, N = self.stage.index, len(inputs)
        active = 0 <= t - s < N
        if active and s == 0:
            x = inputs[t].to(self.stage.device)
        receives = s > 0 and 0 <= t - (s - 1) < N
        return self._advance(params, x if active else None, inputs[0],
                             inputs[0] if receives else None)

    def _advance(self, params, x: torch.Tensor | None, like: torch.Tensor,
                 recv_like: torch.Tensor | None):
        """The tick body: this stage's steps on ``x`` (None: this rank is idle
        in this tick), which must keep ``like``'s shape and dtype, handed to
        the next stage, and a payload of ``recv_like``'s shape and dtype (None:
        nothing) received from the previous one. Returns the received payload
        and, on the last stage, the finished sample (else None)."""
        s, S = self.stage.index, self.config.num_stages
        K = self.config.steps_per_stage
        if x is not None:
            for k in range(s * K, (s + 1) * K):
                x = self.step_fn(params, x, k)
            if x.shape != like.shape or x.dtype != like.dtype:
                raise ValueError(f"step_fn returned a {tuple(x.shape)} {x.dtype} payload for a "
                                 f"{tuple(like.shape)} {like.dtype} one")
        nxt = self.stage.handoff(x if x is not None and s < S - 1 else None, recv_like)
        return nxt, (x if x is not None and s == S - 1 else None)

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

    def stream(self, params, latent_shape: tuple, dtype=torch.float32) -> PipelineStream:
        """Open a streaming executor on a one-rank mesh, in this process:
        ``submit(latent) -> Future``. Requests arriving over time keep the
        pipeline filled, all sharing ``params`` (the (weights, conditioning)
        bundle). The stages of a mesh of several ranks stream through
        :class:`StreamRanks`, which starts their processes."""
        if self.stage.mesh.world_size != 1:
            raise ValueError("StepPipeline.stream runs a one-rank pipeline in this process; the "
                             "ranks of a larger mesh stream through StreamRanks")
        worker = _StreamWorker(self.stage, StreamJob(self.step_fn, self.config.total_steps),
                               pipe=self)
        controller = _StreamController(self.config.num_stages, [0], [])
        controller.transport = _LocalTransport(worker, controller.on_message)
        return controller.open(params, latent_shape, dtype, owner=True)


# ---- streaming: requests that arrive over time share one filled pipeline ---- #


@dataclass
class StreamJob:
    """What one rank of a stream serves, built on the rank.

    ``step_fn`` and ``total_steps`` are the pipeline's. ``bundle(payload)``
    turns a stream's conditioning payload (sent once per stream, CPU
    tensors) into the ``params`` ``step_fn`` takes on this rank; by default
    the payload is the bundle. ``pack`` and ``unpack`` attach and strip the
    solver's cross-step state (a wrapper's ``pack_initial`` and
    ``unpack_final``): only latents cross to and from the stream, the packed
    payload stays on the ranks. ``decode(latent, stage, uint8)`` runs on the
    decode ranks of a mesh that has them and gives the frames on decode rank
    0 (None on the others)."""

    step_fn: StepFn | None = None
    total_steps: int = 0
    bundle: Callable[[Any], Any] | None = None
    pack: Callable[[torch.Tensor], torch.Tensor] | None = None
    unpack: Callable[[torch.Tensor], torch.Tensor] | None = None
    decode: Callable[..., Any] | None = None


class _StreamWorker:
    """One rank's side of a stream: executes the controller's commands in order
    and returns the messages they produce.

    * ``("cond", cid, payload, latent_shape, dtype)``: keep stream ``cid``'s
      bundle (and its payload's shape, from ``pack`` on the meta device);
      ``("drop", cid)`` forgets it;
    * ``("tick", t, slots, fresh)``: ``slots[s]`` is ``(rid, cid, decode)``
      of the sample stage s steps in tick t, or None; stage 0 packs ``fresh``,
      the request's latent. Every stage rank answers ``("tick", t)``; the
      last stage rank also ``("done", rid, latent)``, and where ``decode`` is
      set the decode sender posts the latent to the decode ranks;
    * ``("decode", rid, shape, uint8)`` on a decode rank: receive that sample
      from the decode sender and decode it; decode rank 0 answers
      ``("frames", rid, frames)``;
    * ``("mark",)`` and ``("launches",)``: the kernel launches since the
      mark and the device's allocator peak, answered as ``("launches",
      counts, peak GB)``.
    """

    def __init__(self, stage: Stage, job: StreamJob, pipe: StepPipeline | None = None):
        from vdpp_tpu_torch.utils.kernels import launch_counts

        self.stage = stage
        self.job = job
        if pipe is None and not stage.is_decode:
            pipe = StepPipeline(stage, job.step_fn,
                                PipelineConfig(job.total_steps, stage.num_stages))
        self.pipe = pipe
        self.bundles: dict[int, tuple[Any, torch.Tensor]] = {}
        self.held: torch.Tensor | None = None  # the payload received in the last tick
        self.sends: list = []  # posts to the decode ranks still in flight
        self.mark = launch_counts()

    def handle(self, cmd: tuple) -> list[tuple]:
        from vdpp_tpu_torch.utils.kernels import launch_counts, launches_since
        from vdpp_tpu_torch.utils.memory import peak_memory_gb

        kind = cmd[0]
        if kind == "cond":
            _, cid, payload, shape, dtype = cmd
            params = payload if self.job.bundle is None else self.job.bundle(payload)
            like = torch.empty(shape, dtype=dtype, device="meta")
            self.bundles[cid] = (self.pipe.layout(params), self._pack(like))
            return []
        if kind == "drop":
            self.bundles.pop(cmd[1], None)
            return []
        if kind == "tick":
            return self._tick(*cmd[1:])
        if kind == "decode":
            return self._decode(*cmd[1:])
        if kind == "mark":
            self.mark = launch_counts()
            return []
        if kind == "launches":
            return [("launches", launches_since(self.mark), peak_memory_gb(self.stage.device))]
        raise ValueError(f"unknown stream command {kind!r}")

    def _pack(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.job.pack is None else self.job.pack(x)

    def _tick(self, t: int, slots: tuple, fresh: torch.Tensor | None) -> list[tuple]:
        stage = self.stage
        s = stage.index
        mine = slots[s]
        params = x = None
        like = recv_like = None
        if s > 0 and slots[s - 1] is not None:
            recv_like = self.bundles[slots[s - 1][1]][1]
        with torch.inference_mode():
            if mine is not None:
                params, like = self.bundles[mine[1]]
                x = (self._pack(fresh.to(stage.device, like.dtype)) if s == 0
                     else self.held)
            self.held, done = self.pipe._advance(params, x, like, recv_like)
        if stage.device.type == "cuda":
            torch.cuda.synchronize(stage.device)
        out = [("tick", t)]
        if done is not None:
            latent = done if self.job.unpack is None else self.job.unpack(done)
            if mine[2] and stage.is_decode_sender:
                self.sends = [(w, buf) for w, buf in self.sends if not w.is_completed()]
                self.sends += stage.send_to_decode(latent)
            if stage.is_last_rank:
                out.append(("done", mine[0], latent))
        return out

    def _decode(self, rid: int, shape: tuple, uint8: bool) -> list[tuple]:
        latent = self.stage.receive_sample(torch.empty(shape, dtype=torch.float32))
        with torch.inference_mode():
            frames = self.job.decode(latent, self.stage, uint8)
        return [] if frames is None else [("frames", rid, frames)]

    def finish(self) -> None:
        """Wait for the posts to the decode ranks still in flight."""
        for work, _ in self.sends:
            work.wait()
        self.sends = []


def _cpu(msg: tuple) -> tuple:
    return tuple(v.detach().cpu() if isinstance(v, torch.Tensor) else v for v in msg)


def stream_rank(stage: Stage, channel, build: Callable[..., StreamJob], build_args: tuple,
                poll_seconds: float = 5.0) -> None:
    """A rank of :class:`StreamRanks` (run by ``parallel/mesh.py``'s
    :class:`~vdpp_tpu_torch.parallel.mesh.RankGroup`): builds its
    :class:`StreamJob` with ``build(stage, *build_args)``, says ``("ready",)``
    and then executes the commands on its channel until ``("stop",)``. While
    idle it waits on the channel alone, ``poll_seconds`` at a time, and
    leaves when its parent is gone."""
    parent = os.getppid()
    worker = _StreamWorker(stage, build(stage, *build_args))
    channel.send(("ready",))
    while True:
        while not channel.poll(poll_seconds):
            if os.getppid() != parent:
                return
        cmd = channel.recv()
        if cmd[0] == "stop":
            worker.finish()
            return
        for msg in worker.handle(cmd):
            channel.send(_cpu(msg))


class _LocalTransport:
    """A one-rank stream's rank, in this process: a command runs at once on
    the calling thread (one at a time) and its messages go to
    ``on_message``; an exception becomes the rank's ``("error", exc)``."""

    def __init__(self, worker: _StreamWorker, on_message):
        import threading

        self.worker = worker
        self.on_message = on_message
        self._lock = threading.Lock()

    def send(self, rank: int, cmd: tuple) -> None:
        with self._lock:
            try:
                msgs = self.worker.handle(cmd)
            except Exception as e:  # noqa: BLE001 - the controller fails its waiters with it
                msgs = [("error", e)]
        for msg in msgs:
            self.on_message(0, msg)

    def close(self) -> None:
        self.worker.finish()


@dataclass
class _Entry:
    rid: int
    cid: int
    latent: torch.Tensor
    future: Any
    decode: bool | None  # None: no decode; else whether to return uint8 frames
    frames: Any = None  # the decoded frames' Future, with decode


class _StreamController:
    """The single controller of a stream's ranks: a thread that ticks
    whenever work is in flight. Each tick it sends every stage rank the same
    command: which sample each stage steps (stage 0 ingests the oldest queued
    request, or idles), and the fresh latent to stage 0's ranks; a sample
    ingested at tick t finishes at tick t + S - 1. It counts a tick when every
    stage rank has acknowledged it, then resolves the finished sample's
    future. Once no real sample is in transit it stops ticking. A failure of
    any rank fails every waiter and poisons every stream of the controller."""

    def __init__(self, num_stages: int, stage_ranks: list[int], decode_ranks: list[int],
                 first_stage_ranks: list[int] | None = None, on_failure=None):
        import collections
        import queue
        import threading

        self.transport = None
        self.num_stages = num_stages
        self.stage_ranks = stage_ranks
        self.first_stage_ranks = first_stage_ranks or stage_ranks[:1]
        self.decode_ranks = decode_ranks
        self.on_failure = on_failure
        self.ticks_run = 0
        # host seconds of each tick, from its commands to the last answer
        self.tick_seconds = collections.deque(maxlen=4096)
        self.failure: BaseException | None = None
        self._queue: collections.deque[_Entry] = collections.deque()
        self._in_flight: list[_Entry | None] = []
        self._frames: dict[int, Any] = {}
        self._released: set[int] = set()
        self._live: dict[int, int] = {}  # cid -> samples queued or in flight
        self._acks = queue.SimpleQueue()
        self._cv = threading.Condition()
        self._stopped = False
        self._next_rid = 0
        self._next_cid = 0
        self._thread = threading.Thread(target=self._run_ticks, daemon=True)
        self._thread.start()

    # -- from the streams' threads ------------------------------------- #

    def open(self, payload, latent_shape: tuple, dtype, owner: bool = False) -> PipelineStream:
        """Send ``payload`` (the stream's conditioning) to every stage rank
        under a new stream id and return the stream."""
        with self._cv:
            self._raise_if_unusable()
            cid = self._next_cid
            self._next_cid += 1
        for r in self.stage_ranks:
            self.transport.send(r, ("cond", cid, payload, tuple(latent_shape), dtype))
        return PipelineStream(self, cid, latent_shape, dtype, owner)

    def _raise_if_unusable(self) -> None:
        if self._stopped or self.failure is not None:
            raise RuntimeError("stream is closed" if self.failure is None
                               else f"stream failed: {self.failure!r}")

    def enqueue(self, cid: int, latent: torch.Tensor, decode: bool | None):
        from concurrent.futures import Future

        if decode is not None and not self.decode_ranks:
            raise ValueError("the mesh has no decode ranks")
        fut: Future = Future()
        # Check and enqueue under the lock: a submit racing a failure's drain
        # could otherwise slip in after it and never complete.
        with self._cv:
            self._raise_if_unusable()
            entry = _Entry(self._next_rid, cid, latent, fut, decode)
            self._next_rid += 1
            if decode is not None:
                entry.frames = Future()
                self._frames[entry.rid] = entry.frames
            self._queue.append(entry)
            self._live[cid] = self._live.get(cid, 0) + 1
            self._cv.notify_all()
        return entry

    def release(self, cid: int) -> None:
        """Stream ``cid`` takes no more samples: its ranks forget it once its
        samples are done."""
        with self._cv:
            self._released.add(cid)
            self._cv.notify_all()

    def on_message(self, rank: int, msg: tuple) -> None:
        kind = msg[0]
        if kind in ("tick", "done"):
            self._acks.put((rank, msg))
        elif kind == "frames":
            with self._cv:
                fut = self._frames.pop(msg[1], None)
            if fut is not None and not fut.done():
                fut.set_result(msg[2])
        elif kind in ("error", "exit"):
            err = msg[1]
            if kind == "exit":
                if self._stopped:
                    return  # a rank leaving after a stop
                err = RuntimeError(f"stream rank {rank} exited with code {err}")
            elif not isinstance(err, BaseException):
                err = RuntimeError(f"stream rank {rank} failed:\n{err}")
            self._fail(err)
            self._acks.put((rank, ("failed",)))

    def close(self, timeout: float = 60.0) -> None:
        """Refuse new samples, finish the ones submitted, stop the thread."""
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        self._thread.join(timeout=timeout)

    # -- the controller thread --------------------------------------------- #

    def _fail(self, err: BaseException) -> None:
        """Poison the controller: every queued waiter and every decode waiter
        fails with ``err`` (the in-flight ones when the controller thread sees
        it)."""
        with self._cv:
            if self.failure is not None:
                return
            self.failure = err
            self._stopped = True
            waiters = [e.future for e in self._queue] + list(self._frames.values())
            self._queue.clear()
            self._frames.clear()
            self._cv.notify_all()
        for f in waiters:
            if not f.done():
                f.set_exception(err)
        if self.on_failure is not None:
            self.on_failure(err)

    def _work_remains(self) -> bool:
        return bool(self._queue) or any(e is not None for e in self._in_flight)

    def _drop_released(self) -> None:
        with self._cv:
            gone = [c for c in self._released if not self._live.get(c)]
            self._released.difference_update(gone)
            for cid in gone:
                self._live.pop(cid, None)
        for cid in gone:
            for r in self.stage_ranks:
                self.transport.send(r, ("drop", cid))

    def _run_ticks(self) -> None:
        import time
        from concurrent.futures import InvalidStateError

        S = self.num_stages
        while True:
            with self._cv:
                self._cv.wait_for(lambda: self._stopped or self._work_remains()
                                  or bool(self._released))
                if self.failure is not None or (self._stopped and not self._work_remains()):
                    break
                entry = self._queue.popleft() if self._queue else None
            try:
                if self._released:
                    self._drop_released()
                if entry is None and not any(e is not None for e in self._in_flight):
                    continue  # woken for a release only
                self._in_flight.append(entry)
                n = len(self._in_flight)
                slots = tuple(None if s >= n or self._in_flight[n - 1 - s] is None else
                              (self._in_flight[n - 1 - s].rid, self._in_flight[n - 1 - s].cid,
                               self._in_flight[n - 1 - s].decode is not None)
                              for s in range(S))
                t0 = time.perf_counter()
                t = self.ticks_run
                for r in self.stage_ranks:
                    fresh = entry.latent if entry is not None and r in self.first_stage_ranks \
                        else None
                    self.transport.send(r, ("tick", t, slots, fresh))
                last = self._in_flight[0] if n >= S else None
                if last is not None and last.decode is not None:
                    for r in self.decode_ranks:
                        self.transport.send(r, ("decode", last.rid, tuple(last.latent.shape),
                                                last.decode))
                latent = self._wait_tick(t, last)
                self.tick_seconds.append(time.perf_counter() - t0)
                self.ticks_run += 1
                if n >= S:
                    done = self._in_flight.pop(0)
                    if done is not None:
                        with self._cv:
                            self._live[done.cid] -= 1
                        # A client may have cancelled its future meanwhile: that
                        # must not read as a tick failure.
                        try:
                            done.future.set_result(latent)
                        except InvalidStateError:
                            pass
                # Once no real sample is in transit, stop burning idle ticks (a
                # sample ingested later still finishes S ticks on).
                if all(e is None for e in self._in_flight):
                    self._in_flight.clear()
            except Exception as e:  # noqa: BLE001 - a failed tick poisons the stream
                self._fail(e)
                break
        err = self.failure
        if err is not None:
            for e in [entry, *self._in_flight]:
                if e is not None and not e.future.done():
                    e.future.set_exception(err)
            self._in_flight.clear()

    def _wait_tick(self, t: int, last: _Entry | None):
        """Every stage rank's acknowledgement of tick ``t`` and, where a
        sample finishes, its latent; raises the failure of a rank."""
        acks, latent = set(), None
        while len(acks) < len(self.stage_ranks) or (last is not None and latent is None):
            rank, msg = self._acks.get()
            if msg[0] == "failed":
                raise self.failure
            if msg[0] == "tick" and msg[1] == t:
                acks.add(rank)
            elif msg[0] == "done" and last is not None and msg[1] == last.rid:
                latent = msg[2]
        return latent


class PipelineStream:
    """A streaming executor over one filled step pipeline (port of
    ``vdpp_tpu/parallel/pipeline.py::PipelineStream``): ``submit(latent)``
    returns a ``concurrent.futures.Future`` of the finished latent.

    A controller thread in this process ticks the pipeline whenever work is in
    flight: at each tick stage 0 ingests the oldest queued request (or
    idles), every stage steps its resident sample through its slice of the
    steps, and the last stage finishes the request ingested S - 1 ticks
    earlier. Overlapping requests share the pipeline: one submitted during
    another's transit finishes one tick after it, not S ticks later. A
    stream is one conditioning bundle on a controller that several streams may
    share (:class:`StreamRanks`: the stage ranks hold every open stream's
    bundle, and samples of different streams share ticks). ``ticks_run``
    counts the controller's ticks, idle ones included.
    """

    def __init__(self, controller: _StreamController, cid: int, latent_shape: tuple, dtype,
                 owner: bool = False):
        self._controller = controller
        self.cid = cid
        self.latent_shape = tuple(latent_shape)
        self.dtype = dtype
        self._owner = owner
        self._closed = False

    @property
    def ticks_run(self) -> int:
        return self._controller.ticks_run

    @property
    def unusable(self) -> bool:
        """True once the stream can never accept another submit (closed, or
        a failure poisoned it): a cache of streams must evict it."""
        return self._closed or self._controller.failure is not None or self._controller._stopped

    def _check(self, latent: torch.Tensor) -> torch.Tensor:
        if self.unusable:
            self._controller._raise_if_unusable()
            raise RuntimeError("stream is closed")
        if tuple(latent.shape) != self.latent_shape:
            raise ValueError(f"latent shape {tuple(latent.shape)} != stream shape "
                             f"{self.latent_shape}")
        if latent.dtype != self.dtype:
            raise ValueError(f"latent dtype {latent.dtype} != stream dtype {self.dtype}")
        return latent if isinstance(self._controller.transport, _LocalTransport) \
            else latent.detach().cpu()

    def submit(self, latent: torch.Tensor):
        """Enqueue one sample ``(*latent_shape)``; returns a Future of the
        finished latent (on the stage's device in this process, else on the
        CPU)."""
        return self._controller.enqueue(self.cid, self._check(latent), None).future

    def submit_decoded(self, latent: torch.Tensor, uint8: bool = False):
        """As :meth:`submit`, on a mesh with decode ranks: the finished latent
        goes on to the decode ranks, and the Future gives the decoded frames
        from decode rank 0 (``uint8``: the frames as bytes)."""
        return self._controller.enqueue(self.cid, self._check(latent), bool(uint8)).frames

    def close(self) -> None:
        """Take no more samples; the ones submitted still finish."""
        if self._closed:
            return
        self._closed = True
        self._controller.release(self.cid)
        if self._owner:
            self._controller.close()


class StreamRanks:
    """The ranks of ``mesh`` serving streams: started once (each rank builds
    its :class:`StreamJob` with ``build(stage, *args)``, a module-level
    function, and loads its model once), kept alive and idle between
    requests, with one controller (:class:`PipelineStream`) over all of them.
    :meth:`stream` opens a stream for a conditioning payload, sent to the
    stage ranks once. A one-rank mesh runs in this process with no process
    group; a larger one spawns its ranks (``parallel/mesh.py::RankGroup``).

    A rank that fails sends its traceback: every waiter fails with it, every
    stream turns ``unusable``, and the ranks are stopped (:attr:`failed`):
    a server starts a new group.
    """

    def __init__(self, mesh, build: Callable[..., StreamJob], *args: Any,
                 threads: int | None = None, poll_seconds: float = 5.0):
        import queue

        from vdpp_tpu_torch.parallel.mesh import RankGroup

        self.mesh = mesh
        g = mesh.group_size
        stage_ranks = list(range(mesh.stage_ranks))
        self.controller = _StreamController(mesh.num_stages, stage_ranks,
                                    list(range(mesh.stage_ranks, mesh.world_size)),
                                    stage_ranks[:g], on_failure=self._on_failure)
        if mesh.num_data > 1:
            raise ValueError("a stream runs on a stage mesh (with intra-sample axes and decode "
                             "ranks), not on a (stage, data) mesh")
        self._startup = queue.SimpleQueue()
        self._launches = queue.SimpleQueue()
        self._group = None
        self._started = False
        if mesh.world_size == 1:
            stage = Stage(mesh, 0)
            self.controller.transport = _LocalTransport(_StreamWorker(stage, build(stage, *args)),
                                                    self._on_message)
            self._started = True
            return
        self._group = RankGroup(mesh, stream_rank, build, args, poll_seconds,
                                on_message=self._on_message, threads=threads)
        self.controller.transport = self._group
        ready = 0
        while ready < mesh.world_size:
            rank, msg = self._startup.get()
            if msg[0] != "ready":
                self._group.close(timeout=5)
                raise RuntimeError(f"stream rank {rank} of {mesh.world_size} failed to start:\n"
                                   f"{msg[1]}")
            ready += 1
        self._started = True

    @property
    def pids(self) -> list[int]:
        """The rank processes' ids (none for a one-rank mesh)."""
        return [] if self._group is None else self._group.pids

    @property
    def failed(self) -> bool:
        return self.controller.failure is not None

    @property
    def ticks_run(self) -> int:
        return self.controller.ticks_run

    def _on_message(self, rank: int, msg: tuple) -> None:
        if not self._started:
            self._startup.put((rank, msg))
        elif msg[0] == "launches":
            self._launches.put((rank, msg[1:]))
        else:
            self.controller.on_message(rank, msg)

    def _on_failure(self, err: BaseException) -> None:
        if self._group is not None:
            import threading

            # The other ranks may wait on the one that failed: stop them all,
            # off the thread that reported it.
            threading.Thread(target=self._group.close, kwargs={"timeout": 5},
                             daemon=True).start()

    def stream(self, payload, latent_shape: tuple, dtype=torch.float32) -> PipelineStream:
        """A stream of samples ``(*latent_shape)`` conditioned by ``payload``
        (what the job's ``bundle`` takes; CPU tensors)."""
        return self.controller.open(payload, latent_shape, dtype)

    def mark(self) -> None:
        """Every rank counts its kernel launches from now on."""
        for r in range(self.mesh.world_size):
            self.controller.transport.send(r, ("mark",))

    def launches(self) -> list[tuple[dict, float]]:
        """Each rank's kernel launches since :meth:`mark` (or its start) and
        its device's allocator peak in GB (0.0 on the CPU), in rank order."""
        for r in range(self.mesh.world_size):
            self.controller.transport.send(r, ("launches",))
        got = dict(self._launches.get() for _ in range(self.mesh.world_size))
        return [got[r] for r in range(self.mesh.world_size)]

    def close(self) -> None:
        """Finish the samples submitted, then stop the ranks."""
        self.controller.close()
        if self._group is None:
            self.controller.transport.close()
            return
        if not self.failed:
            for r in range(self.mesh.world_size):
                with contextlib.suppress(OSError):
                    self._group.send(r, ("stop",))
        self._group.close()


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
