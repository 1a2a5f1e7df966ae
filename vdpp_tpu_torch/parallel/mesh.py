"""Rank processes for the step pipeline and the data-parallel modes (the
port's counterpart of ``vdpp_tpu/parallel/mesh.py``: ``make_pipeline_mesh``,
``make_data_mesh`` and ``make_2d_mesh``).

The JAX package runs its modes as one SPMD program over mesh axes ``"stage"``
and ``"data"``. The port takes the original system's shape instead: one OS
process per rank, each holding the whole model (or, under FSDP, its shards),
all joined by one ``torch.distributed`` process group. A mesh says where the
ranks run and how they talk: S stages of D data columns, rank ``s * D + d``
being stage s of column d, as the JAX package lays out a ``(stage, data)``
mesh. :func:`run_stages` starts the ranks (``spawn``: a parent that already
holds a CUDA context cannot fork) and returns what each rank's function
returned; each rank gets a :class:`Stage`, its view of the group.

The backend follows from the layout and is not a choice:

* ``nccl`` when each rank has a card of its own: the payload goes card to card;
* ``gloo`` on the CPU, and on cards that ranks share, which a caller asks for
  with an explicit device list (``devices=["cuda:0", "cuda:0"]``), as the
  original's simulator ran its ranks on one shared GPU (NCCL refuses two ranks
  on one card). The payload is copied to host memory on each side of the
  hand-off.

One rank needs no process group: :class:`Stage` then makes no collective
call, so a one-rank run goes in the caller's own process.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import queue
import tempfile
import time
import traceback
from collections.abc import Callable, Sequence
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from vdpp_tpu_torch.utils.device import resolve_device

@dataclass(frozen=True)
class PipelineMesh:
    """Where the ranks run and how they talk: ``devices[r]`` is rank r's
    device and ``backend`` the process group's.

    The ranks form a (stage, data) grid laid out as the JAX package's
    ``make_axes_mesh(stage=S, data=D)`` lays out its devices, row-major: rank
    ``r`` is stage ``r // D`` of data column ``r % D``. A pipeline mesh has one
    column, a data mesh one stage."""

    devices: tuple[torch.device, ...]
    backend: str
    num_data: int = 1

    def __post_init__(self) -> None:
        if self.num_data < 1 or len(self.devices) % self.num_data:
            raise ValueError(f"{len(self.devices)} ranks do not form columns of "
                             f"{self.num_data}")

    @property
    def world_size(self) -> int:
        return len(self.devices)

    @property
    def num_stages(self) -> int:
        return len(self.devices) // self.num_data

    @property
    def host_handoff(self) -> bool:
        """The payload crosses host memory (gloo) rather than going card to
        card (NCCL)."""
        return self.backend == "gloo"


def _devices(n: int | None, device, devices) -> tuple[torch.device, ...]:
    """One device a rank: ``devices`` as given (cards may repeat), else ``n``
    ranks (``None``: every visible card, or 1 on the CPU), rank r on card r
    or all of them on the CPU."""
    if devices is not None:
        devs = tuple(torch.device(d) for d in devices)
        if n is not None and n != len(devs):
            raise ValueError(f"{n} ranks asked for, but {len(devs)} devices given")
        if len({d.type for d in devs}) > 1:
            raise ValueError(f"ranks on more than one device type: {list(devs)}")
        for d in devs:
            resolve_device(d)
        if devs and devs[0].type == "cuda":
            devs = tuple(torch.device("cuda", d.index or 0) for d in devs)
            count = torch.cuda.device_count()
            if max(d.index for d in devs) >= count:
                raise ValueError(f"{list(devs)} named, but only {count} cards are visible")
    else:
        dev = resolve_device(device)
        if dev.type == "cuda":
            count = torch.cuda.device_count()
            n = count if n is None else n
            if n > count:
                raise ValueError(f"Need {n} devices, but only {count} devices available.")
            devs = tuple(torch.device("cuda", i) for i in range(n))
        else:
            devs = (dev,) * (1 if n is None else n)
    if not devs:
        raise ValueError("a mesh needs at least one rank")
    return devs


def _mesh(devs: tuple[torch.device, ...], num_data: int = 1) -> PipelineMesh:
    """NCCL when every rank has a card of its own, else gloo."""
    own_cards = devs[0].type == "cuda" and len(set(devs)) == len(devs)
    return PipelineMesh(devs, "nccl" if own_cards else "gloo", num_data)


def make_pipeline_mesh(num_stages: int | None = None, device: str | torch.device | None = None,
                       devices: Sequence[str | torch.device] | None = None) -> PipelineMesh:
    """The stage layout.

    Args:
        num_stages: stage count; ``None`` means every visible card (on the
            CPU: 1), as ``make_pipeline_mesh(None)`` means every device in
            the JAX package. More stages than cards raises.
        device: ``"cuda"`` (the default) or ``"cpu"``; stage s runs on card s,
            or every stage on the CPU.
        devices: an explicit device per stage instead, which may name one card
            several times (a shared card: gloo, host hand-off).

    The backend is NCCL when every rank has a card of its own, else gloo.
    """
    return _mesh(_devices(num_stages, device, devices))


def make_data_mesh(num_shards: int | None = None, device: str | torch.device | None = None,
                   devices: Sequence[str | torch.device] | None = None) -> PipelineMesh:
    """One stage of ``num_shards`` data columns (``None``: every visible card,
    1 on the CPU): the layout of the data-parallel baseline and of FSDP. The
    arguments and the backend rule are :func:`make_pipeline_mesh`'s."""
    devs = _devices(num_shards, device, devices)
    return _mesh(devs, len(devs))


def make_2d_mesh(num_stages: int, num_data: int, device: str | torch.device | None = None,
                 devices: Sequence[str | torch.device] | None = None) -> PipelineMesh:
    """The (stage, data) mesh of pipeline x data parallelism: ``num_data``
    columns, each a pipeline of ``num_stages`` ranks; rank ``s * num_data + d``
    is stage s of column d (on card ``s * num_data + d``, or on
    ``devices[s * num_data + d]``)."""
    if num_stages < 1 or num_data < 1:
        raise ValueError(f"a ({num_stages}, {num_data}) mesh")
    return _mesh(_devices(num_stages * num_data, device, devices), num_data)


class Stage:
    """One rank's view of the mesh: its global rank, its stage and data
    column, its device, and the collective calls the pipeline, the runners
    and the apps make."""

    def __init__(self, mesh: PipelineMesh, rank: int):
        self.mesh = mesh
        self.rank = rank
        self.device = mesh.devices[rank]

    @property
    def num_stages(self) -> int:
        return self.mesh.num_stages

    @property
    def index(self) -> int:
        """This rank's stage."""
        return self.rank // self.mesh.num_data

    @property
    def column(self) -> int:
        """This rank's data column."""
        return self.rank % self.mesh.num_data

    @property
    def is_last(self) -> bool:
        return self.index == self.num_stages - 1

    def column_shard(self, inputs: torch.Tensor) -> torch.Tensor:
        """This column's contiguous block of the samples ``inputs (N, ...)``,
        the block a leading-axis ``P("data")`` gives a column in the JAX
        package; N must be divisible by the column count."""
        n, d = len(inputs), self.mesh.num_data
        if n % d:
            raise ValueError(f"num_samples {n} must be divisible by data-axis size {d}")
        k = n // d
        return inputs[self.column * k:(self.column + 1) * k]

    def handoff(self, out: torch.Tensor | None,
                recv_like: torch.Tensor | None) -> torch.Tensor | None:
        """Send ``out`` to the next stage of this column and receive from the
        previous one a payload of ``recv_like``'s shape and dtype, both at
        once (so a chain of blocking ranks cannot wait on each other); either
        may be None. Returns the received payload on this rank's device.

        Under NCCL ``wait`` orders the current stream after the transfer and
        does not block the host; the caller synchronises before it leaves
        the group (``StepPipeline.run`` does)."""
        host, step = self.mesh.host_handoff, self.mesh.num_data
        ops, buf = [], None
        if out is not None:
            sent = out.cpu() if host else out.contiguous()
            ops.append(dist.P2POp(dist.isend, sent, self.rank + step))
        if recv_like is not None:
            buf = torch.empty_like(recv_like, device="cpu" if host else self.device)
            ops.append(dist.P2POp(dist.irecv, buf, self.rank - step))
        for w in dist.batch_isend_irecv(ops) if ops else ():
            w.wait()
        return None if buf is None else buf.to(self.device)

    def gather_to_last(self, slot: torch.Tensor) -> torch.Tensor | None:
        """Every rank's ``slot`` (one shape and dtype on all ranks), stacked in
        rank order on the CPU of the last rank; None on the others. Point to
        point, as the hand-off: each rank sends to the last one, which posts
        a receive per rank, through host memory under gloo and card to card
        under NCCL. One column only (a stage mesh)."""
        if self.mesh.num_data != 1:
            raise NotImplementedError("gathering the stage ring of a (stage, data) mesh")
        last = self.mesh.world_size - 1
        host = self.mesh.host_handoff
        slot = slot.cpu() if host else slot.contiguous()
        if self.rank != last:
            for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, slot, last)]):
                w.wait()
            return None
        bufs = [torch.empty_like(slot) for _ in range(last)]
        if bufs:
            ops = [dist.P2POp(dist.irecv, b, r) for r, b in enumerate(bufs)]
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        return torch.stack([*bufs, slot]).cpu()

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        """``obj`` from rank ``src`` on every rank (pickled; put tensors on
        the CPU first)."""
        if self.mesh.world_size == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=src)
        return box[0]

    def barrier(self) -> None:
        """Every rank of the mesh, all columns: ticks stay aligned across
        columns, as in the JAX package's one SPMD program."""
        if self.mesh.world_size == 1:
            return
        if self.mesh.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


def _rank_main(rank: int, mesh: PipelineMesh, init_method: str, payload: bytes, threads: int,
               results) -> None:
    """A spawned rank: joins the group, runs the pickled ``fn(stage, *args)``
    and puts ``(rank, pickled result, None)`` or ``(rank, None, traceback)``
    on ``results``."""
    try:
        torch.set_num_threads(threads)
        if mesh.devices[rank].type == "cuda":
            torch.cuda.set_device(mesh.devices[rank])
        dist.init_process_group(mesh.backend, init_method=init_method, rank=rank,
                                world_size=mesh.world_size)
        stage = Stage(mesh, rank)
        # Every rank joins one collective first: NCCL's batched point-to-point
        # calls need that, since a rank idle in tick 0 posts none.
        stage.barrier()
        fn, args = pickle.loads(payload)
        results.put((rank, pickle.dumps(fn(stage, *args)), None))
    except Exception:  # the parent reports it; this process ends here
        results.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_stages(mesh: PipelineMesh, fn: Callable[..., Any], *args: Any, threads: int | None = None,
               timeout: float | None = None) -> list[Any]:
    """Run ``fn(stage, *args)`` on each of ``mesh``'s ranks (all stages of all
    columns), one spawned
    process each, and return their results in rank order.

    ``fn`` is sent by import path (a module-level function), ``args`` and the
    results are pickled. ``threads`` is each rank's intra-op thread count
    (default: this process's). A rank that raises or dies fails the call
    with its traceback, and the other ranks are terminated; so are all of
    them after ``timeout`` seconds.
    """
    ctx = multiprocessing.get_context("spawn")
    threads = torch.get_num_threads() if threads is None else threads
    payload = pickle.dumps((fn, args))
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="vdpp_stages_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, args=(r, mesh, init, payload, threads, results),
                             daemon=True) for r in range(mesh.world_size)]
        for p in procs:
            p.start()
        try:
            return _collect(procs, results, timeout)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join()


def _collect(procs, results, timeout: float | None) -> list[Any]:
    deadline = None if timeout is None else time.monotonic() + timeout
    got: dict[int, Any] = {}
    while len(got) < len(procs):
        try:
            rank, out, err = results.get(timeout=1.0)
        except queue.Empty:
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"stage ranks {sorted(set(range(len(procs))) - set(got))} "
                                   f"gave no result in {timeout} s") from None
            dead = [r for r, p in enumerate(procs) if r not in got and p.exitcode is not None]
            if not dead:
                continue
            try:  # a rank that exited may have flushed its result just now
                rank, out, err = results.get(timeout=5.0)
            except queue.Empty:
                raise RuntimeError(f"stage rank(s) {dead} exited with code(s) "
                                   f"{[procs[r].exitcode for r in dead]} and no result") from None
        if err is not None:
            raise RuntimeError(f"stage rank {rank} of {len(procs)} failed:\n{err}")
        got[rank] = pickle.loads(out)
    return [got[r] for r in range(len(procs))]
