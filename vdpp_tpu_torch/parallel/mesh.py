"""Rank processes for the step pipeline, the data-parallel modes and the
intra-sample axes (the port's counterpart of ``vdpp_tpu/parallel/mesh.py``:
``make_pipeline_mesh``, ``make_data_mesh``, ``make_2d_mesh`` and
``make_axes_mesh``, which also stands for the reference's ``make_seq_mesh``,
``make_stage_seq_mesh``, ``make_cfg_mesh`` and its expert meshes, and
``make_pipeline_and_decode_mesh`` for its ``make_pipeline_and_decode_meshes``).

The JAX package runs its modes as one SPMD program over mesh axes
``"stage"``, ``"data"``, ``"seq"``, ``"frame"``, ``"cfg"`` and ``"expert"``. The port takes
the original system's shape instead: one OS process per rank, each holding
the whole model (or, under FSDP, its shards), all joined by one
``torch.distributed`` process group. A mesh says where the ranks run and how
they talk: S stages, each a group of ranks laid out row-major as the JAX
package's ``make_axes_mesh`` lays out its devices. A stage is either D data
columns (rank ``s * D + d``) or a (seq, frame, cfg, expert) block of the
intra-sample axes (rank ``(((s * SEQ + i) * FRAME + j) * CFG + c) * EXPERT +
e``); the two do not mix,
as in the JAX package. A mesh may reserve D decode ranks after the stage
ranks (the "stages + decode chips" layout): they take no part in the
pipeline and decode each finished sample while later samples denoise.
:func:`run_stages` starts the ranks (``spawn``: a
parent that already holds a CUDA context cannot fork) and returns what each
rank's function returned; each rank gets a :class:`Stage`, its view of the
group, which holds one process subgroup for each inner axis it lies on
(``parallel/collectives.py`` runs the sharded ops' collectives over them).

The backend follows from the layout and is not a choice:

* ``nccl`` when each rank has a card of its own: the payload goes card to card;
* ``gloo`` on the CPU, and on cards that ranks share, which a caller asks for
  with an explicit device list (``devices=["cuda:0", "cuda:0"]``), as the
  original's simulator ran its ranks on one shared GPU (NCCL refuses two ranks
  on one card). The payload, and every inner-axis collective, is copied to
  host memory on each side.

One rank needs no process group: :class:`Stage` then makes no collective
call, so a one-rank run goes in the caller's own process.
"""

from __future__ import annotations

import atexit
import contextlib
import math
import multiprocessing
import os
import pickle
import queue
import signal
import tempfile
import time
import traceback
from collections.abc import Callable, Sequence
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from vdpp_tpu_torch.parallel.collectives import Axis
from vdpp_tpu_torch.utils.device import resolve_device

# The intra-sample axes, in the order the ranks of a stage are laid out (the
# JAX benchmark's order, expert innermost).
INNER_AXES = ("seq", "frame", "cfg", "expert")


@dataclass(frozen=True)
class PipelineMesh:
    """Where the ranks run and how they talk: ``devices[r]`` is rank r's
    device and ``backend`` the process group's.

    Each stage is a group of ``group_size`` consecutive ranks: ``num_data``
    data columns, or a ``seq x frame x cfg x expert`` block of the
    intra-sample axes, row-major, as the JAX package's ``make_axes_mesh(
    stage=S, seq=..., frame=..., cfg=..., expert=...)`` lays out its devices.
    A pipeline mesh has groups of one, a data mesh one stage."""

    devices: tuple[torch.device, ...]
    backend: str
    num_data: int = 1
    seq: int = 1
    frame: int = 1
    cfg: int = 1
    expert: int = 1
    decode: int = 0  # reserved decode ranks, after the stage ranks

    def __post_init__(self) -> None:
        if min(self.num_data, self.seq, self.frame, self.cfg, self.expert) < 1:
            raise ValueError(f"axis sizes must be >= 1: data {self.num_data}, seq {self.seq}, "
                             f"frame {self.frame}, cfg {self.cfg}, expert {self.expert}")
        if self.cfg not in (1, 2):
            raise ValueError("the cfg axis has exactly 2 branches (uncond, cond)")
        if self.num_data > 1 and self.inner > 1:
            raise ValueError("the data axis composes with the stage axis only, not with the "
                             "seq, frame, cfg or expert axes")
        if self.decode and self.num_data > 1:
            raise ValueError("decode ranks compose with the stage and intra-sample axes, not "
                             "with the data axis")
        if self.stage_ranks < 1 or self.stage_ranks % self.group_size:
            raise ValueError(f"{self.stage_ranks} stage ranks do not form stages of "
                             f"{self.group_size}")

    @property
    def world_size(self) -> int:
        """Every rank: the stage ranks, then the decode ranks."""
        return len(self.devices)

    @property
    def stage_ranks(self) -> int:
        """The ranks of the stages (all columns), ``0 .. stage_ranks - 1``."""
        return len(self.devices) - self.decode

    @property
    def inner(self) -> int:
        """Ranks of a stage's intra-sample block (seq x frame x cfg x expert)."""
        return self.seq * self.frame * self.cfg * self.expert

    @property
    def group_size(self) -> int:
        """Ranks a stage: its data columns or its intra-sample block."""
        return self.num_data * self.inner

    @property
    def num_stages(self) -> int:
        return self.stage_ranks // self.group_size

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


def _mesh(devs: tuple[torch.device, ...], num_data: int = 1, **axes: int) -> PipelineMesh:
    """NCCL when every rank has a card of its own, else gloo."""
    own_cards = devs[0].type == "cuda" and len(set(devs)) == len(devs)
    return PipelineMesh(devs, "nccl" if own_cards else "gloo", num_data, **axes)


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


def make_axes_mesh(stage: int | None = 1, seq: int = 1, frame: int = 1, cfg: int = 1,
                   expert: int = 1, device: str | torch.device | None = None,
                   devices: Sequence[str | torch.device] | None = None) -> PipelineMesh:
    """The (stage, seq, frame, cfg, expert) mesh: ``stage`` stages, each a
    block of ``seq x frame x cfg x expert`` ranks laid out row-major (rank
    ``(((s * seq + i) * frame + j) * cfg + c) * expert + e``), on card r or
    ``devices[r]``. ``stage=None``
    takes as many stages as the named devices or the visible cards fill (one
    on the CPU). The other arguments and the backend rule are
    :func:`make_pipeline_mesh`'s."""
    block = seq * frame * cfg * expert
    if stage is None:
        if devices is not None:
            stage = len(devices) // block
        elif resolve_device(device).type == "cuda":
            stage = torch.cuda.device_count() // block
        else:
            stage = 1
    if stage < 1 or block < 1:
        raise ValueError(f"a ({stage}, {seq}, {frame}, {cfg}, {expert}) mesh")
    return _mesh(_devices(stage * block, device, devices), seq=seq, frame=frame, cfg=cfg,
                 expert=expert)


def make_pipeline_and_decode_mesh(num_stages: int | None, decode_devices: int,
                                  device: str | torch.device | None = None,
                                  devices: Sequence[str | torch.device] | None = None,
                                  seq: int = 1, frame: int = 1) -> PipelineMesh:
    """The (stage[, seq][, frame]) mesh with ``decode_devices`` reserved decode
    ranks after the stage ranks, drawn from one device list: ``devices`` as
    given, else every visible card (rank r on card r), or, on the CPU, as
    many ranks as the layout needs. ``num_stages=None`` takes as many stages
    as the devices left after the reservation fill (one on the CPU). More
    ranks than devices raises, naming the devices."""
    per_stage = seq * frame
    if devices is not None:
        avail = len(devices)
    elif resolve_device(device).type == "cuda":
        avail = torch.cuda.device_count()
    else:
        avail = None  # the CPU: any number of ranks
    if num_stages is None:
        num_stages = 1 if avail is None else (avail - decode_devices) // per_stage
    need = num_stages * per_stage + decode_devices
    if not decode_devices and num_stages < 1:
        raise ValueError(f"per-stage group (seq {seq} x frame {frame} = {per_stage}) exceeds the "
                         f"{avail} available devices")
    if num_stages < 1 or (avail is not None and need > avail):
        raise ValueError(f"{num_stages} stages x {per_stage} per-stage (seq {seq} x frame "
                         f"{frame}) + {decode_devices} decode devices need {need} devices, have "
                         f"{avail}")
    devs = _devices(need, device, None if devices is None else list(devices)[:need])
    return _mesh(devs, seq=seq, frame=frame, decode=decode_devices)


class Stage:
    """One rank's view of the mesh: its global rank, its stage, its data
    column or its place on each intra-sample axis, its device, and the
    collective calls the pipeline, the runners and the apps make.

    ``seq``, ``frame``, ``cfg`` and ``expert`` are this rank's
    :class:`~vdpp_tpu_torch.parallel.collectives.Axis` on each inner axis of
    size > 1, else None.
    Building a Stage on a mesh with inner axes makes one process subgroup
    for every line of ranks along each such axis: every rank of the group
    builds the same Stage, so every rank calls ``new_group`` for every
    subgroup in the same order (a decode rank too: ``new_group`` is
    collective over the whole group).

    On a mesh with decode ranks, ``is_decode`` says this is one of them;
    the stage ranks and the decode ranks each have a subgroup of their own
    (the stage ranks' tick barrier must not wait on the decode ranks), and
    ``decode_axis`` is the decode ranks' axis ("data", on every rank)."""

    def __init__(self, mesh: PipelineMesh, rank: int):
        self.mesh = mesh
        self.rank = rank
        self.device = mesh.devices[rank]
        self.seq = self.frame = self.cfg = self.expert = None
        if mesh.inner > 1:
            for name in INNER_AXES:
                setattr(self, name, self._axis(name))
        self._side_group = None  # None: the default group, every rank
        self.decode_axis = None
        if mesh.decode:
            n = mesh.stage_ranks
            stage_group = dist.new_group(list(range(n)))
            decode_ranks = tuple(range(n, mesh.world_size))
            decode_group = dist.new_group(list(decode_ranks))
            self._side_group = decode_group if self.is_decode else stage_group
            self.decode_axis = Axis("data", mesh.decode, max(rank - n, 0), decode_ranks,
                                    decode_group, host=mesh.host_handoff)
            if mesh.backend == "nccl":  # NCCL's point-to-point calls want a collective first
                self.barrier()

    @property
    def is_decode(self) -> bool:
        """This rank is one of the mesh's reserved decode ranks."""
        return self.rank >= self.mesh.stage_ranks

    def ranks_axis(self) -> Axis:
        """The axis of every rank of the mesh ("data"; the default group),
        for the work all ranks split after the pipeline, such as a
        chunk-parallel decode."""
        n = self.mesh.world_size
        return Axis("data", n, self.rank, tuple(range(n)), None, host=self.mesh.host_handoff)

    def _axis(self, name: str) -> Axis | None:
        """This rank's Axis along ``name``, after creating the subgroup of
        every line of ranks along it (None, and no group, for size 1)."""
        mesh = self.mesh
        sizes = [getattr(mesh, a) for a in INNER_AXES]
        k = INNER_AXES.index(name)
        if sizes[k] == 1:
            return None
        stride = math.prod(sizes[k + 1:])
        mine = None
        for start in range(mesh.stage_ranks):
            # one line a start: the ranks whose coordinate on ``name`` is 0
            if (start % mesh.inner) // stride % sizes[k]:
                continue
            ranks = tuple(start + i * stride for i in range(sizes[k]))
            group = dist.new_group(list(ranks))
            if self.rank in ranks:
                mine = Axis(name, sizes[k], ranks.index(self.rank), ranks, group,
                            host=mesh.host_handoff)
                if mesh.backend == "nccl":  # NCCL's point-to-point calls want a collective first
                    dist.barrier(group=group, device_ids=[self.device.index])
        return mine

    @property
    def axes(self) -> dict[str, Axis | None]:
        """``seq_axis``, ``frame_axis``, ``cfg_axis`` and ``expert_axis``
        for a wrapper's ``pipeline_step_fn``."""
        return {"seq_axis": self.seq, "frame_axis": self.frame, "cfg_axis": self.cfg,
                "expert_axis": self.expert}

    @property
    def num_stages(self) -> int:
        return self.mesh.num_stages

    @property
    def index(self) -> int:
        """This rank's stage."""
        return self.rank // self.mesh.group_size

    @property
    def column(self) -> int:
        """This rank's data column."""
        return self.rank % self.mesh.group_size // self.mesh.inner

    @property
    def inner_rank(self) -> int:
        """This rank's place in its stage's intra-sample block (0 without
        inner axes)."""
        return self.rank % self.mesh.inner

    @property
    def is_last(self) -> bool:
        """This rank belongs to the last stage."""
        return self.index == self.num_stages - 1

    @property
    def is_last_rank(self) -> bool:
        """The last stage rank: of the ranks of the last stage, which all
        hold the finished samples, the one that writes them out."""
        return self.rank == self.mesh.stage_ranks - 1

    @property
    def is_decode_sender(self) -> bool:
        """The first rank of the last stage: of the ranks that hold each
        finished sample, the one that sends it to the decode ranks."""
        return self.mesh.decode > 0 and self.rank == self.mesh.stage_ranks - self.mesh.group_size

    def send_to_decode(self, x: torch.Tensor) -> list:
        """Post ``x`` to every decode rank (point to point, through host
        memory under gloo) without waiting: returns the pending works, each
        holding its tensor, for the caller to wait on later, so that the
        next ticks run while the decode ranks take it."""
        sent = x.detach().cpu() if self.mesh.host_handoff else x.contiguous()
        works = [dist.isend(sent, r) for r in range(self.mesh.stage_ranks, self.mesh.world_size)]
        return [(w, sent) for w in works]

    def receive_sample(self, like: torch.Tensor) -> torch.Tensor:
        """On a decode rank: the next sample the decode sender posts, of
        ``like``'s shape and dtype, on this rank's device."""
        src = self.mesh.stage_ranks - self.mesh.group_size
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if self.mesh.host_handoff else self.device)
        dist.recv(buf, src)
        return buf.to(self.device)

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
        """Send ``out`` to this rank's counterpart in the next stage (the same
        column, or the same place in the intra-sample block) and receive from
        the one in the previous stage a payload of ``recv_like``'s shape and
        dtype, both at once (so a chain of blocking ranks cannot wait on each
        other); either may be None. Returns the received payload on this
        rank's device.

        Under NCCL ``wait`` orders the current stream after the transfer and
        does not block the host; the caller synchronises before it leaves
        the group (``StepPipeline.run`` does)."""
        host, step = self.mesh.host_handoff, self.mesh.group_size
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
        """Each stage's ``slot`` (one shape and dtype on all ranks), stacked in
        stage order on the CPU of the last rank; None on the others. The
        ranks of a stage hold the same slot (the payload is replicated over
        the intra-sample axes): the first rank of each stage sends it, the
        last rank posts a receive from each and keeps its own for the last
        stage. Point to point, as the hand-off, through host memory under
        gloo and card to card under NCCL. Not on a (stage, data) mesh."""
        if self.mesh.num_data != 1:
            raise NotImplementedError("gathering the stage ring of a (stage, data) mesh")
        last, g = self.mesh.stage_ranks - 1, self.mesh.group_size
        host = self.mesh.host_handoff
        slot = slot.cpu() if host else slot.contiguous()
        if self.rank != last:
            if self.inner_rank == 0 and not self.is_last:
                for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, slot, last)]):
                    w.wait()
            return None
        bufs = [torch.empty_like(slot) for _ in range(self.num_stages - 1)]
        if bufs:
            ops = [dist.P2POp(dist.irecv, b, s * g) for s, b in enumerate(bufs)]
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
        """Every stage rank, all columns (or, on a decode rank, every decode
        rank): ticks stay aligned across columns, as in the JAX package's
        one SPMD program, and never wait on the decode ranks."""
        self._barrier(self._side_group)

    def barrier_all(self) -> None:
        """Every rank of the mesh, the decode ranks too."""
        self._barrier(None)

    def _barrier(self, group) -> None:
        if self.mesh.world_size == 1:
            return
        if self.mesh.backend == "nccl":
            dist.barrier(group=group, device_ids=[self.device.index])
        else:
            dist.barrier(group=group)


def _join(rank: int, mesh: PipelineMesh, init_method: str, threads: int) -> Stage:
    """A spawned rank's set-up: its thread count and card, the process group,
    its :class:`Stage`, and a first collective over every rank (NCCL's
    batched point-to-point calls need one, since a rank idle in tick 0 posts
    none)."""
    torch.set_num_threads(threads)
    if mesh.devices[rank].type == "cuda":
        torch.cuda.set_device(mesh.devices[rank])
    dist.init_process_group(mesh.backend, init_method=init_method, rank=rank,
                            world_size=mesh.world_size)
    stage = Stage(mesh, rank)
    stage.barrier_all()
    return stage


def _rank_main(rank: int, mesh: PipelineMesh, init_method: str, payload: bytes, threads: int,
               results) -> None:
    """A spawned rank: joins the group, runs the pickled ``fn(stage, *args)``
    and puts ``(rank, pickled result, None)`` or ``(rank, None, traceback)``
    on ``results``."""
    try:
        stage = _join(rank, mesh, init_method, threads)
        fn, args = pickle.loads(payload)
        results.put((rank, pickle.dumps(fn(stage, *args)), None))
    except Exception:  # the parent reports it; this process ends here
        results.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _group_rank_main(rank: int, mesh: PipelineMesh, init_method: str, payload: bytes,
                     threads: int, conn) -> None:
    """A rank of a :class:`RankGroup`: joins the group and runs the pickled
    ``fn(stage, channel, *args)`` until it returns, its channel reaches EOF
    (the parent is gone) or it raises, when it sends ``("error", traceback)``.
    It ignores SIGINT and SIGTERM: a terminal's Ctrl-C reaches the whole
    process group, and the parent drains its work before it stops the
    ranks."""
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    try:
        stage = _join(rank, mesh, init_method, threads)
        fn, args = pickle.loads(payload)
        fn(stage, conn, *args)
    except (EOFError, BrokenPipeError, ConnectionResetError):
        pass  # the parent is gone: nothing is waiting for this rank
    except Exception:
        with contextlib.suppress(OSError):
            conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()
        if dist.is_initialized():
            dist.destroy_process_group()


class RankGroup:
    """The ranks of ``mesh``, started once and kept alive, each in its own
    spawned process running ``fn(stage, channel, *args)`` (a module-level
    function, sent by import path; ``args`` pickled) on its channel, a
    duplex pipe to this process: the rank reads its commands there and
    writes its messages back, any picklable objects (tensors on the CPU).

    :meth:`send` writes to one rank's channel (sends are serialised, so
    several threads may send). One thread here reads every channel and calls
    ``on_message(rank, message)`` for each message, in the order each rank
    sent them; a rank whose channel closes (it returned, raised or died)
    gives ``(rank, ("exit", exitcode))`` once. A rank reads nothing but its
    channel while it waits, so an idle rank sits in no collective (whose
    timeout would end it), and it exits when the channel reaches EOF: when
    this process closes the group or dies, even by SIGKILL.

    :meth:`close` closes the channels and joins the ranks, killing those
    still alive after ``timeout`` seconds (they ignore SIGTERM); it also runs
    when this interpreter exits.
    """

    def __init__(self, mesh: PipelineMesh, fn: Callable[..., Any], *args: Any,
                 on_message: Callable[[int, Any], None], threads: int | None = None):
        import threading

        ctx = multiprocessing.get_context("spawn")
        threads = torch.get_num_threads() if threads is None else threads
        payload = pickle.dumps((fn, args))
        self.mesh = mesh
        self._on_message = on_message
        self._tmp = tempfile.TemporaryDirectory(prefix="vdpp_ranks_")
        init = "file://" + os.path.join(self._tmp.name, "rendezvous")
        self._conns, self._procs = [], []
        for r in range(mesh.world_size):
            mine, theirs = ctx.Pipe(duplex=True)
            proc = ctx.Process(target=_group_rank_main,
                               args=(r, mesh, init, payload, threads, theirs), daemon=True)
            proc.start()
            theirs.close()
            self._conns.append(mine)
            self._procs.append(proc)
        self._send_lock = threading.Lock()
        self._close_lock = threading.Lock()
        self._closed = False
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()
        atexit.register(self.close)

    @property
    def pids(self) -> list[int]:
        return [p.pid for p in self._procs]

    def send(self, rank: int, message: Any) -> None:
        """Write ``message`` to rank ``rank``'s channel; raises ``OSError``
        once the rank's channel is closed."""
        with self._send_lock:
            self._conns[rank].send(message)

    def _read(self) -> None:
        from multiprocessing.connection import wait

        open_ = dict(enumerate(self._conns))
        while open_ and not self._closed:
            try:  # close() may close a channel under the wait
                ready = wait(list(open_.values()), timeout=0.5)
            except (OSError, ValueError):
                return
            for conn in ready:
                rank = self._conns.index(conn)
                try:
                    msg = conn.recv()
                except (EOFError, OSError, ValueError):
                    del open_[rank]
                    self._procs[rank].join(timeout=5)
                    msg = ("exit", self._procs[rank].exitcode)
                if self._closed:
                    return
                self._on_message(rank, msg)

    def close(self, timeout: float = 30.0) -> None:
        """Close every channel (each rank then exits) and join the ranks,
        killing any still alive after ``timeout`` seconds."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        atexit.unregister(self.close)
        for conn in self._conns:  # not under the send lock: a send may wait on a stuck rank
            conn.close()
        deadline = time.monotonic() + timeout
        for p in self._procs:
            p.join(max(deadline - time.monotonic(), 0.1))
        for p in self._procs:
            if p.is_alive():
                p.kill()
                p.join()
        self._reader.join(timeout=5)
        self._tmp.cleanup()


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
