"""The collectives of intra-sample parallelism: what ``jax.lax`` gives the
JAX package's sharded ops (``axis_index``, ``psum(1, axis)``,
``all_gather(tiled=True)``, ``pmean``, ``psum``, ``pmax`` and ``ppermute``),
over the process subgroups of ``parallel/mesh.py``.

An :class:`Axis` is one rank's view of one inner mesh axis (``seq``,
``frame``, ``cfg`` or ``expert``): its size, this rank's index along it, the global
ranks along it in axis order and their process group. The sharded ops take
it where the JAX package takes an axis name.

Two rules hold for every call:

* the results are the same bits on every rank of the axis and on both
  backends: a mean or a sum gathers the per-shard partials and sums them in
  shard order on each rank (a ring all-reduce sums in an order that depends
  on the rank and the backend), a max takes the largest of the gathered
  values;
* under gloo a tensor on a card is staged through host memory on each side
  of the call, as the pipeline's hand-off is (gloo's CUDA collectives are
  limited); under NCCL it goes card to card.

Point-to-point exchanges (the halo, the cfg swap) post their sends and
receives at once with ``batch_isend_irecv``, so a chain of ranks cannot wait
on each other. ``counts`` and ``nbytes`` tally each kind of call and the
bytes of this rank's part in it (``chip_smoke.py`` and the modes read
them).
"""

from __future__ import annotations

from collections import Counter
from collections.abc import Sequence
from dataclasses import dataclass, field
from typing import Any

import torch
import torch.distributed as dist

# Calls by kind ("halo", "all_gather", "mean", "sum", "max", "swap",
# "broadcast", "gather") and the bytes of this rank's part in them (a halo's
# slices sent, a gather's, a mean's, a sum's or a max's shard, a swap's
# tensor, a broadcast's tensor, what a rank sends to a gather's root or the
# root receives), since the counters were last cleared.
counts: Counter[str] = Counter()
nbytes: Counter[str] = Counter()


def clear_counts() -> None:
    counts.clear()
    nbytes.clear()


@dataclass(frozen=True)
class Axis:
    """One inner mesh axis as one rank sees it. ``ranks`` are the global
    ranks along the axis in axis order (``ranks[index]`` is this rank);
    ``host`` says the backend is gloo, which stages card tensors through
    host memory."""

    name: str
    size: int
    index: int
    ranks: tuple[int, ...]
    group: Any = field(repr=False, compare=False)
    host: bool = True

    def _out(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as the backend sends it."""
        return (x.detach().cpu() if self.host else x).contiguous()

    def _buf(self, x: torch.Tensor) -> torch.Tensor:
        """An empty receive buffer of ``x``'s shape and dtype."""
        return torch.empty(x.shape, dtype=x.dtype, device="cpu" if self.host else x.device)


def _tally(kind: str, x: torch.Tensor) -> None:
    counts[kind] += 1
    nbytes[kind] += x.numel() * x.element_size()


def _gather_list(x: torch.Tensor, axis: Axis) -> list[torch.Tensor]:
    """Every rank's ``x`` (one shape and dtype on all), in axis order, on
    ``x``'s device."""
    sent = axis._out(x)
    parts = [axis._buf(x) for _ in range(axis.size)]
    dist.all_gather(parts, sent, group=axis.group)
    return [p.to(x.device) for p in parts]


def all_gather(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """The shards of ``x`` concatenated along ``dim`` in axis order:
    ``jax.lax.all_gather(x, axis, axis=dim, tiled=True)``."""
    _tally("all_gather", x)
    return torch.cat(_gather_list(x, axis), dim=dim)


def _sum(x: torch.Tensor, axis: Axis, kind: str) -> torch.Tensor:
    """Every rank's ``x`` on ``axis`` gathered and summed in axis order."""
    _tally(kind, x)
    parts = _gather_list(x, axis)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def _each(axes: Axis | Sequence[Axis]) -> Sequence[Axis]:
    return (axes,) if isinstance(axes, Axis) else axes


def pmean(x: torch.Tensor, axes: Axis | Sequence[Axis]) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``axes`` (one axis or several, in
    turn): each axis's per-rank values gathered and summed in axis order,
    then divided by its size, so every rank holds the same bits."""
    for axis in _each(axes):
        x = _sum(x, axis, "mean") / axis.size
    return x


def psum(x: torch.Tensor, axes: Axis | Sequence[Axis]) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes`` (one axis or several, in
    turn), summed in axis order: ``jax.lax.psum``, with the same bits on
    every rank."""
    for axis in _each(axes):
        x = _sum(x, axis, "sum")
    return x


def pmax(x: torch.Tensor, axes: Axis | Sequence[Axis]) -> torch.Tensor:
    """The elementwise max of ``x`` over the ranks of ``axes`` (one axis or
    several, in turn): ``jax.lax.pmax``."""
    for axis in _each(axes):
        _tally("max", x)
        x = torch.stack(_gather_list(x, axis)).amax(dim=0)
    return x


def _exchange(axis: Axis, sends: list[tuple[torch.Tensor, int]],
              recvs: list[tuple[torch.Tensor, int]]) -> None:
    """Post every send and receive at once (peers as indices on ``axis``)
    and wait for all of them."""
    ops = [dist.P2POp(dist.isend, t, axis.ranks[i], group=axis.group) for t, i in sends]
    ops += [dist.P2POp(dist.irecv, t, axis.ranks[i], group=axis.group) for t, i in recvs]
    for w in dist.batch_isend_irecv(ops) if ops else ():
        w.wait()


def swap(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The other rank's ``x`` on a size-2 axis: ``ppermute [(0, 1), (1, 0)]``."""
    if axis.size != 2:
        raise ValueError(f"a swap needs an axis of 2 ranks, {axis.name} has {axis.size}")
    _tally("swap", x)
    buf = axis._buf(x)
    peer = 1 - axis.index
    _exchange(axis, [(axis._out(x), peer)], [(buf, peer)])
    return buf.to(x.device)


def halo_exchange(x: torch.Tensor, axis: Axis, dim: int, halo: int) -> torch.Tensor:
    """``x`` with its neighbours' ``halo`` edge slices along ``dim``
    concatenated on each side: the left neighbour's last slices before, the
    right neighbour's first slices after; zeros at the chain's two ends,
    which is the unsharded op's SAME zero padding (the JAX package's two
    one-hop ``ppermute``s, whose zero fill plays that part)."""
    lo = x.narrow(dim, 0, halo)
    hi = x.narrow(dim, x.shape[dim] - halo, halo)
    i, n = axis.index, axis.size
    sends, recvs = [], []
    if i > 0:  # my first slices go left; the left neighbour's last come back
        sends.append((axis._out(lo), i - 1))
        recvs.append((axis._buf(hi), i - 1))
    if i < n - 1:
        sends.append((axis._out(hi), i + 1))
        recvs.append((axis._buf(lo), i + 1))
    counts["halo"] += 1
    nbytes["halo"] += len(sends) * lo.numel() * lo.element_size()
    _exchange(axis, sends, recvs)
    from_left = recvs[0][0].to(x.device) if i > 0 else torch.zeros_like(hi)
    from_right = recvs[-1][0].to(x.device) if i < n - 1 else torch.zeros_like(lo)
    return torch.cat([from_left, x, from_right], dim=dim)


def broadcast(x: torch.Tensor, axis: Axis, root: int = 0) -> torch.Tensor:
    """Rank ``root``'s ``x`` on every rank of ``axis``; the others pass a
    tensor of its shape and dtype (whose values are not read). Returns it on
    ``x``'s device."""
    _tally("broadcast", x)
    buf = axis._out(x) if axis.index == root else axis._buf(x)
    dist.broadcast(buf, axis.ranks[root], group=axis.group)
    return buf.to(x.device)


def gather_to(x: torch.Tensor | None, axis: Axis, shapes: Sequence[tuple[int, ...] | None],
              dtype: torch.dtype, device: torch.device,
              root: int = 0) -> list[torch.Tensor | None] | None:
    """Every rank's ``x`` on rank ``root`` of ``axis``, point to point:
    ``shapes[i]`` is rank i's shape (None: rank i holds nothing and passes
    None). Returns the list in axis order on the root, each on ``device``
    (its own entry as given), and None on the others."""
    if axis.index != root:
        if x is not None:
            _tally("gather", x)
            _exchange(axis, [(axis._out(x), root)], [])
        return None
    recvs = [(torch.empty(shp, dtype=dtype, device="cpu" if axis.host else device), j)
             for j, shp in enumerate(shapes) if shp is not None and j != root]
    for b, _ in recvs:
        _tally("gather", b)
    _exchange(axis, [], recvs)
    got = {j: b.to(device) for b, j in recvs}
    return [x if j == root else got.get(j) for j in range(axis.size)]
