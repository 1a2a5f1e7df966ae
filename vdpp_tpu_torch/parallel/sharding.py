"""Which parameter tensors FSDP shards, and along which axis (port of
``vdpp_tpu/parallel/sharding.py``).

The JAX package writes FSDP as a sharding annotation: every large parameter
leaf is split along one axis over a mesh axis and XLA inserts the
all-gathers. The port keeps its rule and applies it to a module's
``state_dict`` tensors: shard the largest axis that the rank count divides
(ties to the trailing axis), and replicate leaves under
``DEFAULT_MIN_SHARD_PARAMS`` elements or with no such axis. Where the JAX
package returns a ``PartitionSpec``, the port returns the axis, or None for
a replicated tensor; ``parallel/data_parallel.py::FSDPRunner`` does the
sharding and the gathers.

Since the rule takes some axis the rank count divides, the bytes a rank
holds do not depend on the order of a tensor's axes: a conv weight stored
``(out, in, kh, kw)`` here and ``(kh, kw, in, out)`` in the JAX package
costs each rank the same bytes. The rule reads shapes only, so a weight held
in int8 (``ops/quant.py``: its ``<name>_q`` tensor and its scales) is split
and gathered like any other tensor, as the JAX package's specs are
dtype-agnostic.
"""

from __future__ import annotations

import math
from collections.abc import Mapping, Sequence

import torch

# Leaves smaller than this stay replicated (the original system's
# size-based auto-wrap threshold of 1M parameters).
DEFAULT_MIN_SHARD_PARAMS = 2**20


def leaf_spec(shape: Sequence[int], axis_size: int,
              min_params: int = DEFAULT_MIN_SHARD_PARAMS) -> int | None:
    """The axis to shard over ``axis_size`` ranks: the largest one that
    ``axis_size`` divides, ties going to the trailing axis; None (replicate)
    for small or indivisible leaves."""
    if math.prod(shape) < min_params:
        return None
    order = sorted(range(len(shape)), key=lambda i: (shape[i], i), reverse=True)
    for dim in order:
        if shape[dim] % axis_size == 0 and shape[dim] >= axis_size:
            return dim
    return None


def fsdp_specs(state_dict: Mapping[str, torch.Tensor], axis_size: int,
               min_params: int = DEFAULT_MIN_SHARD_PARAMS) -> dict[str, int | None]:
    """:func:`leaf_spec` of every tensor, by name."""
    return {name: leaf_spec(tuple(t.shape), axis_size, min_params)
            for name, t in state_dict.items()}


def sharded_size_bytes(state_dict: Mapping[str, torch.Tensor], specs: Mapping[str, int | None],
                       axis_size: int) -> int:
    """Parameter bytes each of ``axis_size`` ranks holds under ``specs``."""
    return sum(t.numel() * t.element_size() // (1 if specs[name] is None else axis_size)
               for name, t in state_dict.items())
