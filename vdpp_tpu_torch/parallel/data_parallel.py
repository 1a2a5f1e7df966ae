"""The data-parallel baseline and FSDP (port of
``vdpp_tpu/parallel/data_parallel.py``), one process per rank.

* :class:`DataParallelRunner`, the original system's baseline with no
  communication: each rank of a data mesh holds the whole model and runs
  every step of its contiguous block of the samples. The caller gathers the
  blocks (``run_stages`` returns them in rank order).
* :class:`FSDPRunner`, the memory-wall mode: every rank runs every step of
  every sample, and each parameter tensor that ``parallel/sharding.py``
  shards lives on a rank only as its 1/D slice. A tensor is all-gathered
  when a forward reads it and freed when that forward ends. The JAX package
  writes this as a sharding annotation and lets XLA place the gathers; here
  they are ``dist.all_gather_into_tensor`` calls made from the modules'
  forward hooks. The gather is an exact copy, so the output equals the
  single-device run bit for bit.

``torch.distributed.fsdp.fully_shard`` is not used: it shards axis 0 only,
so its bytes per rank and its gathers would not be the JAX rule's, against
which the memory figures are compared.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from vdpp_tpu_torch.parallel.mesh import Stage
from vdpp_tpu_torch.parallel.pipeline import StepFn, run_reference_single_device
from vdpp_tpu_torch.parallel.sharding import DEFAULT_MIN_SHARD_PARAMS, fsdp_specs
from vdpp_tpu_torch.utils.memory import bundle_modules

SHARD_SUFFIX = "_fsdp_shard"


class DataParallelRunner:
    """All steps on every rank, a disjoint block of samples per rank."""

    def __init__(self, stage: Stage, step_fn: StepFn, total_steps: int):
        if stage.num_stages != 1:
            raise ValueError(f"a data mesh has one stage, not {stage.num_stages}")
        self.stage = stage
        self.step_fn = step_fn
        self.total_steps = total_steps

    def run(self, params, inputs: torch.Tensor) -> torch.Tensor:
        """``inputs (N, *latent)`` on every rank, N divisible by the rank
        count; returns this rank's finished block of N / D samples on its
        device."""
        mine = self.stage.column_shard(inputs).to(self.stage.device)
        out = run_reference_single_device(self.step_fn, params, mine, self.total_steps)
        if self.stage.device.type == "cuda":
            torch.cuda.synchronize(self.stage.device)
        return out


class _Gathering:
    """Mixed into the class of a module that holds shards: reading a sharded
    tensor's name gathers it (``nn.Module.__getattr__`` runs only when the
    attribute is not in the instance's ``__dict__``, where the gathered
    tensor stays until its forward ends)."""

    def __getattr__(self, name: str):
        runner = self.__dict__.get("_fsdp_runner")
        if runner is not None and name in self.__dict__["_fsdp_dims"]:
            return runner.gather(self, name)
        return super().__getattr__(name)


_GATHERING_CLASSES: dict[type, type] = {}


def _gathering_class(cls: type) -> type:
    if cls not in _GATHERING_CLASSES:
        _GATHERING_CLASSES[cls] = type(cls.__name__, (_Gathering, cls), {})
    return _GATHERING_CLASSES[cls]


class FSDPRunner:
    """Every rank runs every step of every sample; parameters sharded.

    :meth:`shard_params` replaces each tensor that ``fsdp_specs`` shards by
    this rank's slice along the chosen axis (a parameter named
    ``<name>_fsdp_shard``, laid out with that axis first) and moves the
    modules to the rank's card. In a forward, the first read of
    ``module.<name>`` gathers the slices into the full tensor (the axis moved
    to the front, ``dist.all_gather_into_tensor``, moved back), and the
    forward hook of the innermost module running at that moment frees it when
    that module's forward returns; a read made outside every module's forward
    (a model's method called directly) is freed when the step returns. The
    gather happens at the read and not in a pre-hook, because the port's ops
    read a layer's weights off the module (``conv2d(h, self.conv1)``): which
    tensors a forward needs is known only as it reads them.
    """

    def __init__(self, stage: Stage, step_fn: StepFn, total_steps: int,
                 min_shard_params: int = DEFAULT_MIN_SHARD_PARAMS):
        if stage.num_stages != 1:
            raise ValueError(f"FSDP runs on a data mesh (one stage), not {stage.num_stages}")
        self.stage = stage
        self.step_fn = step_fn
        self.total_steps = total_steps
        self.min_shard_params = min_shard_params
        # One list per module forward running now, of the (owner, name)
        # gathered in it; the last entry collects reads outside any forward.
        self._frames: list[list[tuple[nn.Module, str]]] = [[]]

    @property
    def num_shards(self) -> int:
        return self.stage.mesh.num_data

    def specs_for(self, module: nn.Module) -> dict[str, int | None]:
        """The axis each of ``module``'s state-dict tensors is sharded along
        (None: replicated)."""
        return fsdp_specs(module.state_dict(), self.num_shards, self.min_shard_params)

    def shard_params(self, params):
        """Shard the bundle's modules in place (once) and move them to this
        rank's device; returns ``params``."""
        for module in bundle_modules(params):
            if module.__dict__.get("_fsdp_root") is not self:
                self._shard(module)
        return params

    def _shard(self, module: nn.Module) -> None:
        specs, d, r = self.specs_for(module), self.num_shards, self.stage.column
        for full_name, dim in specs.items():
            if dim is None:
                continue
            owner_name, _, name = full_name.rpartition(".")
            owner = module.get_submodule(owner_name)
            full = owner._parameters.pop(name)
            shard = full.detach().movedim(dim, 0).chunk(d)[r].contiguous()
            owner.register_parameter(name + SHARD_SUFFIX, nn.Parameter(shard, requires_grad=False))
            if "_fsdp_dims" not in owner.__dict__:
                owner.__class__ = _gathering_class(type(owner))
                owner.__dict__["_fsdp_dims"] = {}
                owner.__dict__["_fsdp_runner"] = self
            owner.__dict__["_fsdp_dims"][name] = dim
        for m in module.modules():
            m.register_forward_pre_hook(self._enter)
            m.register_forward_hook(self._leave)
        module.to(self.stage.device)
        module.__dict__["_fsdp_root"] = self

    def _enter(self, module, args) -> None:
        self._frames.append([])

    def _leave(self, module, args, output) -> None:
        self._free(self._frames.pop())

    @staticmethod
    def _free(entries) -> None:
        for owner, name in entries:
            owner.__dict__.pop(name, None)

    def gather(self, owner: nn.Module, name: str) -> torch.Tensor:
        """The full ``owner.<name>``, kept on ``owner`` until the innermost
        running forward returns."""
        dim = owner.__dict__["_fsdp_dims"][name]
        shard = owner._parameters[name + SHARD_SUFFIX].detach()
        if self.num_shards > 1:
            host = self.stage.mesh.host_handoff  # gloo: through host memory
            src = shard.cpu() if host else shard
            out = src.new_empty((self.num_shards * src.shape[0], *src.shape[1:]))
            dist.all_gather_into_tensor(out, src)
            shard = out.to(shard.device)
        full = shard.movedim(0, dim).contiguous()
        owner.__dict__[name] = full
        self._frames[-1].append((owner, name))
        return full

    def _step(self, params, x: torch.Tensor, k: int) -> torch.Tensor:
        out = self.step_fn(params, x, k)
        self._free(self._frames[0])  # reads outside any module's forward
        self._frames[0].clear()
        return out

    def run(self, params, inputs: torch.Tensor) -> torch.Tensor:
        """``inputs (N, *latent)``, the same on every rank; returns the
        finished ``(N, *latent)`` on this rank's device."""
        self.shard_params(params)
        try:
            out = run_reference_single_device(self._step, params,
                                              inputs.to(self.stage.device), self.total_steps)
        finally:  # a forward that raised left its frames open
            for frame in self._frames:
                self._free(frame)
            self._frames = [[]]
        if self.stage.device.type == "cuda":
            torch.cuda.synchronize(self.stage.device)
        return out
