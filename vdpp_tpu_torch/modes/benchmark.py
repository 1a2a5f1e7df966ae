"""Benchmark mode: pipeline, pipeline x data, or FSDP throughput (port of
``vdpp_tpu/modes/benchmark.py``).

    python -m vdpp_tpu_torch.modes.benchmark --model svd --num-stages 4 \\
        --total-steps 28 --num-samples 8 --warmup-samples 1
    python -m vdpp_tpu_torch.modes.benchmark --device cpu --model dummy --num-stages 2 \\
        --total-steps 4 --num-samples 2

The dummy or a diffusion model (weights and conditioning drawn in this
process from ``--seed`` and sent to the ranks as a CPU state dict), warm-up
and measured samples, fill, steady-state and throughput accounting, peak
memory per rank, and the ``BENCHMARK_JSON=`` stdout line of
``utils/bench_json.py``. Each rank is a process (``parallel/mesh.py``); one
rank runs in this process.

Timing, by mode:

* **ticked pipeline** (the default): ``StepPipeline.run_ticked`` times every
  tick on the last stage's host clock, each rank's card synchronised and all
  ranks at a barrier at the tick's end. Sample i completes at tick i + S - 1;
  :func:`tick_accounting` turns the ticks into the first sample's completion
  time and the mean per-sample gap after the warm-up samples. A rank's first
  steps are cold and fall in ticks 0 .. S - 1: a warm-up sample keeps them
  out of the steady figure.
* **--fused**: the JAX package times one jitted program of the whole
  schedule. PyTorch has no such program; the port maps the flag to
  ``StepPipeline.run``, which has no per-tick host barrier, and keeps JAX's
  derived accounting (:func:`fused_accounting`): ``first`` is the time of a
  run of D samples (one a data column), ``steady`` is (total - first) /
  (N - D), or total / N when N <= D, and throughput N / total. Each rank
  times its ``run`` from a barrier to the synchronisation of its card at the
  run's end; the last stages' clocks are taken (the slowest column).
  ``--data-parallel-size`` > 1 (a (stage, data) mesh) implies ``--fused``.
* **--fsdp**: ``FSDPRunner`` on a data mesh of ``--num-stages`` ranks, every
  rank running every step of every sample, each sample timed on its own
  (fresh inputs, after the warm-up samples); the slowest rank's clock.

Peak memory is each rank's ``torch.cuda.max_memory_allocated`` since its
weights were loaded (``utils/memory.py``); on the CPU 0.0 with the source
``"unavailable"``. ``--profile-dir`` writes each rank's ``torch.profiler``
trace of its warm-up and measured runs, closed before the JSON line.

``--seq-parallel N``, ``--frame-parallel N``, ``--cfg-parallel`` and
``--expert-parallel N`` make each stage a block of ranks on those axes
(``make_axes_mesh``, expert innermost; an svd model's step splits its
forwards over seq, frame and cfg, a DiT's over seq and cfg, and the MoE
DiT ``dit3d_moe_tiny`` splits its experts over the expert axis: each rank
keeps its share, ``StepPipeline(param_spec=ops.moe.expert_layout)``, before
its modules reach the card), and the mode string grows ``_x_spN``,
``_x_fpN``, ``_x_cfg`` and ``_x_epN`` as in the JAX package;
``world_size`` counts the stages.

``--weights-int8`` holds the svd and dit models' weights in int8
(``ops/quant.py``, per-output-channel scales); ``--weights-w8a8`` also marks
the big linear and spatial-conv weights for int8 activations and the int8
product. The weights are quantized here, after they are drawn (the log
says ``X -> Y MB of parameters``), and the ranks build their modules in the
int8 form, so no rank holds the float copy.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import logging
import os
import sys
import tempfile
import time
from collections.abc import Callable

import torch
from torch import nn

from vdpp_tpu_torch.ops.moe import expert_layout
from vdpp_tpu_torch.ops.quant import load_int8_forms, quantize_model
from vdpp_tpu_torch.parallel.data_parallel import FSDPRunner
from vdpp_tpu_torch.parallel.mesh import (
    Stage,
    make_2d_mesh,
    make_axes_mesh,
    make_data_mesh,
    make_pipeline_mesh,
    run_stages,
)
from vdpp_tpu_torch.parallel.pipeline import PipelineConfig, StepPipeline
from vdpp_tpu_torch.utils.bench_json import benchmark_results_dict, emit_benchmark_json
from vdpp_tpu_torch.utils.device import resolve_device
from vdpp_tpu_torch.utils.logging import setup_logging, stage_logger
from vdpp_tpu_torch.utils.memory import (
    bundle_modules,
    params_bytes_per_device,
    peak_memory_gb,
    peak_memory_source,
    reset_peak_memory,
)
from vdpp_tpu_torch.utils.profiling import device_trace

LOGGER = logging.getLogger("vdpp_torch.benchmark")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="dummy",
                   choices=["dummy", "svd", "svd_tiny", "dit", "dit_tiny",
                            "dit3d", "dit3d_tiny", "dit3d_moe_tiny"])
    p.add_argument("--num-stages", type=int, default=None,
                   help="stages (with --fsdp: ranks); default every card, 1 on the CPU")
    p.add_argument("--total-steps", type=int, default=28)
    p.add_argument("--num-samples", type=int, default=4)
    p.add_argument("--warmup-samples", type=int, default=1)
    p.add_argument("--latent-shape", type=int, nargs=5, default=[1, 8, 4, 16, 16],
                   metavar=("B", "C", "F", "H", "W"))
    p.add_argument("--hidden-channels", type=int, default=16, help="dummy model width")
    p.add_argument("--guidance-scale", type=float, default=None)
    p.add_argument("--fsdp", action="store_true",
                   help="parameter-sharded mode: all ranks, all steps")
    p.add_argument("--data-parallel-size", type=int, default=1,
                   help="(stage x data) mesh: each of the D data columns runs its own "
                        "pipeline over its block of the samples (implies --fused)")
    p.add_argument("--cfg-parallel", action="store_true",
                   help="CFG branches on a size-2 cfg axis per stage (svd and dit models)")
    p.add_argument("--seq-parallel", type=int, default=1,
                   help="sharding width per stage: the latent's W axis with halo exchanges "
                        "(svd models) or the tokens (dit models)")
    p.add_argument("--frame-parallel", type=int, default=1,
                   help="frame-axis sharding width per stage (svd models)")
    p.add_argument("--expert-parallel", type=int, default=1,
                   help="expert-axis width per stage (MoE dit models): the expert stacks "
                        "split over an expert axis (ops/moe.py)")
    p.add_argument("--deepcache", type=int, default=0, metavar="N",
                   help="svd models: full UNet every N steps, shallow levels only in "
                        "between (0 = off; changes outputs)")
    p.add_argument("--deepcache-split", type=int, default=1,
                   help="shallow levels the cache steps still compute")
    p.add_argument("--weights-int8", action="store_true",
                   help="weight-only int8 quantization (halves parameter bytes; ops/quant.py)")
    p.add_argument("--weights-w8a8", action="store_true",
                   help="W8A8: int8 weights plus int8 activations and the int8 product at "
                        "the big linear and spatial-conv sites (changes numerics)")
    p.add_argument("--fused", action="store_true",
                   help="time StepPipeline.run (no per-tick barrier; derived per-sample times)")
    add_device_args(p)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-level", default="INFO")
    p.add_argument("--profile-dir", default=None,
                   help="write each rank's torch.profiler trace of the warm-up and measured "
                        "runs here (trace_rank{r}.json)")
    return p


def add_device_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--devices", nargs="+", default=None, metavar="DEV",
                   help="an explicit device per rank, in rank order; a card named more than "
                        "once is shared by its ranks over gloo")


# ---- models: drawn here, built on each rank from a CPU state dict ---- #


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _cpu_state(module: nn.Module) -> dict[str, torch.Tensor]:
    return {k: v.cpu() for k, v in module.state_dict().items()}


def _loaded(module: nn.Module, state: dict) -> nn.Module:
    """``module`` (built on the meta device) holding ``state``'s tensors, in
    the int8 form where ``state`` holds one."""
    load_int8_forms(module, state)
    module.load_state_dict(state, assign=True)
    return module


def _dummy_build(model_kw: dict, state: dict, device: torch.device):
    from vdpp_tpu_torch.models.dummy_unet import DummyUNet

    return _dummy_step, _loaded(DummyUNet(**model_kw, device="meta"), state)


def _dummy_step(model, x: torch.Tensor, step: int) -> torch.Tensor:
    return model(x, step)


def _svd_build(config, wrapper_kw: dict, cond, state: dict, device: torch.device,
               axes: dict | None = None):
    """``axes``: a rank's ``Stage.axes`` (its seq, frame and cfg axes)."""
    from vdpp_tpu_torch.models.svd_unet import SVDUNet
    from vdpp_tpu_torch.models.svd_wrapper import StableVideoUNet

    wrapper = StableVideoUNet(config, device=device, **wrapper_kw)
    unet = _loaded(SVDUNet(wrapper.config, device="meta"), state)
    return wrapper.pipeline_step_fn(**(axes or {})), (unet, _cond_to(cond, device))


def _dit_build(config, total_steps: int, context, guidance, state: dict,
               device: torch.device, axes: dict | None = None):
    """``axes``: a rank's ``Stage.axes`` (its seq, cfg and expert axes)."""
    from vdpp_tpu_torch.models.dit import DiTVideo, DiTVideoWrapper

    wrapper = DiTVideoWrapper(config, num_steps=total_steps, device=device)
    dit = _loaded(DiTVideo(config, device="meta"), state)
    return wrapper.pipeline_step_fn(**(axes or {})), (
        dit, context.to(device), None if guidance is None else guidance.to(device))


@dataclasses.dataclass(frozen=True)
class Model:
    """``build(state, device)`` gives ``(step_fn, params)`` holding the
    weights ``state`` (a CPU state dict), the modules on the CPU (the rank
    places or shards them); ``noise_shape`` is one sample's latent; ``pack``
    attaches the solver's and the cache's lanes."""

    build: Callable
    state: dict
    noise_shape: tuple[int, ...]
    pack: Callable | None
    name: str


def _state(module: nn.Module, args: argparse.Namespace) -> dict[str, torch.Tensor]:
    """The CPU state dict of ``module`` (weights drawn), quantized first under
    ``--weights-int8`` / ``--weights-w8a8`` (on the module's device), as the
    JAX package quantizes after its build, with its log line."""
    # (getattr: benchmark_data_parallel builds its models here, without these flags)
    w8a8 = getattr(args, "weights_w8a8", False)
    if getattr(args, "weights_int8", False) or w8a8:
        before = params_bytes_per_device(module)
        quantize_model(module, act_int8=w8a8)
        LOGGER.info("int8 weights%s: %.1f -> %.1f MB of parameters",
                    " + a8 activations" if w8a8 else "", before / 2**20,
                    params_bytes_per_device(module) / 2**20)
    return _cpu_state(module)


def build_model(args: argparse.Namespace, device: torch.device) -> Model:
    """The model of ``args.model``, its weights drawn on ``device`` from
    ``args.seed`` (and quantized under the int8 flags) and its conditioning
    from ``args.seed + 1``, with the JAX package's latent conventions: the
    dummy's ``(B, C, F, H, W)``, the others' channels-last ``(B, F, H, W,
    C)``."""
    b, c, f, h, w = args.latent_shape
    if args.model == "dummy":
        from vdpp_tpu_torch.models.dummy_unet import DummyUNet

        kw = dict(channels=c, hidden_channels=args.hidden_channels)
        state = _cpu_state(DummyUNet(**kw, device=device).init_weights(
            _generator(device, args.seed)))
        return Model(functools.partial(_dummy_build, kw), state, (b, c, f, h, w), None, "dummy")

    from vdpp_tpu_torch.models.svd_wrapper import make_guidance_ramp

    if args.model.startswith("dit"):
        from vdpp_tpu_torch.models.dit import DiTVideo, DiTVideoConfig

        config = {"dit_tiny": DiTVideoConfig.tiny, "dit": DiTVideoConfig.latte_xl,
                  "dit3d_tiny": DiTVideoConfig.joint3d_tiny,
                  "dit3d": DiTVideoConfig.joint3d_xl,
                  "dit3d_moe_tiny": DiTVideoConfig.moe_tiny}[args.model]()
        state = _state(DiTVideo(config, device=device).init_weights(
            _generator(device, args.seed)), args)
        ctx = torch.randn(b, 2, config.cross_attention_dim, device=device,
                          generator=_generator(device, args.seed + 1)).cpu()
        build = functools.partial(_dit_build, config, args.total_steps, ctx,
                                  make_guidance_ramp(args.guidance_scale, f))
        return Model(build, state, (b, f, h, w, config.in_channels), None, args.model)

    from vdpp_tpu_torch.models.svd_unet import SVDUNet, SVDUNetConfig
    from vdpp_tpu_torch.models.svd_wrapper import StableVideoUNet, make_dummy_conditioning

    config = SVDUNetConfig.tiny() if args.model == "svd_tiny" else SVDUNetConfig.svd_xt()
    wrapper_kw = dict(num_steps=args.total_steps, deepcache_interval=args.deepcache,
                      deepcache_split=args.deepcache_split)
    state = _state(SVDUNet(config, device=device).init_weights(
        _generator(device, args.seed)), args)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    cond = _cond_to(make_dummy_conditioning(_generator(device, args.seed + 1), b, f, h, w,
                                            cross_dim=config.cross_attention_dim,
                                            guidance_scale=args.guidance_scale), "cpu")
    # The wrapper owns the payload layout ([x | cache lanes]); the cache
    # lanes start at zero and the first step is a full one.
    pack = StableVideoUNet(config, device="cpu", **wrapper_kw).pack_initial
    return Model(functools.partial(_svd_build, config, wrapper_kw, cond), state,
                 (b, f, h, w, 4), pack, args.model)


def seeded_inputs(model: Model, n: int, seed: int, device: torch.device) -> torch.Tensor:
    """``n`` standard-normal latents drawn on ``device`` from ``seed``,
    packed, on the CPU."""
    x = torch.randn((n, *model.noise_shape), device=device,
                    generator=_generator(device, seed)).cpu()
    return x if model.pack is None else model.pack(x)


def ship_state(state: dict, mesh, tmpdir: str) -> dict | str:
    """What the ranks are given of ``state``: the dict itself for one rank in
    this process, else the path of a file saved into ``tmpdir`` that each
    spawned rank maps (:func:`rank_state`). Pickled into every rank's
    start-up arguments instead, 1.5 GB of weights took 18.6 s to reach two
    CPU ranks, against 3.4 s through a file."""
    if mesh.world_size == 1:
        return state
    path = os.path.join(tmpdir, "state.pt")
    torch.save(state, path)
    return path


def rank_state(shipped: dict | str) -> dict:
    """The state dict :func:`ship_state` gave this rank."""
    if isinstance(shipped, str):
        return torch.load(shipped, mmap=True, weights_only=True)
    return shipped


def place(params, device: torch.device):
    """Move the bundle's modules to ``device`` (in place); returns it."""
    for m in bundle_modules(params):
        m.to(device)
    return params


def _cond_to(cond, device):
    """The SVD conditioning with its tensors on ``device``."""
    return dataclasses.replace(cond, **{f.name: getattr(cond, f.name).to(device)
                                        for f in dataclasses.fields(cond)
                                        if getattr(cond, f.name) is not None})


# ---- flags ---- #


def check_flags(args: argparse.Namespace) -> None:
    """The JAX package's argument checks, with its messages, before any rank
    starts."""
    sp, fp, ep = args.seq_parallel, args.frame_parallel, args.expert_parallel
    f = args.latent_shape[2]
    if args.deepcache and args.model not in ("svd_tiny", "svd"):
        raise SystemExit("--deepcache is implemented for the SVD UNet family only")
    if ep > 1 and args.model != "dit3d_moe_tiny":
        raise SystemExit("--expert-parallel needs an MoE model (dit3d_moe_tiny)")
    if fp > 1 and not args.model.startswith("svd"):
        raise SystemExit("--frame-parallel needs an svd model (frame axis)")
    if fp > 1 and f % fp != 0:
        raise SystemExit(f"--frame-parallel {fp}: frame count {f} must divide by it")
    if args.cfg_parallel and args.guidance_scale is None:
        raise SystemExit("--cfg-parallel needs --guidance-scale (CFG active)")
    if args.model == "dummy" and (args.cfg_parallel or sp > 1):
        raise SystemExit("--cfg-parallel/--seq-parallel need a CFG/transformer model "
                         "(svd*/dit*)")
    if (args.weights_int8 or args.weights_w8a8) and args.model == "dummy":
        raise SystemExit("--weights-int8/--weights-w8a8 need the svd/dit model families "
                         "(DummyUNet's OIDHW conv layout has no int8 dispatch)")
    multi_axis = sp > 1 or fp > 1 or args.cfg_parallel or ep > 1
    if args.fsdp and multi_axis:
        raise SystemExit("--fsdp runs every step on every device (no stage axis); drop "
                         "--seq-parallel/--frame-parallel/--cfg-parallel/--expert-parallel")
    if not args.fsdp and args.data_parallel_size > 1 and multi_axis:
        raise SystemExit("--data-parallel-size composes with the stage axis only; drop "
                         "--seq-parallel/--frame-parallel/--cfg-parallel/--expert-parallel")
    if sp > 1 and args.model.startswith("svd"):
        from vdpp_tpu_torch.models.svd_unet import SVDUNetConfig

        config = SVDUNetConfig.tiny() if args.model == "svd_tiny" else SVDUNetConfig.svd_xt()
        w = args.latent_shape[4]
        if w % config.seq_min_divisor(sp):
            raise SystemExit(f"--seq-parallel {sp}: latent width {w} must be divisible by sp x "
                             f"2^(levels-1) = {config.seq_min_divisor(sp)} (halo-exchange W "
                             "sharding)")


def inner_axes(args: argparse.Namespace) -> dict[str, int]:
    """The intra-sample axes of the flags, sizes above 1 only."""
    axes = {"seq": args.seq_parallel, "frame": args.frame_parallel,
            "cfg": 2 if args.cfg_parallel else 1, "expert": args.expert_parallel}
    return {k: n for k, n in axes.items() if n > 1}


def _mesh(args: argparse.Namespace):
    """The mesh of the mode: a data mesh for FSDP, (stage, data) for
    ``--data-parallel-size`` > 1, (stage, seq, frame, cfg, expert) with an
    intra-sample axis, else the stage axis. A bad split or an indivisible
    sample count raises here, before any rank starts."""
    dp, total_n = args.data_parallel_size, args.num_samples + args.warmup_samples
    kw = dict(device=args.device, devices=args.devices)
    if args.fsdp:
        return make_data_mesh(args.num_stages, **kw)
    if dp > 1:
        if not args.fused:
            LOGGER.info("2-D (stage x data) mesh runs the fused executor")
            args.fused = True
        if args.num_stages is None:
            if args.devices is not None:
                ranks = len(args.devices)
            else:
                dev = resolve_device(args.device)
                ranks = torch.cuda.device_count() if dev.type == "cuda" else dp
            args.num_stages = ranks // dp
        if total_n % dp != 0:
            raise SystemExit(f"--num-samples + --warmup-samples ({total_n}) must be "
                             f"divisible by --data-parallel-size ({dp})")
        mesh = make_2d_mesh(args.num_stages, dp, **kw)
    elif inner_axes(args):
        mesh = make_axes_mesh(args.num_stages, **inner_axes(args), **kw)
    else:
        mesh = make_pipeline_mesh(args.num_stages, **kw)
    PipelineConfig(args.total_steps, mesh.num_stages)
    return mesh


# ---- accounting ---- #


def tick_accounting(tick_times, num_stages: int, warmup_samples: int):
    """``(first, steady, throughput, per_sample_ms)`` of a ticked run: sample
    i completes at tick i + S - 1, ``first`` is sample 0's completion time,
    ``steady`` the mean per-sample gap after the warm-up samples (the JAX
    package's formulas)."""
    completion, acc = [], 0.0
    for t, dt in enumerate(tick_times):
        acc += dt
        if t >= num_stages - 1:
            completion.append(acc)
    per_sample = [completion[i] - (completion[i - 1] if i else 0.0)
                  for i in range(len(completion))]
    first = completion[0]
    measured = per_sample[warmup_samples:]
    steady = sum(measured) / len(measured) if measured else 0.0
    throughput = 1.0 / steady if steady else 0.0
    return first, steady, throughput, [t * 1e3 for t in per_sample]


def fused_accounting(first: float, total: float, total_n: int, dp: int):
    """``(first, steady, throughput, per_sample_ms)`` of an untimed-ticks run:
    ``first`` timed on ``dp`` samples, ``total`` on all ``total_n``; in the
    steady state ``dp`` samples finish a tick-period (the JAX package's
    formulas)."""
    if total_n > dp:
        steady = (total - first) / (total_n - dp)
    else:
        # One tick-batch holds the whole stream: there is no steady phase,
        # and total - first is the noise of two runs of the same work.
        steady = total / total_n
    return first, steady, total_n / total, [first * 1e3] * dp + [steady * 1e3] * (total_n - dp)


# ---- one rank ---- #


@dataclasses.dataclass(frozen=True)
class Job:
    """What every rank runs: ``mode`` is ``"ticked"``, ``"fused"`` or
    ``"fsdp"``; ``inputs`` holds the warm-up samples then the measured ones;
    ``fresh`` the fused mode's timed samples, ``warm`` FSDP's warm-up sample
    when there are no warm-up samples; ``state`` the weights as
    :func:`ship_state` gives them."""

    mode: str
    build: Callable
    state: dict | str
    total_steps: int
    warmup_samples: int
    inputs: torch.Tensor
    fresh: torch.Tensor | None
    warm: torch.Tensor | None
    profile_dir: str | None
    log_level: str


def timed(stage: Stage, fn) -> float:
    """Host seconds of ``fn()``, started with every rank at a barrier and
    ended with this rank's card synchronised."""
    stage.barrier()
    t0 = time.perf_counter()
    fn()
    if stage.device.type == "cuda":
        torch.cuda.synchronize(stage.device)
    return time.perf_counter() - t0


def _ticked(stage: Stage, job: Job, pipe: StepPipeline, params) -> dict:
    res = pipe.run_ticked(params, job.inputs)
    return {} if res is None else {"ticks": res[1]}


def _fused(stage: Stage, job: Job, pipe: StepPipeline, params) -> dict:
    dp = stage.mesh.num_data
    pipe.run(params, job.inputs[:dp])  # warm-up: one sample a column, then all
    pipe.run(params, job.inputs)
    first = timed(stage, lambda: pipe.run(params, job.fresh[:dp]))
    total = timed(stage, lambda: pipe.run(params, job.fresh))
    return {"first": first, "total": total} if stage.is_last else {}


def _fsdp(stage: Stage, job: Job, step_fn, params, runner: FSDPRunner) -> dict:
    n = job.warmup_samples
    for i in range(n):
        runner.run(params, job.inputs[i:i + 1])
    if not n:
        runner.run(params, job.warm)
    # A fresh sample for each timed run, never a warm-up one.
    per_sample = [timed(stage, lambda j=j: runner.run(params, job.inputs[j:j + 1]))
                  for j in range(n, len(job.inputs))]
    return {"per_sample": per_sample}


def rank_main(stage: Stage, job: Job) -> dict:
    """One rank: build the model from the state dict, lay it out (its
    experts on an expert axis) and place it, or shard it (FSDP), reset the
    card's peak, run the mode (traced with ``profile_dir``), and return its
    timings and peak GB."""
    if stage.mesh.world_size > 1:  # a spawned rank starts with no logging set up
        setup_logging(job.log_level)
    log = stage_logger(LOGGER.name, stage.rank)
    axes = {"axes": stage.axes} if stage.mesh.inner > 1 else {}
    step_fn, params = job.build(rank_state(job.state), stage.device, **axes)
    runner = pipe = None
    if job.mode == "fsdp":
        runner = FSDPRunner(stage, step_fn, job.total_steps)
        runner.shard_params(params)
    else:
        pipe = StepPipeline(stage, step_fn, PipelineConfig(job.total_steps, stage.num_stages),
                            param_spec=expert_layout if stage.expert is not None else None)
        place(pipe.layout(params), stage.device)
    reset_peak_memory(stage.device)
    log.info("%s on %s, stage %d of column %d, %.1f MB of parameters", job.mode, stage.device,
             stage.index, stage.column, params_bytes_per_device(params) / 2**20)
    trace = (device_trace(job.profile_dir, stage.rank, stage.device) if job.profile_dir
             else contextlib.nullcontext())
    with trace:
        if runner is not None:
            out = _fsdp(stage, job, step_fn, params, runner)
        else:
            out = (_fused if job.mode == "fused" else _ticked)(stage, job, pipe, params)
    return {"peak_gb": peak_memory_gb(stage.device), **out}


def run_ranks(mesh, fn, *args) -> list:
    """``fn(stage, *args)`` on every rank of ``mesh``: in this process for one
    rank, else one spawned process each; the results in rank order."""
    if mesh.world_size == 1:
        return [fn(Stage(mesh, 0), *args)]
    return run_stages(mesh, fn, *args)


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    setup_logging(args.log_level)
    check_flags(args)
    mesh = _mesh(args)
    dev = mesh.devices[0]
    model = build_model(args, dev)
    total_n = args.num_samples + args.warmup_samples
    dp = 1 if args.fsdp else args.data_parallel_size
    mode = "fsdp" if args.fsdp else "fused" if args.fused else "ticked"
    inputs = seeded_inputs(model, total_n, args.seed + 2, dev)
    LOGGER.info("benchmark: %s, %s, %d rank(s) (%d stage(s) x %d column(s), %s), %d steps, "
                "%d + %d samples", model.name, mode, mesh.world_size, mesh.num_stages,
                mesh.num_data, mesh.backend, args.total_steps, args.warmup_samples,
                args.num_samples)
    with tempfile.TemporaryDirectory(prefix="vdpp_bench_") as tmp:
        job = Job(mode=mode, build=model.build, state=ship_state(model.state, mesh, tmp),
                  total_steps=args.total_steps, warmup_samples=args.warmup_samples,
                  inputs=inputs,
                  fresh=(seeded_inputs(model, total_n, args.seed + 3, dev) if mode == "fused"
                         else None),
                  warm=(seeded_inputs(model, 1, args.seed + 4, dev)
                        if mode == "fsdp" and not args.warmup_samples else None),
                  profile_dir=args.profile_dir, log_level=args.log_level)
        ranks = run_ranks(mesh, rank_main, job)

    if mode == "fsdp":
        per_sample = [max(ts) for ts in zip(*(r["per_sample"] for r in ranks))]
        first = per_sample[0]
        steady = sum(per_sample) / len(per_sample)
        throughput = 1.0 / steady if steady else 0.0
        per_sample_ms = [t * 1e3 for t in per_sample]
        world, steps_per_device, mode_name = mesh.num_data, args.total_steps, "fsdp"
    else:
        world = mesh.num_stages
        steps_per_device = args.total_steps // world
        mode_name = "pipeline" if dp == 1 else "pipeline_x_dp"
        inner = inner_axes(args)
        mode_name += "".join(f"_x_{tag}{inner[k] if k != 'cfg' else ''}"
                             for k, tag in (("seq", "sp"), ("frame", "fp"), ("cfg", "cfg"),
                                            ("expert", "ep"))
                             if k in inner)
        if mode == "fused":
            first, steady, throughput, per_sample_ms = fused_accounting(
                max(r["first"] for r in ranks if "first" in r),
                max(r["total"] for r in ranks if "total" in r), total_n, dp)
        else:
            first, steady, throughput, per_sample_ms = tick_accounting(
                ranks[-1]["ticks"], world, args.warmup_samples)
    results = benchmark_results_dict(
        world_size=world,
        total_steps=args.total_steps,
        steps_per_device=steps_per_device,
        model=model.name,
        mode=mode_name,
        num_samples_measured=args.num_samples,
        warmup_samples=args.warmup_samples,
        latent_shape=args.latent_shape,
        first_sample_time_s=first,
        avg_sample_time_s=steady,
        throughput_samples_per_s=throughput,
        per_sample_times_ms=per_sample_ms,
        peak_memory_gb_per_device=[r["peak_gb"] for r in ranks],
        extra={
            # per data column: N / D samples through an S-deep pipeline
            "bubble_fraction": (0.0 if args.fsdp else round(
                PipelineConfig(args.total_steps, world).bubble_fraction(total_n // dp), 4)),
            "data_parallel_size": dp,
            "platform": "gpu" if dev.type == "cuda" else "cpu",
            "peak_memory_source": peak_memory_source(dev),
        },
    )
    emit_benchmark_json(results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
