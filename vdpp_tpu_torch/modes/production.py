"""Production mode: pipelined SVD inference, one process per stage (port of
``vdpp_tpu/modes/production.py``).

    python -m vdpp_tpu_torch.modes.production --num-stages 2 --total-steps 24 \\
        --latent-shape 1 4 14 40 72 --num-samples 4 --guidance-scale 3.0
    python -m vdpp_tpu_torch.modes.production --device cpu --preset tiny --num-stages 2 \\
        --total-steps 4 --num-samples 2 --latent-shape 1 4 2 16 16 --ticked \\
        --state-path state.npz [--resume]

The SVD UNet (random weights from ``--seed``, or ``--checkpoint``, the JAX
package's ``.npz``), random conditioning from ``--seed + 1`` and per-sample
noise x ``init_noise_sigma`` from ``--seed + 2``, drawn with torch generators
on the first rank's device (the port never reproduces JAX's random stream),
packed for the solver's and DeepCache's cross-step state, through the step
pipeline: ``StepPipeline.run``, or with ``--ticked`` ``run_ticked``, which
times each tick. ``--state-path`` snapshots the pipeline state every
``--state-every`` ticks (``utils/resume.py``: the stage ring gathered to
the last rank and written there, in the JAX package's file format), and
``--resume`` continues from the snapshot, emitting the remaining samples bit
for bit as the uncut run does. A snapshot whose recorded run configuration
differs from this run's is refused.

Each rank is a process (``parallel/mesh.py``); one rank runs in this
process. ``--device``/``--devices`` take the place of ``--backend``.
``--seq-parallel``, ``--frame-parallel`` and ``--cfg-parallel`` make each
stage a block of ranks on those axes (``make_axes_mesh``), the snapshot and
resume included (a stage's ranks hold the same slot). ``--auto-topology
latency|throughput`` lets the mesh planner (``parallel/topology.py``) choose
the stage, seq, frame and cfg sizes (and ``--pad-schedule``) for
``len(--devices)`` ranks, or every visible card; with an explicit
``--num-stages`` or axis flag it is ignored, as in the reference.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys
import tempfile
import time

import torch

from vdpp_tpu_torch.models.svd_unet import SVDUNet, SVDUNetConfig
from vdpp_tpu_torch.models.svd_wrapper import (
    SVDConditioning,
    StableVideoUNet,
    make_dummy_conditioning,
)
from vdpp_tpu_torch.modes.benchmark import (
    _cond_to,
    _cpu_state,
    _generator,
    _loaded,
    add_device_args,
    rank_state,
    run_ranks,
    ship_state,
)
from vdpp_tpu_torch.parallel.mesh import Stage, make_axes_mesh
from vdpp_tpu_torch.parallel.pipeline import PipelineConfig, StepPipeline
from vdpp_tpu_torch.parallel.topology import plan_topology
from vdpp_tpu_torch.utils.device import resolve_device
from vdpp_tpu_torch.utils.kernels import launch_counts, launches_since
from vdpp_tpu_torch.utils.logging import setup_logging
from vdpp_tpu_torch.utils.resume import load_pipeline_state, save_pipeline_state

LOGGER = logging.getLogger("vdpp_torch.production")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--num-stages", type=int, default=None,
                   help="stages; default every card, 1 on the CPU")
    p.add_argument("--total-steps", type=int, default=24)
    p.add_argument("--num-samples", type=int, default=1)
    p.add_argument("--latent-shape", type=int, nargs=5, default=[1, 4, 14, 40, 72],
                   metavar=("B", "C", "F", "H", "W"))
    p.add_argument("--guidance-scale", type=float, default=None)
    p.add_argument("--cfg-mode", default="sequential", choices=["sequential", "batched"])
    p.add_argument("--solver", default="euler", choices=["euler", "euler_a", "heun", "dpmpp2m"])
    p.add_argument("--deepcache", type=int, default=0, metavar="N",
                   help="full UNet every N real steps, the shallow levels only in between "
                        "(0 = off; changes outputs)")
    p.add_argument("--deepcache-split", type=int, default=1,
                   help="shallow levels the cache steps still compute (1 = cheapest)")
    p.add_argument("--preset", default="svd_xt", choices=["svd_xt", "tiny"])
    p.add_argument("--checkpoint", default=None,
                   help="the UNet's weights as the JAX package's .npz (save_params); random "
                        "from --seed if omitted")
    p.add_argument("--fps", type=int, default=6)
    p.add_argument("--motion-bucket-id", type=int, default=127)
    p.add_argument("--noise-aug-strength", type=float, default=0.02)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--sampler-seed", type=int, default=0,
                   help="euler_a only: seed of the per-step injected noise")
    p.add_argument("--seq-parallel", type=int, default=1,
                   help="halo-exchange W sharding width per stage (latent W must divide by "
                        "sp x 2^(levels-1))")
    p.add_argument("--frame-parallel", type=int, default=1,
                   help="frame sharding width per stage (frames must divide by it)")
    p.add_argument("--auto-topology", default=None, choices=["latency", "throughput"],
                   help="pick the (stage, seq, frame, cfg) mesh for this objective "
                        "(parallel/topology.py); explicit --num-stages/--seq-parallel/"
                        "--frame-parallel/--cfg-parallel override it")
    p.add_argument("--cfg-parallel", action="store_true",
                   help="the CFG branches on a size-2 cfg axis per stage")
    p.add_argument("--ticked", action="store_true",
                   help="host-stepped schedule with per-tick timing")
    p.add_argument("--state-path", default=None,
                   help="with --ticked: snapshot the pipeline state (tick index + stage payload "
                        "ring) here every --state-every ticks (utils/resume.py)")
    p.add_argument("--state-every", type=int, default=None,
                   help="ticks between snapshots (default every tick)")
    p.add_argument("--resume", action="store_true",
                   help="resume from --state-path if it exists (emits the remaining samples "
                        "bit for bit)")
    p.add_argument("--pad-schedule", action="store_true",
                   help="allow total-steps not divisible by the stage count by prepending "
                        "exact-identity steps")
    add_device_args(p)
    p.add_argument("--log-level", default="INFO")
    return p


def _config(args: argparse.Namespace) -> SVDUNetConfig:
    return SVDUNetConfig.tiny() if args.preset == "tiny" else SVDUNetConfig.svd_xt()


def device_count(args: argparse.Namespace) -> int:
    """The ranks the devices give: ``len(--devices)``, else every visible
    card (one rank on the CPU)."""
    if args.devices is not None:
        return len(args.devices)
    return torch.cuda.device_count() if resolve_device(args.device).type == "cuda" else 1


def auto_topology(args: argparse.Namespace) -> list:
    """``--auto-topology``: the planner's plans for this run, best first, the
    top one applied to ``args`` (stage count, axes, ``--pad-schedule``) and
    logged with two runner-ups; [] when an explicit stage count or axis flag
    makes it ignored, as in the reference."""
    if not args.auto_topology:
        return []
    if args.num_stages or args.seq_parallel > 1 or args.frame_parallel > 1 or args.cfg_parallel:
        LOGGER.info("auto-topology ignored: explicit axis flags given")
        return []
    b, c, f, h, w = args.latent_shape
    plans = plan_topology(
        device_count(args), total_steps=args.total_steps, frames=f, latent_w=w,
        num_samples=args.num_samples, seq_min_divisor_unit=_config(args).seq_min_divisor(1),
        guidance=args.guidance_scale is not None, objective=args.auto_topology,
        deepcache_interval=args.deepcache)
    best = plans[0]
    LOGGER.info("auto-topology (%s): %s", args.auto_topology, best.describe())
    for alt in plans[1:3]:
        LOGGER.info("  runner-up: %s", alt.describe())
    args.num_stages = best.stage
    args.seq_parallel = best.seq
    args.frame_parallel = best.frame
    args.cfg_parallel = best.cfg == 2
    if best.padded_steps != args.total_steps:
        args.pad_schedule = True
    return plans


def check_flags(args: argparse.Namespace) -> None:
    """The JAX package's argument checks, with its messages, before any model
    is built or weight loaded; ``--auto-topology`` sets the axes first."""
    b, c, f, h, w = args.latent_shape
    if args.state_path and not args.ticked:
        raise SystemExit("--state-path needs --ticked (StepPipeline.run runs the whole "
                         "schedule without a host-visible state between ticks)")
    if args.resume and not args.state_path:
        raise SystemExit("--resume needs --state-path (where should the snapshot come from?)")
    if args.state_every is not None and not args.state_path:
        raise SystemExit("--state-every needs --state-path")
    auto_topology(args)
    if c != 4:
        # The UNet denoises 4 latent channels (the other 4 of its input are
        # the conditioning concat).
        raise SystemExit(f"--latent-shape C must be 4 for the SVD family, got {c}")
    sp, fp = args.seq_parallel, args.frame_parallel
    divisor = sp * 2 ** (len(_config(args).block_out_channels) - 1)
    if sp > 1 and w % divisor != 0:
        raise SystemExit(f"--seq-parallel {sp}: latent width {w} must divide by "
                         f"sp x 2^(levels-1) = {divisor}")
    if fp > 1 and f % fp != 0:
        raise SystemExit(f"--frame-parallel {fp}: frame count {f} must divide by it")
    if args.cfg_parallel and args.guidance_scale is None:
        raise SystemExit("--cfg-parallel needs --guidance-scale")


def run_meta(args: argparse.Namespace, total_steps: int, stages: int) -> dict:
    """Everything that shapes the run's inputs or its steps, recorded in a
    snapshot: the JAX package's 15 keys. A snapshot resumed under other
    flags would pass the buffer's shape check and mix old in-flight payloads
    with other fresh inputs and sigmas."""
    return {
        "total_steps": total_steps,
        "requested_steps": args.total_steps,  # a padded and a real schedule differ
        "pad_schedule": bool(args.pad_schedule),
        "stages": stages,
        "num_samples": args.num_samples,
        "seed": args.seed,
        "solver": args.solver,
        "sampler_seed": args.sampler_seed,  # euler_a's noise
        "deepcache": args.deepcache,
        "deepcache_split": args.deepcache_split,
        "latent_shape": list(args.latent_shape),
        "guidance_scale": args.guidance_scale,
        "cfg_mode": args.cfg_mode,
        "preset": args.preset,
        "checkpoint": args.checkpoint,
    }


def checkpoint_state(path: str, config: SVDUNetConfig) -> dict:
    """The UNet's state dict from the JAX package's ``.npz``, floating
    tensors cast to the config's dtype (as its ``load_params`` casts)."""
    from vdpp_tpu_torch.utils.weights import from_jax_params, load_jax_npz

    state = from_jax_params(load_jax_npz(path))
    return {k: v.to(config.dtype) if v.is_floating_point() else v for k, v in state.items()}


@dataclasses.dataclass(frozen=True)
class Job:
    """What every rank runs: the UNet of ``config`` holding ``state`` (as
    :func:`ship_state` gives it), the wrapper's arguments, the conditioning
    and packed inputs on the CPU, and the ticked run's snapshot settings
    (``resume_path``: the snapshot each rank takes its slot from)."""

    config: SVDUNetConfig
    wrapper_kw: dict
    state: dict | str
    cond: SVDConditioning
    inputs: torch.Tensor
    ticked: bool
    state_path: str | None
    state_every: int
    start_tick: int
    resume_path: str | None
    meta: dict
    log_level: str


def rank_main(stage: Stage, job: Job) -> dict:
    """One rank: build the wrapper and the UNet, run the pipeline. Every rank
    returns the kernels it launched in the run; the last rank also the
    packed outputs (CPU), the tick seconds, each snapshot's tick, gather and
    write seconds and bytes, and the run's seconds."""
    if stage.mesh.world_size > 1:  # a spawned rank starts with no logging set up
        setup_logging(job.log_level)
    if stage.device.type == "cuda":
        # The same bits in every process and every run, resumed or not.
        torch.backends.cudnn.deterministic = True
    wrapper = StableVideoUNet(job.config, device=stage.device, **job.wrapper_kw)
    unet = _loaded(SVDUNet(wrapper.config, device="meta"), rank_state(job.state))
    bundle = (unet.to(stage.device), _cond_to(job.cond, stage.device))
    pipe = StepPipeline(stage, wrapper.pipeline_step_fn(**stage.axes),
                        PipelineConfig(wrapper.num_steps, stage.num_stages))
    snapshots: list[dict] = []

    def on_tick(t: int, buf: torch.Tensor) -> None:
        t0 = time.perf_counter()
        save_pipeline_state(job.state_path, t, buf, meta=job.meta)
        snapshots.append({"tick": t, "seconds": time.perf_counter() - t0,
                          "bytes": os.path.getsize(job.state_path),
                          "gather_seconds": pipe.gather_seconds[-1]})

    initial_buf = load_pipeline_state(job.resume_path)[1] if job.resume_path else None
    stage.barrier()
    before = launch_counts()
    t0 = time.perf_counter()
    ticks = None
    if job.ticked:
        res = pipe.run_ticked(bundle, job.inputs, start_tick=job.start_tick,
                              initial_buf=initial_buf,
                              on_tick=on_tick if job.state_path else None,
                              on_tick_every=job.state_every)
        out, ticks = res if res is not None else (None, None)
    else:
        out = pipe.run(bundle, job.inputs)
    seconds = time.perf_counter() - t0
    launched = launches_since(before)
    if not stage.is_last:
        return {"launches": launched}
    return {"launches": launched, "out": out.cpu(), "ticks": ticks, "snapshots": snapshots,
            "seconds": seconds}


def run(args: argparse.Namespace, state: dict | None = None,
        cond: SVDConditioning | None = None, inputs: torch.Tensor | None = None) -> dict:
    """The production run of ``args``. ``state`` (the UNet's state dict),
    ``cond`` (the conditioning) and ``inputs`` (the initial latents
    ``(N, B, F, H, W, 4)``, noise x init_noise_sigma, before packing), all on
    the CPU, replace the draws from ``--seed`` when given. Returns the
    finished latents unpacked (``"out"``, the samples from ``"first_sample"``
    on), the tick seconds, the snapshots written and the run's seconds."""
    check_flags(args)
    b, c, f, h, w = args.latent_shape
    sp, fp = args.seq_parallel, args.frame_parallel
    mesh = make_axes_mesh(args.num_stages, sp, fp, 2 if args.cfg_parallel else 1,
                          device=args.device, devices=args.devices)
    stages = mesh.num_stages
    dev = mesh.devices[0]
    config = _config(args)
    wrapper_kw = dict(num_steps=args.total_steps, cfg_mode=args.cfg_mode,
                      pad_steps_to=stages if args.pad_schedule else None, solver=args.solver,
                      sampler_seed=args.sampler_seed, deepcache_interval=args.deepcache,
                      deepcache_split=args.deepcache_split)
    wrapper = StableVideoUNet(config, device="cpu", **wrapper_kw)
    PipelineConfig(wrapper.num_steps, stages)  # a bad split raises before any weight is drawn
    LOGGER.info("production: %d stages (%s; seq %d, frame %d, cfg %d a stage), %d steps, latent "
                "(B,C,F,H,W)=%s, preset=%s, CFG=%s", stages, mesh.backend, mesh.seq, mesh.frame,
                mesh.cfg, args.total_steps, tuple(args.latent_shape), args.preset,
                args.guidance_scale)
    if wrapper.num_steps != args.total_steps:
        LOGGER.info("schedule padded %d -> %d steps (exact identity steps) for %d stages",
                    args.total_steps, wrapper.num_steps, stages)

    meta = run_meta(args, wrapper.num_steps, stages)
    start_tick, resume_path, first_sample = 0, None, 0
    if args.ticked and args.resume and os.path.exists(args.state_path):
        last_tick, _, snap_meta = load_pipeline_state(args.state_path)
        # Every key the snapshot recorded (older snapshots carry fewer).
        mismatch = {k: (v, meta.get(k)) for k, v in snap_meta.items() if meta.get(k) != v}
        if mismatch:
            raise SystemExit("--resume: snapshot was written by a different run configuration "
                             f"(snapshot vs current): {mismatch}")
        start_tick, resume_path = last_tick + 1, args.state_path
        first_sample = max(start_tick - (stages - 1), 0)
        LOGGER.info("resuming at tick %d (samples %d.. remain; %s)", start_tick, first_sample,
                    snap_meta)

    t0 = time.perf_counter()
    if state is None:
        if args.checkpoint:
            state = checkpoint_state(args.checkpoint, config)
        else:
            state = _cpu_state(SVDUNet(config, device=dev).init_weights(
                _generator(dev, args.seed)))
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    LOGGER.info("weights ready in %.1fs (%s)", time.perf_counter() - t0,
                "checkpoint" if args.checkpoint else "random init")
    if cond is None:
        cond = make_dummy_conditioning(
            _generator(dev, args.seed + 1), b, f, h, w, cross_dim=config.cross_attention_dim,
            guidance_scale=args.guidance_scale, fps=args.fps,
            motion_bucket_id=args.motion_bucket_id, noise_aug_strength=args.noise_aug_strength)
    if inputs is None:
        inputs = torch.randn((args.num_samples, b, f, h, w, c), device=dev,
                             generator=_generator(dev, args.seed + 2)) * wrapper.init_noise_sigma
    # dpmpp2m's multistep state and DeepCache's cache ride the payload's channels.
    packed = wrapper.pack_initial(inputs.cpu())

    with tempfile.TemporaryDirectory(prefix="vdpp_production_") as tmp:
        job = Job(config=config, wrapper_kw=wrapper_kw, state=ship_state(state, mesh, tmp),
                  cond=_cond_to(cond, "cpu"), inputs=packed, ticked=args.ticked,
                  state_path=args.state_path, state_every=max(args.state_every or 1, 1),
                  start_tick=start_tick, resume_path=resume_path, meta=meta,
                  log_level=args.log_level)
        ranks = run_ranks(mesh, rank_main, job)
    last = ranks[-1]

    ticks = last["ticks"] or []
    for i, dt in enumerate(ticks):
        LOGGER.info("tick %d: %.1f ms", start_tick + i, dt * 1e3)
    for r, res in enumerate(ranks):
        counts = res["launches"]
        if counts["flash"] or counts["group_norm_silu"] or counts["frame_attention"]:
            LOGGER.info("rank %d on %s launched: flash %s, GroupNorm+SiLU %d, frame attention "
                        "%d", r, mesh.devices[r], counts["flash"], counts["group_norm_silu"],
                        counts["frame_attention"])
    for snap in last["snapshots"]:
        LOGGER.info("snapshot after tick %d: %d bytes, gathered in %.3f ms, written in %.3f ms",
                    snap["tick"], snap["bytes"], snap["gather_seconds"] * 1e3,
                    snap["seconds"] * 1e3)
    out = wrapper.unpack_final(last["out"])
    emitted = out.shape[0]
    for i in range(emitted):
        LOGGER.info("sample %d final latent norm: %.3f", first_sample + i,
                    float(torch.linalg.vector_norm(out[i].float())))
    seconds = last["seconds"]
    LOGGER.info("%d samples in %.2fs (%.2fs/video incl. warm-up; bubble %.1f%%)", emitted,
                seconds, seconds / max(emitted, 1),
                100 * PipelineConfig(wrapper.num_steps, stages).bubble_fraction(args.num_samples))
    return {"out": out, "first_sample": first_sample, "ticks": ticks,
            "snapshots": last["snapshots"], "seconds": seconds, "stages": stages,
            "launches": [res["launches"] for res in ranks]}


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    setup_logging(args.log_level)
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
