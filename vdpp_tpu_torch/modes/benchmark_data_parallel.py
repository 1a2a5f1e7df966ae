"""Data-parallel baseline benchmark (port of
``vdpp_tpu/modes/benchmark_data_parallel.py``).

    python -m vdpp_tpu_torch.modes.benchmark_data_parallel --model svd --num-devices 4 \\
        --total-steps 28 --num-samples 8
    python -m vdpp_tpu_torch.modes.benchmark_data_parallel --device cpu --model dummy \\
        --num-devices 2 --total-steps 4 --num-samples 4

The original system's baseline: every rank (a process, ``parallel/mesh.py``)
holds the whole model and runs every step of its own block of the samples,
with no communication while it runs (``DataParallelRunner``). After the
warm-up rounds, one round of fresh samples is timed, each rank from a barrier
to the synchronisation of its card at the round's end, and the slowest rank's
clock is taken. Emits the ``BENCHMARK_JSON`` schema with ``"mode":
"data_parallel"``; a sample's latency is the whole schedule's time, total /
(N / D).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
import tempfile
from collections.abc import Callable

import torch

from vdpp_tpu_torch.modes.benchmark import (
    add_device_args,
    build_model,
    place,
    rank_state,
    run_ranks,
    seeded_inputs,
    ship_state,
    timed,
)
from vdpp_tpu_torch.parallel.data_parallel import DataParallelRunner
from vdpp_tpu_torch.parallel.mesh import Stage, make_data_mesh
from vdpp_tpu_torch.utils.bench_json import benchmark_results_dict, emit_benchmark_json
from vdpp_tpu_torch.utils.logging import setup_logging
from vdpp_tpu_torch.utils.memory import peak_memory_gb, peak_memory_source, reset_peak_memory

LOGGER = logging.getLogger("vdpp_torch.benchmark_dp")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="dummy", choices=["dummy", "svd", "svd_tiny"])
    p.add_argument("--num-devices", type=int, default=None,
                   help="ranks; default every card, 1 on the CPU")
    p.add_argument("--total-steps", type=int, default=28)
    p.add_argument("--num-samples", type=int, default=8,
                   help="must be divisible by num-devices")
    p.add_argument("--warmup-rounds", type=int, default=1)
    p.add_argument("--latent-shape", type=int, nargs=5, default=[1, 8, 4, 16, 16],
                   metavar=("B", "C", "F", "H", "W"))
    p.add_argument("--hidden-channels", type=int, default=16)
    p.add_argument("--guidance-scale", type=float, default=None)
    add_device_args(p)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-level", default="INFO")
    return p


@dataclasses.dataclass(frozen=True)
class Job:
    build: Callable
    state: dict | str
    total_steps: int
    warmup_rounds: int
    inputs: torch.Tensor
    fresh: torch.Tensor
    log_level: str


def rank_main(stage: Stage, job: Job) -> dict:
    """One rank: the warm-up rounds, then one timed round of fresh samples."""
    if stage.mesh.world_size > 1:
        setup_logging(job.log_level)
    step_fn, params = job.build(rank_state(job.state), stage.device)
    place(params, stage.device)
    runner = DataParallelRunner(stage, step_fn, job.total_steps)
    reset_peak_memory(stage.device)
    for _ in range(job.warmup_rounds):
        runner.run(params, job.inputs)
    total = timed(stage, lambda: runner.run(params, job.fresh))
    return {"peak_gb": peak_memory_gb(stage.device), "total": total}


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    setup_logging(args.log_level)
    # The model builder's defaults for the benchmark mode's other flags.
    args.deepcache, args.deepcache_split = 0, 1
    mesh = make_data_mesh(args.num_devices, device=args.device, devices=args.devices)
    world = mesh.world_size
    if args.num_samples % world != 0:
        LOGGER.error("num_samples %d not divisible by %d devices", args.num_samples, world)
        return 1
    dev = mesh.devices[0]
    model = build_model(args, dev)
    with tempfile.TemporaryDirectory(prefix="vdpp_bench_") as tmp:
        job = Job(build=model.build, state=ship_state(model.state, mesh, tmp),
                  total_steps=args.total_steps, warmup_rounds=args.warmup_rounds,
                  inputs=seeded_inputs(model, args.num_samples, args.seed + 2, dev),
                  fresh=seeded_inputs(model, args.num_samples, args.seed + 3, dev),
                  log_level=args.log_level)
        LOGGER.info("data parallel: %s, %d rank(s) (%s), %d steps, %d samples", model.name,
                    world, mesh.backend, args.total_steps, args.num_samples)
        ranks = run_ranks(mesh, rank_main, job)
    total = max(r["total"] for r in ranks)
    per_sample = total / args.num_samples
    # A sample's latency is the whole schedule on one rank.
    latency = total / (args.num_samples // world)
    results = benchmark_results_dict(
        world_size=world,
        total_steps=args.total_steps,
        steps_per_device=args.total_steps,
        model=model.name,
        mode="data_parallel",
        num_samples_measured=args.num_samples,
        warmup_samples=0,
        latent_shape=args.latent_shape,
        first_sample_time_s=latency,
        avg_sample_time_s=per_sample,
        throughput_samples_per_s=args.num_samples / total,
        per_sample_times_ms=[per_sample * 1e3] * args.num_samples,
        peak_memory_gb_per_device=[r["peak_gb"] for r in ranks],
        extra={
            "platform": "gpu" if dev.type == "cuda" else "cpu",
            "peak_memory_source": peak_memory_source(dev),
        },
    )
    emit_benchmark_json(results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
