"""The BENCHMARK_JSON metric contract (port of ``vdpp_tpu/utils/bench_json.py``).

The same machine-readable stdout line and schema as the JAX package's and the
original system's benchmark harnesses, so that their sweep scripts, CSV
parsers and plots read the port's runs unchanged. The keys, their rounding
and the ``BENCHMARK_JSON=`` prefix are the reference's; ``steps_per_gpu``
keeps its name.
"""

from __future__ import annotations

import json
import logging
from collections.abc import Sequence

LOGGER = logging.getLogger(__name__)


def benchmark_results_dict(
    *,
    world_size: int,
    total_steps: int,
    steps_per_device: int | str,
    model: str,
    mode: str,
    num_samples_measured: int,
    warmup_samples: int,
    latent_shape: Sequence[int],
    first_sample_time_s: float,
    avg_sample_time_s: float,
    throughput_samples_per_s: float,
    per_sample_times_ms: Sequence[float],
    peak_memory_gb_per_device: Sequence[float],
    extra: dict | None = None,
) -> dict:
    results = {
        "world_size": world_size,
        "total_steps": total_steps,
        "steps_per_gpu": steps_per_device,  # the contract's key name
        "model": model,
        "mode": mode,
        "fsdp": mode == "fsdp",
        "num_samples_measured": num_samples_measured,
        "warmup_samples": warmup_samples,
        "latent_shape": list(latent_shape),
        "first_sample_time_s": round(first_sample_time_s, 4),
        "avg_sample_time_s": round(avg_sample_time_s, 4),
        "throughput_samples_per_s": round(throughput_samples_per_s, 4),
        "per_sample_times_ms": [round(t, 2) for t in per_sample_times_ms],
        "peak_memory_gb_per_rank": [round(m, 3) for m in peak_memory_gb_per_device],
        "max_peak_memory_gb": round(
            max(peak_memory_gb_per_device) if peak_memory_gb_per_device else 0.0, 3
        ),
    }
    if extra:
        results.update(extra)
    return results


def emit_benchmark_json(results: dict) -> None:
    """Log a human table and print the machine-readable line."""
    LOGGER.info("=" * 70)
    LOGGER.info("BENCHMARK RESULTS (%s mode)", results.get("mode", "?"))
    LOGGER.info("=" * 70)
    LOGGER.info(
        "Devices: %s | Steps/device: %s | Model: %s | Samples: %s (+ %s warmup)",
        results["world_size"],
        results["steps_per_gpu"],
        results["model"],
        results["num_samples_measured"],
        results["warmup_samples"],
    )
    LOGGER.info("Latent: %s", results["latent_shape"])
    LOGGER.info("First sample (fill):   %.2f s", results["first_sample_time_s"])
    LOGGER.info("Avg sample (steady):   %.4f s", results["avg_sample_time_s"])
    LOGGER.info(
        "Throughput:            %.4f samples/s", results["throughput_samples_per_s"]
    )
    LOGGER.info("Peak memory per device (GB): %s", results["peak_memory_gb_per_rank"])
    print(f"BENCHMARK_JSON={json.dumps(results)}", flush=True)
