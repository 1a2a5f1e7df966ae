"""The port's benchmark modes (``vdpp_tpu_torch.modes.benchmark`` and
``.benchmark_data_parallel``) and their utilities (``utils/bench_json.py``,
``logging.py``, ``memory.py``, ``profiling.py``) against the JAX package's,
on the CPU, with ``tests/test_modes.py``, ``tests/test_utils.py`` and
``tests/test_memory.py`` as the model.

What is compared, and how:

* ``benchmark_results_dict`` and the ``BENCHMARK_JSON=`` line: equal to JAX's
  for the same arguments, exactly.
* ``main`` of each mode in this process on ``--device cpu`` (the dummy, 2
  stages or ranks, 4 steps) beside JAX's ``main`` in this process on the
  conftest's host devices, as ``tests/test_memory.py`` runs it: the same keys,
  but for ``program_memory_gb``, the JAX package's fallback to a compiled
  program's analysis, which eager PyTorch has no counterpart of (the port
  reports ``"peak_memory_source": "unavailable"`` instead); the same values
  of every key that does not depend on a clock or an allocator, exactly.
* The tick accounting: JAX's ``main`` fed the test's tick times (its
  ``run_ticked`` wrapped to return them) against the port's
  ``tick_accounting`` on the same times, after the contract's rounding.

Every run that spawns ranks starts at once in one fixture, beside the JAX
runs (one thread); each thread's stdout is kept apart.
"""

import io
import json
import logging
import pathlib
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from vdpp_tpu.modes import benchmark as jax_bench
from vdpp_tpu.modes import benchmark_data_parallel as jax_bench_dp
from vdpp_tpu.parallel import pipeline as jax_pipeline
from vdpp_tpu.utils import bench_json as jax_bench_json
from vdpp_tpu.utils.logging import stage_logger as jax_stage_logger

from vdpp_tpu_torch.modes import benchmark, benchmark_data_parallel
from vdpp_tpu_torch.utils import bench_json, memory, profiling
from vdpp_tpu_torch.utils.logging import stage_logger

from torch_port_helpers import one_torch_thread  # noqa: F401

LATENT = ["--latent-shape", "1", "8", "2", "8", "8"]
BASE = ["--model", "dummy", "--num-stages", "2", "--total-steps", "4", "--num-samples", "2",
        *LATENT]
# mode -> (module, flags shared by both packages)
RUNS = {
    "pipeline": ("benchmark", BASE + ["--warmup-samples", "1"]),
    "fused": ("benchmark", BASE + ["--warmup-samples", "0", "--fused"]),
    "pipeline_x_dp": ("benchmark", BASE + ["--warmup-samples", "0",
                                           "--data-parallel-size", "2"]),
    "fsdp": ("benchmark", BASE + ["--warmup-samples", "0", "--fsdp"]),
    "data_parallel": ("benchmark_data_parallel",
                      ["--model", "dummy", "--num-devices", "2", "--total-steps", "4",
                       "--num-samples", "4", *LATENT]),
}
DETERMINISTIC = ("world_size", "total_steps", "steps_per_gpu", "model", "mode", "fsdp",
                 "num_samples_measured", "warmup_samples", "latent_shape", "bubble_fraction",
                 "data_parallel_size")
# The ticked run's N + S - 1 = 4 ticks, as the test supplies them to both.
TICKS = [0.5, 0.25, 0.125, 0.0625]
DEEPCACHE = ["--device", "cpu", "--model", "svd_tiny", "--deepcache", "2", "--guidance-scale",
             "3", "--num-stages", "2", "--total-steps", "4", "--num-samples", "2",
             "--warmup-samples", "0", "--latent-shape", "1", "4", "2", "16", "16"]


class _ThreadStdout:
    """``sys.stdout`` that writes each registered thread's text to its own
    buffer (others to the real stdout)."""

    def __init__(self, real):
        self.real, self.buffers = real, {}

    def write(self, s):
        return self.buffers.get(threading.get_ident(), self.real).write(s)

    def flush(self):
        pass


def _captured(fn, argv) -> tuple[int, str]:
    """``fn(argv)``'s return value and what it printed, from this thread."""
    buf = io.StringIO()
    sys.stdout.buffers[threading.get_ident()] = buf
    try:
        return fn(argv), buf.getvalue()
    finally:
        del sys.stdout.buffers[threading.get_ident()]


def _json(text: str) -> dict:
    lines = [line for line in text.splitlines() if line.startswith("BENCHMARK_JSON=")]
    assert len(lines) == 1, text[-2000:]
    return json.loads(lines[0][len("BENCHMARK_JSON="):])


def _jax_runs() -> dict:
    """JAX's ``main`` of every run, one after another, its ticked run fed
    :data:`TICKS`."""
    original = jax_pipeline.StepPipeline.run_ticked

    def supplied(self, params, inputs, **kw):
        out, ticks = original(self, params, inputs, **kw)
        assert len(ticks) == len(TICKS)
        return out, list(TICKS)

    mains = {"benchmark": jax_bench.main, "benchmark_data_parallel": jax_bench_dp.main}
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_pipeline.StepPipeline, "run_ticked", supplied)
        for mode, (module, flags) in RUNS.items():
            rc, text = _captured(mains[module], ["--backend", "cpu", *flags])
            assert rc == 0
            out[mode] = _json(text)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{mode: (JAX's JSON, the port's JSON)}`` for :data:`RUNS`, the pipeline
    run traced into ``runs["trace_dir"]``, and the port's DeepCache run
    (``runs["deepcache"]``)."""
    trace_dir = str(tmp_path_factory.mktemp("trace"))
    mains = {"benchmark": benchmark.main, "benchmark_data_parallel": benchmark_data_parallel.main}
    real = sys.stdout
    sys.stdout = _ThreadStdout(real)
    try:
        with ThreadPoolExecutor(len(RUNS) + 2) as pool:
            port = {mode: pool.submit(
                _captured, mains[module],
                ["--device", "cpu", *flags,
                 *(["--profile-dir", trace_dir] if mode == "pipeline" else [])])
                for mode, (module, flags) in RUNS.items()}
            deepcache = pool.submit(_captured, benchmark.main, DEEPCACHE)
            jax_out = pool.submit(_jax_runs)
            out = {}
            for mode, fut in port.items():
                rc, text = fut.result()
                assert rc == 0
                out[mode] = (jax_out.result()[mode], _json(text))
            out["deepcache"] = deepcache.result()
            out["trace_dir"] = trace_dir
            return out
    finally:
        sys.stdout = real


def _results(**over) -> dict:
    base = dict(world_size=4, total_steps=28, steps_per_device=7, model="dummy",
                mode="pipeline", num_samples_measured=8, warmup_samples=1,
                latent_shape=[1, 8, 4, 16, 16], first_sample_time_s=1.23456789,
                avg_sample_time_s=0.25, throughput_samples_per_s=4.0,
                per_sample_times_ms=[1000.123, 250.0], peak_memory_gb_per_device=[1.5, 1.6049],
                extra={"platform": "gpu"})
    base.update(over)
    return base


@pytest.mark.parametrize("mode", ["pipeline", "fsdp", "data_parallel"])
def test_results_dict_and_line_equal_jax(capsys, mode):
    """The dict, its rounding and the printed line are JAX's, exactly."""
    kw = _results(mode=mode)
    assert bench_json.benchmark_results_dict(**kw) == jax_bench_json.benchmark_results_dict(**kw)
    for emit in (bench_json.emit_benchmark_json, jax_bench_json.emit_benchmark_json):
        emit(bench_json.benchmark_results_dict(**kw))
    port, jax_line = capsys.readouterr().out.splitlines()
    assert port == jax_line and port.startswith("BENCHMARK_JSON=")
    assert bench_json.benchmark_results_dict(
        **_results(peak_memory_gb_per_device=[]))["max_peak_memory_gb"] == 0.0


def test_stage_logger_prefix_equals_jax(caplog):
    with caplog.at_level(logging.INFO, logger="vdpp.check"):
        stage_logger("vdpp.check", 3).info("tick %d", 1)
        jax_stage_logger("vdpp.check", 3).info("tick %d", 1)
        stage_logger("vdpp.check").info("plain")
    assert caplog.messages == ["[stage=3] tick 1", "[stage=3] tick 1", "plain"]


@pytest.mark.parametrize("mode", list(RUNS))
def test_main_keys_and_values_equal_jax(runs, mode):
    """Each mode's BENCHMARK_JSON: JAX's keys (but the compiled-program
    fallback's), JAX's deterministic values, one per-sample time a sample,
    one peak a rank (0.0 on the CPU, source "unavailable"), platform "cpu"."""
    want, got = runs[mode]
    assert set(got) == set(want) - {"program_memory_gb"}
    for key in DETERMINISTIC:
        assert got.get(key) == want.get(key), key
    assert len(got["per_sample_times_ms"]) == len(want["per_sample_times_ms"])
    ranks = 4 if mode == "pipeline_x_dp" else 2
    assert got["peak_memory_gb_per_rank"] == [0.0] * ranks == want["peak_memory_gb_per_rank"]
    assert (got["platform"], got["peak_memory_source"]) == ("cpu", "unavailable")
    assert got["throughput_samples_per_s"] > 0


def test_tick_accounting_equals_jax(runs):
    """JAX's main on :data:`TICKS` (2 stages, 1 warm-up + 2 samples) and the
    port's ``tick_accounting`` on the same ticks give the same first, steady,
    throughput and per-sample times once the contract rounds them."""
    want = runs["pipeline"][0]
    first, steady, throughput, per_sample = benchmark.tick_accounting(TICKS, 2, 1)
    got = bench_json.benchmark_results_dict(**_results(
        first_sample_time_s=first, avg_sample_time_s=steady, throughput_samples_per_s=throughput,
        per_sample_times_ms=per_sample))
    for key in ("first_sample_time_s", "avg_sample_time_s", "throughput_samples_per_s",
                "per_sample_times_ms"):
        assert got[key] == want[key], key
    assert (first, steady, per_sample) == (0.75, 0.09375, [750.0, 125.0, 62.5])
    # every sample a warm-up one: no steady phase
    assert benchmark.tick_accounting([1.0, 2.0], 1, 2)[1:3] == (0.0, 0.0)


def test_fused_accounting():
    """JAX's derived accounting: first on D samples, steady (total - first) /
    (N - D), or total / N when one tick-batch holds every sample."""
    first, steady, throughput, per_sample = benchmark.fused_accounting(1.0, 4.0, 4, 1)
    assert (first, steady, throughput) == (1.0, 1.0, 1.0)
    assert per_sample == [1000.0] * 4
    first, steady, throughput, per_sample = benchmark.fused_accounting(1.0, 1.5, 2, 2)
    assert (steady, throughput, per_sample) == (0.75, 2 / 1.5, [1000.0, 1000.0])


def test_profile_dir_writes_a_trace_a_rank(runs):
    """``--profile-dir`` on the 2-stage run: one parseable Chrome trace a
    rank, and the JSON line intact (the run's keys are checked above)."""
    traces = sorted(pathlib.Path(runs["trace_dir"]).iterdir())
    assert [p.name for p in traces] == ["trace_rank0.json", "trace_rank1.json"]
    for p in traces:
        assert json.loads(p.read_text())["traceEvents"]
    assert runs["pipeline"][1]["mode"] == "pipeline"


def test_deepcache_on_svd_tiny_emits_the_line(runs):
    rc, text = runs["deepcache"]
    assert rc == 0
    got = _json(text)
    assert (got["model"], got["world_size"], got["steps_per_gpu"]) == ("svd_tiny", 2, 2)


def test_bad_split_and_indivisible_samples_are_refused(capsys):
    """As ``tests/test_modes.py::test_benchmark_rejects_bad_split``: 3 stages
    cannot split 4 steps; an N the data columns do not divide is refused
    before any rank starts; the data-parallel mode exits 1."""
    with pytest.raises(ValueError, match="divisible"):
        benchmark.main(["--device", "cpu", "--model", "dummy", "--num-stages", "3",
                        "--total-steps", "4", "--num-samples", "1"])
    with pytest.raises(SystemExit, match="divisible"):
        benchmark.main(["--device", "cpu", *BASE, "--warmup-samples", "1",
                        "--data-parallel-size", "2"])
    assert benchmark_data_parallel.main(["--device", "cpu", "--num-devices", "2",
                                         "--num-samples", "3"]) == 1


# Flag sets that raised, naming the ROADMAP item that had not been ported
# yet: int8 (A14) and the MoE DiT with its expert axis (A15). Both are
# ported (tests/test_torch_port_quant.py, tests/test_torch_port_moe_parallel.py).
UNPORTED = [
    (["--model", "dit3d_tiny", "--cfg-parallel", "--guidance-scale", "3", "--weights-int8"],
     "A14"),
    (["--model", "dit3d_tiny", "--seq-parallel", "2", "--weights-w8a8"], "A14"),
    (["--model", "dit3d_moe_tiny", "--seq-parallel", "2"], "A15"),
    (["--model", "svd_tiny", "--weights-int8"], "A14"),
    (["--model", "dit3d_tiny", "--weights-w8a8"], "A14"),
    (["--model", "dit3d_moe_tiny"], "A15"),
    (["--model", "dit3d_moe_tiny", "--expert-parallel", "2"], "A15"),
]


@pytest.mark.parametrize("flags,item", UNPORTED)
def test_unported_flags_raise_naming_their_item(flags, item):
    """Since their items were ported these flags raise nothing: they pass the
    JAX package's checks and lay out their mesh (an expert axis of
    ``--expert-parallel`` ranks innermost in each stage), and the int8 flags
    reach the model's build."""
    args = benchmark.build_parser().parse_args(
        flags + ["--device", "cpu", "--latent-shape", "1", "4", "2", "16", "16"])
    benchmark.check_flags(args)
    mesh = benchmark._mesh(args)
    assert (mesh.seq, mesh.cfg, mesh.expert) == (args.seq_parallel, 1 + args.cfg_parallel,
                                                 args.expert_parallel)
    if item == "A14":
        assert args.weights_int8 or args.weights_w8a8
    else:
        assert args.model == "dit3d_moe_tiny"


JAX_CHECKS = [
    ["--model", "svd_tiny", "--cfg-parallel"],
    ["--model", "dit3d_tiny", "--expert-parallel", "2"],
    ["--model", "dummy", "--deepcache", "2"],
]


@pytest.mark.parametrize("flags", JAX_CHECKS)
def test_jax_checks_fire_first_with_jax_message(flags):
    """``--cfg-parallel`` without ``--guidance-scale``, ``--expert-parallel``
    on a model without experts, DeepCache on the dummy: JAX's messages."""
    with pytest.raises(SystemExit) as want:
        jax_bench.main(["--backend", "cpu", *flags])
    with pytest.raises(SystemExit) as got:
        benchmark.main(flags)
    assert str(got.value) == str(want.value)


def test_multi_axis_flags_refused_with_jax_message():
    """``--fsdp`` and ``--data-parallel-size`` refuse the intra-sample axes
    with the JAX package's messages (``vdpp_tpu/modes/benchmark.py``), before
    those axes' own not-ported error."""
    with pytest.raises(SystemExit, match="--fsdp runs every step on every device"):
        benchmark.main(["--model", "svd_tiny", "--fsdp", "--seq-parallel", "2"])
    with pytest.raises(SystemExit, match="--data-parallel-size composes with the stage axis"):
        benchmark.main(["--model", "svd_tiny", "--data-parallel-size", "2", "--cfg-parallel",
                        "--guidance-scale", "3"])


def test_memory_and_profiling_on_the_cpu(caplog):
    """No allocator on the CPU: 0.0 GB, source "unavailable"; the parameter
    bytes of a module; ``phase_timer`` logs its seconds (fenced on a card,
    nothing to fence here)."""
    cpu = torch.device("cpu")
    memory.reset_peak_memory(cpu)
    assert memory.peak_memory_gb(cpu) == 0.0
    assert memory.peak_memory_source(cpu) == "unavailable"
    lin = torch.nn.Linear(4, 3)
    assert memory.params_bytes_per_device(lin) == (12 + 3) * 4
    assert memory.params_bytes_per_device((lin, torch.zeros(9))) == 60
    with caplog.at_level(logging.INFO):
        with profiling.phase_timer("test-phase", cpu) as rec:
            profiling.force_sync(cpu)
    assert rec["seconds"] >= 0
    assert any("test-phase" in m for m in caplog.messages)


def test_profile_trace_closes_on_error(tmp_path):
    with pytest.raises(RuntimeError), profiling.device_trace(str(tmp_path), 5):
        torch.ones(3).sum()
        raise RuntimeError("mid-run")
    assert json.loads((tmp_path / "trace_rank5.json").read_text())["traceEvents"]
