"""The port's sequence (W-halo) parallelism for the SVD UNet against the JAX
package, fp32 on the CPU: the sharded ops against the JAX package's
unsharded ones, the tiny model under seq 2 and 4, stage 2 x seq 2, seq 2 x
cfg 2 and DeepCache x seq 2 (dpmpp2m) against JAX's single-device oracle
(``torch_port_intra.jax_oracle``), and the benchmark mode, the
image->video app and the restyle app (DeepCache-2 at one stage, the
reference's exemption) with ``--seq-parallel 2``.

Tolerance: ``rtol = atol = 2e-5``, the JAX package's own for its sharded
runs against that oracle (``tests/test_sequence_parallel.py:149``); the ops
1e-5 absolute, as ``tests/test_torch_port_ops.py`` holds them. Within the
port, stage 2 x seq 2 equals seq 2 at one stage bit for bit (gloo, one
thread a rank on both sides): the stage split moves no arithmetic.

Every spawned run of the module starts at once in one fixture: a 2-rank
and a 4-rank gloo group, each laid out in turn as its cases need
(``torch_port_helpers.intra_cases``), and the two entry points, which
spawn their own ranks; JAX's oracles run meanwhile in this thread.
"""

import functools
import importlib
import json
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdpp_tpu.ops import conv as jconv
from vdpp_tpu.ops import normalization as jnorm
from vdpp_tpu.utils.weights import _conv_attention

from vdpp_tpu_torch.apps import generate_video, restyle_video
from vdpp_tpu_torch.modes import benchmark
from vdpp_tpu_torch.ops.attention import Attention
from vdpp_tpu_torch.ops.conv import Conv2d
from vdpp_tpu_torch.ops.normalization import Norm
from vdpp_tpu_torch.utils.video_io import read_y4m

import torch_port_intra as intra
from torch_port_helpers import one_torch_thread  # noqa: F401

# vdpp_tpu.ops re-exports a function named like the module
jattn = importlib.import_module("vdpp_tpu.ops.attention")

OP_ATOL = 1e-5
BENCH_ARGV = ["--device", "cpu", "--model", "svd_tiny", "--seq-parallel", "2",
              "--guidance-scale", "3", "--num-stages", "1", "--total-steps", "2",
              "--num-samples", "1", "--warmup-samples", "0", "--latent-shape", "1", "4", "4",
              "8", "16"]
APP_ARGV = ["--random-weights", "--preset", "tiny", "--device", "cpu", "--width", "64",
            "--height", "64", "--num-frames", "4", "--steps", "2", "--num-stages", "1"]


def _ops():
    """``{name: (layout, args, JAX reference thunk)}`` of the op cases."""
    cases = {}
    x = intra.x_of(1, 2, 6, 8, 5)
    state, p = intra.op_weights(Conv2d(5, 7, 3), 2, lambda sd, pf: sd.conv2d(pf))
    for stride in (1, 2):
        cases[f"conv2d_halo_s{stride}"] = (
            {"seq": 2}, ("conv2d_halo", torch.from_numpy(x), state, {"out": 7, "stride": stride}),
            functools.partial(jconv.conv2d, jnp.asarray(x), p, stride=stride,
                              padding="SAME" if stride == 1 else ((1, 1), (1, 1))))
    x4 = intra.x_of(3, 2, 6, 16, 5)
    cases["conv2d_halo_s2_seq4"] = (
        {"seq": 4}, ("conv2d_halo", torch.from_numpy(x4), state, {"out": 7, "stride": 2}),
        functools.partial(jconv.conv2d, jnp.asarray(x4), p, stride=2, padding=((1, 1), (1, 1))))
    xg = intra.x_of(4, 2, 5, 8, 32, scale=3.0, offset=5.0)  # the offset: two passes matter
    state, p = intra.op_weights(Norm(32), 5, lambda sd, pf: sd.norm(pf))
    cases["group_norm"] = ({"seq": 2}, ("group_norm", torch.from_numpy(xg), state,
                                        {"groups": 8}),
                           functools.partial(jnorm.group_norm, jnp.asarray(xg), p, 8))
    # Two tokens over two shards: a one-token local shard still gathers and
    # attends over both keys (the single-key shortcut is cross-attention's).
    xa = intra.x_of(6, 2, 2, 16)
    state, p = intra.op_weights(Attention(16), 7, _conv_attention)
    cases["attention_one_token_shard"] = (
        {"seq": 2}, ("attention", torch.from_numpy(xa), state, {"heads": 2}),
        functools.partial(jattn.attention, jnp.asarray(xa), p, 2))
    return cases


# name: (world, layout, wrapper arguments, samples). Two samples where a
# second stage pipelines them (and in the one-stage run it is held to).
MODELS = {
    "seq2": (2, {"seq": 2}, {}, 2),
    "seq2_deepcache": (2, {"seq": 2}, intra.DEEPCACHE, 1),
    "seq4": (4, {"seq": 4}, {}, 1),
    "stage2_seq2": (4, {"seq": 2}, {}, 2),
    "seq2_cfg2": (4, {"seq": 2, "cfg": 2}, {}, 1),
}


def _capture_json(records: list, results: dict) -> None:
    records.append(results)


def _apps(out_dir) -> int:
    """The image->video app over 2 seq ranks, then the restyle app over 2 seq
    ranks at DeepCache-2 on its Y4M (strength 0.5 of 4 steps: 2 run, at one
    stage); each returns 0."""
    rc = generate_video.main(APP_ARGV + ["--seq-parallel", "2", "--output-dir",
                                         str(out_dir / "seq2")])
    (y4m,) = (out_dir / "seq2").glob("*.y4m")
    return rc or restyle_video.main([
        "--input", str(y4m), "--strength", "0.5", "--random-weights", "--preset", "tiny",
        "--device", "cpu", "--steps", "4", "--num-stages", "1", "--seq-parallel", "2",
        "--deepcache", "2", "--output-dir", str(out_dir / "restyle")])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ops = _ops()
    groups = {2: [], 4: []}
    for name, (layout, args, _) in ops.items():
        groups[4 if layout["seq"] == 4 else 2].append((name, layout, "op", args))
    for name, (world, layout, kw, n) in MODELS.items():
        build, inputs = intra.port_case(**kw)
        groups[world].append((name, layout, "pipeline", (build, inputs[:n], intra.STEPS)))
    out_dir = tmp_path_factory.mktemp("app")
    records: list = []
    saved = benchmark.emit_benchmark_json
    benchmark.emit_benchmark_json = functools.partial(_capture_json, records)
    try:
        with ThreadPoolExecutor(5) as pool:
            spawned = {w: pool.submit(intra.spawn, w, c) for w, c in groups.items()}
            bench = pool.submit(benchmark.main, BENCH_ARGV)
            app = pool.submit(_apps, out_dir)
            one = pool.submit(generate_video.main, APP_ARGV + ["--output-dir",
                                                                str(out_dir / "one")])
            refs = {name: np.asarray(ref()) for name, (_, _, ref) in ops.items()}
            oracle, oracle_dc = intra.jax_oracle(), intra.jax_oracle(deepcache=True)
            results = {**spawned[2].result(), **spawned[4].result()}
            assert one.result() == 0
            assert bench.result() == 0 and app.result() == 0
    finally:
        benchmark.emit_benchmark_json = saved
    return {"results": results, "ops": refs, "oracle": oracle, "oracle_dc": oracle_dc,
            "bench": records, "app": out_dir}


@pytest.mark.parametrize("name", ["conv2d_halo_s1", "conv2d_halo_s2", "conv2d_halo_s2_seq4",
                                  "group_norm", "attention_one_token_shard"])
def test_sharded_op_matches_jax_unsharded(runs, name):
    """conv2d_halo at stride 1 and 2 (the downsample's ((1, 1), (1, 1)),
    every shard's width even) and at 4 shards, GroupNorm with its statistics
    averaged over the shards, and self-attention over a one-token local
    shard, each gathered whole, against the JAX package's unsharded op."""
    got, want = runs["results"][name], runs["ops"][name]
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=OP_ATOL, rtol=0)


@pytest.mark.parametrize("name", ["seq2", "seq4", "stage2_seq2", "seq2_cfg2"])
def test_seq_parallel_matches_jax_oracle(runs, name):
    """4 Euler steps with CFG, each forward's W split
    over the seq ranks of each stage (and, in seq2_cfg2, each branch on its
    own pair), against the JAX single-device oracle."""
    got, counts = runs["results"][name]
    intra.assert_oracle(got, runs["oracle"][:len(got)])
    assert counts["halo"] and counts["all_gather"] and counts["mean"]
    assert bool(counts.get("swap")) == (name == "seq2_cfg2")


def test_stage_split_is_bit_equal_to_one_stage(runs):
    res = runs["results"]
    assert torch.equal(res["stage2_seq2"][0], res["seq2"][0])


def test_deepcache_x_seq2_matches_jax_oracle(runs):
    """dpmpp2m x DeepCache-2 at one stage over 2 seq ranks (the one-stage
    exemption): the whole payload, cache lanes included, against JAX."""
    got, _ = runs["results"]["seq2_deepcache"]
    intra.assert_oracle(got, runs["oracle_dc"])


def test_benchmark_mode_seq_parallel(runs):
    """``modes.benchmark.main --model svd_tiny --seq-parallel 2``: the mode
    string of the reference (``"pipeline"`` + ``"_x_sp2"``,
    ``vdpp_tpu/modes/benchmark.py``), a stage of 2 ranks, a peak per rank."""
    (res,) = runs["bench"]
    assert res["mode"] == "pipeline_x_sp2"
    assert res["world_size"] == 1 and len(res["peak_memory_gb_per_rank"]) == 2
    assert res["avg_sample_time_s"] > 0
    json.dumps(res)


def test_app_seq_parallel_writes_the_video(runs):
    """``apps.generate_video.main --seq-parallel 2`` writes the 4 frames of
    64x64, and the restyle app over 2 seq ranks at DeepCache-2 restyles
    them. They match the one-rank app's but where the latents' last-bit
    differences round a level the other way: at most 2 levels (one in RGB,
    one more through the Y4M's 4:2:0 chroma) in under 1% of the values."""
    def frames(sub):
        (path,) = (runs["app"] / sub).glob("*.y4m")
        return read_y4m(str(path))[0]

    got, want = frames("seq2"), frames("one")
    assert got.shape == want.shape == frames("restyle").shape == (4, 64, 64, 3)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 2 and (diff > 0).mean() < 1e-2
