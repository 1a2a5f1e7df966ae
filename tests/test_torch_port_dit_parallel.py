"""The port's DiT sequence and CFG axes (``DiTVideo.forward(seq_axis=)``,
``DiTVideoWrapper.step(cfg_axis=)``, ``parallel/sequence_parallel.py``) and
the text->video app's ``--seq-parallel`` against the JAX package, fp32 on
the CPU.

The tiny DiTs (``tiny()`` factorized and ``joint3d_tiny()``, head dim 16)
hold the same weights: the JAX tree's leaves drawn from a numpy seed,
carried to the port by ``from_jax_dit_params``. 4 frames of an 8x8 latent
give 16 tokens a frame (64 joint3d), which 2 and 4 shards split. JAX's
oracle is its single-device run of every step (``run_reference_single_device``
over its jitted step), as ``tests/test_sequence_parallel.py`` and
``tests/test_cfg_parallel.py`` hold their sharded runs to it.

Tolerance: ``rtol = atol = 2e-5``, theirs. Within the port, the stage split
is bit-equal to the one-stage run of the same axis, and cfg 2 to sequential
CFG (the same two forwards blended in the same order).

Every spawned run of the module starts at once in one fixture (a 2-, a 4-
and an 8-rank gloo group, each laid out in turn as its cases need, and the
app twice); JAX's oracles run meanwhile in this thread.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdpp_tpu.models import dit as jdit
from vdpp_tpu.models.svd_wrapper import make_guidance_ramp as jax_ramp
from vdpp_tpu.parallel.cfg_parallel import CFGParallelRunner as JaxCFGRunner
from vdpp_tpu.parallel.mesh import make_cfg_mesh, make_seq_mesh
from vdpp_tpu.parallel.mesh import make_pipeline_mesh as jax_pipeline_mesh
from vdpp_tpu.parallel.pipeline import run_reference_single_device as jax_run
from vdpp_tpu.parallel.sequence_parallel import SequenceParallelRunner as JaxSeqRunner

from vdpp_tpu_torch.apps import generate_video_text
from vdpp_tpu_torch.modes import benchmark
from vdpp_tpu_torch.models import dit as tdit
from vdpp_tpu_torch.models.svd_wrapper import make_guidance_ramp
from vdpp_tpu_torch.parallel.collectives import Axis
from vdpp_tpu_torch.parallel.mesh import Stage, make_pipeline_mesh, run_stages
from vdpp_tpu_torch.parallel.pipeline import run_reference_single_device
from vdpp_tpu_torch.parallel.sequence_parallel import SequenceParallelRunner
from vdpp_tpu_torch.utils.weights import from_jax_dit_params

import torch_port_helpers as helpers
from torch_port_helpers import one_torch_thread  # noqa: F401

B, F, H, W = 1, 4, 8, 8
STEPS, GUIDANCE = 4, 5.0
RTOL = ATOL = 2e-5
MODES = ("joint3d", "factorized")
TEXT_APP = ["--random-weights", "--preset", "tiny", "--device", "cpu", "--num-frames", "4",
            "--steps", "2"]
BENCH = ["--device", "cpu", "--model", "dit3d_tiny", "--seq-parallel", "2", "--cfg-parallel",
         "--guidance-scale", "5", "--num-stages", "1", "--total-steps", "2", "--num-samples", "1",
         "--warmup-samples", "0", "--latent-shape", "1", "4", "4", "8", "8"]


def _cfgs(mode: str):
    name = "joint3d_tiny" if mode == "joint3d" else "tiny"
    return getattr(jdit.DiTVideoConfig, name)(), getattr(tdit.DiTVideoConfig, name)()


@functools.cache
def _draws(mode: str):
    """``(JAX params, port state dict, context, negative context, noise (2,
    B, F, H, W, 4) x init sigma)``: every leaf of the JAX tree drawn from a
    numpy seed at the scale of its role (norm scales about 1, biases and the
    final adaLN off 0, which would hide a misplaced one)."""
    jcfg, _ = _cfgs(mode)
    shapes = jax.eval_shape(jdit.DiTVideo(jcfg).init, jax.random.key(0))
    rng = np.random.default_rng(3)
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    leaves = []
    for path, leaf in flat:
        name = jax.tree_util.keystr(path)
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        if leaf.ndim == 2:
            leaves.append((0.1 if "ada" in name else 1.0) * noise / np.sqrt(leaf.shape[0]))
        elif name.endswith("['scale']"):
            leaves.append(1.0 + 0.1 * noise)
        else:
            leaves.append(0.1 * noise)
    params = jax.tree_util.tree_unflatten(treedef, leaves)
    ctx = rng.standard_normal((B, 2, jcfg.cross_attention_dim)).astype(np.float32)
    neg = rng.standard_normal(ctx.shape).astype(np.float32)
    sigma = jdit.DiTVideoWrapper(jcfg, num_steps=STEPS).init_noise_sigma
    noise = rng.standard_normal((2, B, F, H, W, 4)).astype(np.float32) * sigma
    return params, from_jax_dit_params(params), ctx, neg, noise


def _contexts(ctx, neg, cond: str):
    """The port's and JAX's ``(context, guidance)`` of a conditioning:
    ``"cfg"`` (the context, a guidance ramp), ``"neg"`` (a negative prompt
    too) or ``"none"`` (neither)."""
    if cond == "none":
        return (None, None), (None, None)
    t, j = torch.from_numpy(ctx), jnp.asarray(ctx)
    if cond == "neg":
        t, j = (torch.from_numpy(neg), t), (jnp.asarray(neg), j)
    return (t, make_guidance_ramp(GUIDANCE, F)), (j, jax_ramp(GUIDANCE, F))


@functools.cache
def jax_oracle(mode: str, cond: str = "cfg") -> np.ndarray:
    """JAX's single-device run of every step of both samples."""
    jcfg, _ = _cfgs(mode)
    params, _, ctx, neg, noise = _draws(mode)
    wrapper = jdit.DiTVideoWrapper(jcfg, num_steps=STEPS)
    step = jax.jit(wrapper.pipeline_step_fn())
    context, guidance = _contexts(ctx, neg, cond)[1]
    return np.asarray(jax_run(step, (params, context, guidance), jnp.asarray(noise), STEPS))


def _build(mode: str, cond: str = "cfg", runner: bool = False):
    _, tcfg = _cfgs(mode)
    _, state, ctx, neg, _ = _draws(mode)
    context, guidance = _contexts(ctx, neg, cond)[0]
    fn = helpers.dit_runner_build if runner else helpers.dit_build
    return functools.partial(fn, tcfg, STEPS, state, context, guidance)


def _noise(mode: str, n: int) -> torch.Tensor:
    return torch.from_numpy(_draws(mode)[4][:n])


def _case(name: str, mode: str, layout: dict, kind: str, n: int, cond: str = "cfg"):
    if kind == "seq_runner":
        return (name, layout, kind, (_build(mode, cond, runner=True), _noise(mode, n)))
    return (name, layout, kind, (_build(mode, cond), _noise(mode, n), STEPS))


def _groups() -> dict[int, list]:
    """Every case by the size of its gloo group."""
    groups = {2: [], 4: [], 8: []}
    for m in MODES:
        groups[2].append(_case(f"{m}_seq2", m, {"seq": 2}, "seq_runner", 2))
        groups[4].append(_case(f"{m}_seq4", m, {"seq": 4}, "seq_runner", 1))
        groups[4].append(_case(f"{m}_stage2_seq2", m, {"seq": 2}, "pipeline", 2))
        groups[8].append(_case(f"{m}_stage2_seq2_cfg2", m, {"seq": 2, "cfg": 2}, "pipeline", 2))
    groups[2] += [_case("joint3d_seq2_uncond", "joint3d", {"seq": 2}, "seq_runner", 1, "none"),
                  _case("joint3d_cfg2", "joint3d", {"cfg": 2}, "cfg_runner", 1),
                  _case("factorized_cfg2", "factorized", {"cfg": 2}, "cfg_runner", 1),
                  _case("joint3d_cfg2_neg", "joint3d", {"cfg": 2}, "cfg_runner", 1, "neg")]
    return groups


def _spawn(world: int, cases: list) -> dict:
    mesh = make_pipeline_mesh(world, device="cpu")
    return run_stages(mesh, helpers.intra_cases, cases, threads=1, timeout=600)[-1]


def _app(out_dir, extra: list[str]) -> int:
    return generate_video_text.main(TEXT_APP + extra + ["--output-dir", str(out_dir)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("text_app")
    records: list = []
    saved = benchmark.emit_benchmark_json
    benchmark.emit_benchmark_json = records.append
    try:
        with ThreadPoolExecutor(6) as pool:
            spawned = {w: pool.submit(_spawn, w, c) for w, c in _groups().items()}
            apps = {k: pool.submit(_app, out / k, extra) for k, extra in (
                ("one", ["--num-stages", "1"]), ("seq2", ["--seq-parallel", "2"]))}
            bench = pool.submit(benchmark.main, BENCH)
            oracles = {(m, "cfg"): jax_oracle(m) for m in MODES}
            oracles[("joint3d", "none")] = jax_oracle("joint3d", "none")
            oracles[("joint3d", "neg")] = jax_oracle("joint3d", "neg")
            results = {k: v for f in spawned.values() for k, v in f.result().items()}
            rcs = {k: f.result() for k, f in apps.items()}
            assert bench.result() == 0
    finally:
        benchmark.emit_benchmark_json = saved
    return {"results": results, "oracles": oracles, "apps": rcs, "out": out, "bench": records}


def _check(runs, name: str, mode: str, cond: str = "cfg"):
    got, counts = runs["results"][name]
    want = runs["oracles"][(mode, cond)][:len(got)]
    assert tuple(got.shape) == want.shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    return got, counts


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shards", [2, 4])
def test_seq_parallel_matches_jax_oracle(runs, mode, shards):
    """``SequenceParallelRunner`` over 2 and 4 seq ranks (joint3d splits all
    64 tokens, factorized each frame's 16), CFG ramp to 5, against JAX's
    single-device run (``tests/test_sequence_parallel.py:55-62``). Every
    self-attention gathers K and V, and the head's output is gathered once."""
    got, counts = _check(runs, f"{mode}_seq{shards}", mode)
    sites = 4 if mode == "joint3d" else 2  # self-attention over the token axis
    # CFG sequential: two forwards a step, each 2 gathers a site and 1 output gather
    assert counts == {"all_gather": len(got) * STEPS * 2 * (2 * sites + 1)}


def test_seq_parallel_unconditioned_matches_jax_oracle(runs):
    """joint3d at seq 2 without context or guidance (``:65-72``)."""
    _check(runs, "joint3d_seq2_uncond", "joint3d", "none")


@pytest.mark.parametrize("mode", MODES)
def test_stage_x_seq_matches_jax_oracle(runs, mode):
    """A (stage 2, seq 2) step pipeline over 2 samples (the reference runs
    stage 4 x seq 2, ``:76-100``): JAX's oracle, and bit-equal to the seq 2
    runner's samples."""
    got, _ = _check(runs, f"{mode}_stage2_seq2", mode)
    assert torch.equal(got, runs["results"][f"{mode}_seq2"][0])


@pytest.mark.parametrize("mode", ["joint3d", "factorized"])
def test_cfg_parallel_matches_sequential_cfg(runs, mode):
    """``CFGParallelRunner`` on a cfg axis of 2: JAX's sequential-CFG oracle
    (``tests/test_cfg_parallel.py:92-102``), and bit for bit the port's own
    sequential CFG in one process; one swap a step."""
    got, counts = _check(runs, f"{mode}_cfg2", mode)
    assert counts == {"swap": STEPS}
    build = _build(mode)
    step_fn, params = build("cpu")
    assert torch.equal(got, run_reference_single_device(step_fn, params, _noise(mode, 1), STEPS))


@pytest.mark.parametrize("mode", MODES)
def test_stage_x_seq_x_cfg_matches_jax_oracle(runs, mode):
    """The three axes at once, a (stage 2, seq 2, cfg 2) mesh of 8 ranks
    (``tests/test_cfg_parallel.py:105-119``)."""
    _, counts = _check(runs, f"{mode}_stage2_seq2_cfg2", mode)
    assert counts["swap"] and counts["all_gather"]


def test_negative_prompt_rides_the_cfg_axis(runs):
    """A ``(neg, pos)`` context: rank 0 of the cfg axis conditions on the
    negative prompt, rank 1 on the prompt (``:156-172``)."""
    _check(runs, "joint3d_cfg2_neg", "joint3d", "neg")


def test_text_app_seq_parallel_files_are_byte_equal(runs):
    """``apps.generate_video_text.main --seq-parallel 2`` (one stage of two
    seq ranks, the runner) writes the files the one-rank app writes, byte for
    byte."""
    assert runs["apps"] == {"one": 0, "seq2": 0}
    files = {k: {p.suffix: p.read_bytes() for p in (runs["out"] / k).iterdir()}
             for k in ("one", "seq2")}
    assert set(files["one"]) == {".mp4", ".y4m", ".gif"}
    assert files["seq2"] == files["one"]


def test_benchmark_mode_dit_seq_and_cfg_parallel(runs):
    """``modes.benchmark.main --model dit3d_tiny --seq-parallel 2
    --cfg-parallel``: one stage of 2 x 2 ranks, the mode string the
    reference's naming gives (``vdpp_tpu/modes/benchmark.py``), a peak per
    rank."""
    (res,) = runs["bench"]
    assert res["mode"] == "pipeline_x_sp2_x_cfg" and res["model"] == "dit3d_tiny"
    assert res["world_size"] == 1 and len(res["peak_memory_gb_per_rank"]) == 4
    assert res["avg_sample_time_s"] > 0


# ---- refusals: each case runs both packages on the same inputs ---- #


def _fake_axis(name: str, size: int) -> Axis:
    """Rank 0's view of an axis with no process group behind it: the
    refusals come before any collective call."""
    return Axis(name, size, 0, tuple(range(size)), group=None)


def _indivisible():
    """factorized at a 6x8 latent: 3 x 4 = 12 tokens a frame over 8 shards."""
    jcfg, tcfg = _cfgs("factorized")
    params, state, ctx, _, _ = _draws("factorized")
    lat = np.random.default_rng(5).standard_normal((B, F, 6, 8, 4)).astype(np.float32)
    model = tdit.DiTVideo(tcfg, device="cpu")
    model.load_state_dict(state)
    jw = jdit.DiTVideoWrapper(jcfg, num_steps=STEPS)
    return (lambda: JaxSeqRunner(make_seq_mesh(8), jw).run(params, jnp.asarray(lat),
                                                           jnp.asarray(ctx), jax_ramp(3.0, F)),
            lambda: model(torch.from_numpy(lat), 0.5, torch.from_numpy(ctx),
                          seq_axis=_fake_axis("seq", 8)))


def _no_seq_axis():
    jw = jdit.DiTVideoWrapper(_cfgs("joint3d")[0], num_steps=STEPS)
    tw = tdit.DiTVideoWrapper(_cfgs("joint3d")[1], num_steps=STEPS, device="cpu")
    return (lambda: JaxSeqRunner(jax_pipeline_mesh(2), jw),
            lambda: SequenceParallelRunner(Stage(make_pipeline_mesh(2, device="cpu"), 0), tw))


def _neg_shape_mismatch():
    """A negative prompt one token longer than the prompt on the cfg axis."""
    jcfg, tcfg = _cfgs("joint3d")
    params, state, ctx, _, noise = _draws("joint3d")
    neg = np.zeros((B, ctx.shape[1] + 1, ctx.shape[2]), np.float32)
    jw = jdit.DiTVideoWrapper(jcfg, num_steps=STEPS)
    tw = tdit.DiTVideoWrapper(tcfg, num_steps=STEPS, device="cpu")
    model = tdit.DiTVideo(tcfg, device="cpu")
    model.load_state_dict(state)
    runner = JaxCFGRunner(make_cfg_mesh(), jw.pipeline_step_fn(cfg_axis="cfg"), STEPS)
    return (lambda: runner.run((params, (jnp.asarray(neg), jnp.asarray(ctx)), jax_ramp(3.0, F)),
                               jnp.asarray(noise[0])),
            lambda: tw.step(model, torch.from_numpy(noise[0]), 0,
                            (torch.from_numpy(neg), torch.from_numpy(ctx)),
                            make_guidance_ramp(3.0, F), cfg_axis=_fake_axis("cfg", 2)))


REFUSALS = {"indivisible_tokens": (_indivisible, "divisible"),
            "mesh_without_seq_axis": (_no_seq_axis, "seq"),
            "negative_prompt_shape_mismatch": (_neg_shape_mismatch, "equal shape")}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_both_packages_refuse(case):
    """Tokens that the seq shards do not divide (``tests/test_sequence_
    parallel.py:230-235``), a runner on a mesh without a seq axis
    (``:221-227``), and a negative prompt whose shape differs from the
    prompt's on the cfg axis (``tests/test_cfg_parallel.py:175-181``): both
    packages raise ValueError, naming the cause."""
    pair, match = REFUSALS[case]
    for side in pair():
        with pytest.raises(ValueError, match=match):
            side()
