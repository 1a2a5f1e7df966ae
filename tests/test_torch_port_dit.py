"""The port's video DiT (``vdpp_tpu_torch.models.dit``: ``DiTVideo`` and
``DiTVideoWrapper``) and its weight carriers against the JAX package's
(``vdpp_tpu.models.dit``), fp32 on the CPU.

The config has DiT-XL's head dim, 72 (hidden 144 over 2 heads), depth 2,
4 frames of a 16 x 32 latent (H != W, so a swapped patchify transpose
fails): 128 patch tokens a frame, so joint3d attends over 512 tokens and
takes the flash route on both sides (the JAX Pallas kernel in interpret
mode, the port's plain version). The JAX tree has the shapes of the JAX
``init`` and every leaf drawn from a numpy seed (biases, norms and the zero-init
final adaLN moved off 0 and 1, which would hide a misplaced one) and reaches
the port through ``from_jax_dit_params``. Latents, contexts and noise are
numpy arrays handed to both sides.

Tolerance: max|diff| <= 1e-4 * max|ref|. Both sides compute in fp32 and
differ in summation order (matmuls, norm statistics, attention) through two
blocks; measured under 5e-6 relative on the forwards and the steps.
"""

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdpp_tpu.models import dit as jdit
from vdpp_tpu.models.svd_wrapper import make_guidance_ramp as jax_ramp
from vdpp_tpu.parallel.pipeline import run_reference_single_device as jax_run
from vdpp_tpu.utils.weights import save_params

from vdpp_tpu_torch.models import dit as tdit
from vdpp_tpu_torch.models.svd_wrapper import make_guidance_ramp
from vdpp_tpu_torch.ops import flash_attention as fa
from vdpp_tpu_torch.ops.moe import shard_experts
from vdpp_tpu_torch.parallel.collectives import Axis
from vdpp_tpu_torch.parallel.pipeline import run_reference_single_device
from vdpp_tpu_torch.utils.weights import from_jax_dit_params, load_jax_npz

import torch_port_helpers as helpers
from torch_port_helpers import one_torch_thread  # noqa: F401

REL_TOL = 1e-4
F, H, W = 4, 16, 32
CROSS = 24


def _cfgs(mode: str):
    kw = dict(hidden_size=144, depth=2, num_heads=2, cross_attention_dim=CROSS,
              attention_mode=mode)
    return jdit.DiTVideoConfig(dtype=jnp.float32, **kw), tdit.DiTVideoConfig(
        dtype=torch.float32, **kw)


def _redraw(jcfg, seed: int):
    """The JAX DiT's parameter tree (shapes from its ``init``), every leaf
    drawn from a numpy seed at the scale of its role."""
    shapes = jax.eval_shape(jdit.DiTVideo(jcfg).init, jax.random.key(0))
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    leaves = []
    for path, leaf in flat:
        name = jax.tree_util.keystr(path)
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        if leaf.ndim == 2:
            scale = 0.1 if "ada" in name else 1.0
            leaves.append(scale * noise / np.sqrt(leaf.shape[0]))
        elif name.endswith("['scale']"):
            leaves.append(1.0 + 0.1 * noise)
        else:
            leaves.append(0.1 * noise)
    return jax.tree_util.tree_unflatten(treedef, leaves)


@pytest.fixture(scope="module", params=["joint3d", "factorized"])
def pair(request):
    """(mode, JAX config, JAX params as numpy, the port's DiT holding them)."""
    jcfg, tcfg = _cfgs(request.param)
    params = _redraw(jcfg, 1)
    model = tdit.DiTVideo(tcfg, device="cpu")
    model.load_state_dict(from_jax_dit_params(params), strict=True)
    return request.param, jcfg, params, model


def _inputs(seed: int, tokens: int = 5):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((1, F, H, W, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, tokens, CROSS)).astype(np.float32)
    return lat, ctx


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert np.isfinite(want).all() and torch.isfinite(got).all()
    err = np.abs(got.numpy() - want).max()
    assert err <= REL_TOL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("with_ctx", [False, True])
def test_dit_forward_matches_jax(pair, with_ctx, monkeypatch):
    mode, jcfg, params, model = pair
    lat, ctx = _inputs(2)
    flash_calls = []
    plain = fa.flash_attention_plain
    monkeypatch.setattr(fa, "flash_attention_plain",
                        lambda *a, **k: flash_calls.append(a[0].shape) or plain(*a, **k))
    got = model(torch.from_numpy(lat), 0.7, torch.from_numpy(ctx) if with_ctx else None)
    want = jdit.DiTVideo(jcfg).apply(params, jnp.asarray(lat), 0.7,
                                     jnp.asarray(ctx) if with_ctx else None)
    _close(got, want)
    # joint3d: every block's self-attention over 4 x 128 tokens at d = 72
    assert flash_calls == ([(1, 512, 2, 72)] * 2 if mode == "joint3d" else [])


def test_dit_factorized_frame_attention_switch(monkeypatch):
    """VDPP_TEMPORAL_ATTN=pallas on both sides: the temporal block runs the
    JAX frame-attention kernel and the port's frame_attention at d = 72."""
    jcfg, tcfg = _cfgs("factorized")
    params = _redraw(jcfg, 4)
    model = tdit.DiTVideo(tcfg, device="cpu")
    model.load_state_dict(from_jax_dit_params(params))
    lat, ctx = _inputs(5)
    monkeypatch.setenv("VDPP_TEMPORAL_ATTN", "pallas")
    got = model(torch.from_numpy(lat), -1.3, torch.from_numpy(ctx))
    want = jdit.DiTVideo(jcfg).apply(params, jnp.asarray(lat), -1.3, jnp.asarray(ctx))
    _close(got, want)


def _wrappers(jcfg, solver: str, steps: int):
    tcfg = tdit.DiTVideoConfig(**{**dataclasses.asdict(_cfgs(jcfg.attention_mode)[1])})
    return (jdit.DiTVideoWrapper(jcfg, num_steps=steps, solver=solver),
            tdit.DiTVideoWrapper(tcfg, num_steps=steps, solver=solver, device="cpu"))


def _contexts(ctx_np, neg_np):
    t_ctx, j_ctx = torch.from_numpy(ctx_np), jnp.asarray(ctx_np)
    if neg_np is None:
        return t_ctx, j_ctx
    return (torch.from_numpy(neg_np), t_ctx), (jnp.asarray(neg_np), j_ctx)


@pytest.mark.parametrize("solver", ["euler", "flowmatch", "heun", "dpmpp2m"])
@pytest.mark.parametrize("negative", [False, True])
def test_wrapper_step_matches_jax(pair, solver, negative):
    """One CFG step (ramp to 6 over the frames) from the second sigma, with
    zeros or a negative prompt's tokens as the uncond context (dpmpp2m: on
    its packed payload, x0_hat slot drawn too, so the second-order branch
    reads it)."""
    _, jcfg, params, model = pair
    jw, tw = _wrappers(jcfg, solver, 4)
    lat, ctx = _inputs(6)
    neg = np.random.default_rng(7).standard_normal(ctx.shape).astype(np.float32) \
        if negative else None
    t_ctx, j_ctx = _contexts(ctx, neg)
    x = lat * tw.init_noise_sigma
    if solver == "dpmpp2m":
        x = np.concatenate([x, lat], axis=-1)
    assert tw.init_noise_sigma == jw.init_noise_sigma
    got = tw.step(model, torch.from_numpy(x), 1, t_ctx, make_guidance_ramp(6.0, F))
    want = jw.step(params, jnp.asarray(x), 1, j_ctx, jax_ramp(6.0, F))
    _close(got, want)


@pytest.mark.parametrize("pair,solver", [("joint3d", "euler"), ("factorized", "flowmatch")],
                         indirect=["pair"])
def test_wrapper_schedule_matches_jax(pair, solver):
    """A 3-step schedule through both packages' run_reference_single_device,
    negative-prompt CFG, two samples."""
    _, jcfg, params, model = pair
    jw, tw = _wrappers(jcfg, solver, 3)
    rng = np.random.default_rng(8)
    noise = rng.standard_normal((2, 1, F, H, W, 4)).astype(np.float32) * tw.init_noise_sigma
    ctx = rng.standard_normal((1, 5, CROSS)).astype(np.float32)
    neg = rng.standard_normal((1, 5, CROSS)).astype(np.float32)
    t_ctx, j_ctx = _contexts(ctx, neg)
    got = run_reference_single_device(tw.pipeline_step_fn(),
                                      (model, t_ctx, make_guidance_ramp(6.0, F)),
                                      tw.pack_initial(torch.from_numpy(noise)), 3)
    want = jax_run(jw.pipeline_step_fn(), (params, j_ctx, jax_ramp(6.0, F)),
                   jw.pack_initial(jnp.asarray(noise)), 3)
    _close(tw.unpack_final(got), jw.unpack_final(want))


@pytest.mark.parametrize("pair", ["joint3d"], indirect=True)
def test_euler_a_matches_jax_at_the_pipeline_stage_counts(pair):
    """euler_a, 4 CFG steps of two samples. This wrapper draws on
    ``step_idx`` (the reference's DiT folds there; its SVD wrapper on the
    real step). With JAX's draws (``fold_in(sampler_seed, step_idx)``)
    injected, the port's single-device run is within REL_TOL of JAX's; with
    the port's own generator, its StepPipeline at 1 stage and at 2 (spawned
    ranks over gloo, 2 steps each) equals its single-device run bit for bit."""
    from vdpp_tpu_torch.parallel.mesh import Stage, make_pipeline_mesh, run_stages
    from vdpp_tpu_torch.parallel.pipeline import PipelineConfig, StepPipeline

    _, jcfg, params, model = pair
    tcfg, steps, seed = _cfgs("joint3d")[1], 4, 3
    rng = np.random.default_rng(9)
    jw = jdit.DiTVideoWrapper(jcfg, num_steps=steps, solver="euler_a", sampler_seed=seed)
    x = rng.standard_normal((2, 1, F, H, W, 4)).astype(np.float32) * jw.init_noise_sigma
    ctx = rng.standard_normal((1, 5, CROSS)).astype(np.float32)
    bundle = (model, torch.from_numpy(ctx), make_guidance_ramp(6.0, F))
    job = functools.partial(helpers.dit_build, tcfg, steps, model.state_dict(), bundle[1],
                            bundle[2], solver="euler_a", sampler_seed=seed)
    with ThreadPoolExecutor(1) as pool:  # the ranks start while JAX runs
        ranks = pool.submit(run_stages, make_pipeline_mesh(2, device="cpu"),
                            helpers.pipeline_cases,
                            [("euler_a", job, torch.from_numpy(x), steps, False)],
                            timeout=300)
        want = jax_run(jw.pipeline_step_fn(), (params, jnp.asarray(ctx), jax_ramp(6.0, F)),
                       jnp.asarray(x), steps)
        table = {k: np.asarray(jax.random.normal(jax.random.fold_in(jax.random.key(seed), k),
                                                 x.shape[1:], jnp.float32))
                 for k in range(steps)}
        tw = tdit.DiTVideoWrapper(tcfg, num_steps=steps, solver="euler_a", sampler_seed=seed,
                                  device="cpu", noise_source=helpers.NoiseTable(table))
        _close(run_reference_single_device(tw.pipeline_step_fn(), bundle, torch.from_numpy(x),
                                           steps), want)
        own = tdit.DiTVideoWrapper(tcfg, num_steps=steps, solver="euler_a", sampler_seed=seed,
                                   device="cpu")
        oracle = run_reference_single_device(own.pipeline_step_fn(), bundle,
                                             torch.from_numpy(x), steps)
        one = StepPipeline(Stage(make_pipeline_mesh(1, device="cpu"), 0), own.pipeline_step_fn(),
                           PipelineConfig(steps, 1)).run(bundle, torch.from_numpy(x))
        assert torch.equal(one, oracle)
        assert torch.equal(ranks.result()[-1]["euler_a"], oracle)


def test_unported_options_raise():
    # The seq, cfg and expert axes and the MoE feed-forwards run
    # (tests/test_torch_port_dit_parallel.py, tests/test_torch_port_moe.py);
    # the DiT has no frame axis, and a rank holding part of the experts needs
    # the expert axis they were split over.
    w = tdit.DiTVideoWrapper(tdit.DiTVideoConfig.tiny(), device="cpu")
    with pytest.raises(ValueError, match="frame axis"):
        w.pipeline_step_fn(frame_axis=object())
    moe = tdit.DiTVideoWrapper(tdit.DiTVideoConfig.moe_tiny(), device="cpu")
    model = moe.init(torch.Generator().manual_seed(0))
    shard_experts(model, Axis("expert", 2, 0, (0, 1), group=None))
    with pytest.raises(ValueError, match="all 4 experts"):
        model(torch.zeros(1, 2, 4, 4, 4), 0.0)


def test_presets_match_jax():
    for name in ("latte_xl", "joint3d_xl", "tiny", "joint3d_tiny"):
        j, t = getattr(jdit.DiTVideoConfig, name)(), getattr(tdit.DiTVideoConfig, name)()
        jd = {k: v for k, v in dataclasses.asdict(j).items() if k != "dtype"}
        td = {k: v for k, v in dataclasses.asdict(t).items() if k != "dtype"}
        assert jd == td, name
        assert str(t.dtype).split(".")[-1] == jnp.dtype(j.dtype).name


def test_load_jax_npz_reads_save_params(tmp_path):
    """A file written by the JAX package's save_params, with bf16 leaves
    (stored as uint16 views) and fp32 ones, loads into the port's DiT."""
    jcfg = jdit.DiTVideoConfig.joint3d_tiny(dtype=jnp.bfloat16)
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                    _redraw(jcfg, 9))
    path = save_params(params, str(tmp_path / "dit.npz"))
    tree = load_jax_npz(path)
    assert isinstance(tree["blocks"], list) and len(tree["blocks"]) == 4
    w = tree["blocks"][0]["attn"]["to_q"]["w"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.float().numpy(), np.asarray(params["blocks"][0]["attn"]["to_q"]["w"], np.float32))
    model = tdit.DiTVideo(tdit.DiTVideoConfig.joint3d_tiny(dtype=torch.bfloat16), device="cpu")
    model.load_state_dict(from_jax_dit_params(tree), strict=True)
    torch.testing.assert_close(model.blocks[0].attn.to_q.weight.float(), w.float().T,
                               atol=0, rtol=0)


@pytest.mark.parametrize("mode,solver", [("joint3d", "euler"), ("factorized", "flowmatch")])
def test_app_tiny_on_cpu_writes_a_video(tmp_path, mode, solver):
    from vdpp_tpu_torch.apps import generate_video_text as app

    rc = app.main(["--random-weights", "--preset", "tiny", "--device", "cpu", "--num-frames",
                   "4", "--steps", "2", "--attention-mode", mode, "--solver", solver,
                   "--negative-prompt", "blurry", "--output-dir", str(tmp_path),
                   "--log-level", "WARNING"])
    assert rc == 0
    suffixes = {p.suffix for p in tmp_path.iterdir() if p.stat().st_size > 0}
    assert ".gif" in suffixes and suffixes & {".mp4", ".avi", ".y4m"}, suffixes


def test_app_pipelined_writes_the_same_files(tmp_path):
    """``--num-stages 2`` (two processes over gloo: rank 0 runs T5, the last
    rank decodes) writes the files ``--num-stages 1`` writes, byte for
    byte, here with heun and a negative prompt."""
    from vdpp_tpu_torch.apps import generate_video_text as app

    argv = ["--random-weights", "--preset", "tiny", "--device", "cpu", "--num-frames", "4",
            "--steps", "2", "--solver", "heun", "--negative-prompt", "blurry",
            "--log-level", "WARNING", "--output-dir"]
    with ThreadPoolExecutor(1) as pool:  # the ranks start while one stage runs here
        two = pool.submit(app.main, argv + [str(tmp_path / "s2"), "--num-stages", "2"])
        assert app.main(argv + [str(tmp_path / "s1")]) == 0
        assert two.result() == 0
    files = {d: {p.suffix: p.read_bytes() for p in (tmp_path / d).iterdir()}
             for d in ("s1", "s2")}
    assert ".gif" in files["s1"] and len(files["s1"]) >= 2
    assert files["s2"] == files["s1"]


def test_app_refuses_what_it_cannot_run(tmp_path, monkeypatch):
    from vdpp_tpu_torch.apps import generate_video_text as app

    base = ["--preset", "tiny", "--device", "cpu", "--output-dir", str(tmp_path)]
    assert app.main(base) == 1  # neither --checkpoint nor --random-weights
    assert app.main(base + ["--random-weights", "--negative-prompt", "x",
                            "--guidance-scale", "1"]) == 1
    # --seq-parallel runs (tests/test_torch_port_dit_parallel.py); 2 stages of
    # 2 seq ranks do not fit on 2 devices.
    with pytest.raises(ValueError, match="devices"):
        app.main(base + ["--random-weights", "--seq-parallel", "2", "--num-stages", "2",
                         "--devices", "cpu", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main(["--random-weights", "--preset", "tiny", "--output-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdit.DiTVideoWrapper(tdit.DiTVideoConfig.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdit.DiTVideo(tdit.DiTVideoConfig.tiny())


def test_video_writers_match_jax(tmp_path):
    from vdpp_tpu.utils.video_io import frames_to_uint8 as jax_frames_to_uint8

    from vdpp_tpu_torch.utils import native, video_io

    video = np.random.default_rng(10).uniform(-1.3, 1.3, (3, 6, 10, 3)).astype(np.float32)
    frames = video_io.frames_to_uint8(video)
    np.testing.assert_array_equal(frames, jax_frames_to_uint8(video))
    path = native.write_y4m(str(tmp_path / "v.y4m"), frames, fps=8)
    data = open(path, "rb").read()
    header = b"YUV4MPEG2 W10 H6 F8:1 Ip A1:1 C420jpeg\n"
    assert data.startswith(header)
    assert len(data) == len(header) + 3 * (len(b"FRAME\n") + 6 * 10 * 3 // 2)
    name = video_io.build_output_name("dit_text", num_frames=8, steps=24, stages=1, fps=8,
                                      seed=42, ext="mp4")
    assert name.startswith("dit_text_") and name.endswith("_f8_s24_st1_fps8_seed42.mp4")
