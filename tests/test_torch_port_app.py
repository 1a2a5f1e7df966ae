"""The port's image->video app (``vdpp_tpu_torch.apps.generate_video``) and
its weight loaders (``vdpp_tpu_torch.utils.weights.load_safetensors`` and
``load_svd_checkpoint``) against the JAX package's, on the CPU.

The app's device work (``image_to_video``) runs at the tiny preset against
the same sequence in JAX (``scripts/generate_video.py``: CLIP, VAE encode of
the noise-augmented image, ``.mode()``, ``make_conditioning``, two CFG
sequential Euler steps, ``decode_chunked``) on the same weights (drawn from
a numpy seed with the checkpoint names, turned into JAX trees by the JAX
package's converters and carried back by the port's ``from_jax_*``), and
with JAX's noise draws and preprocessed arrays passed in. Tolerance on the video:
max|diff| <= 1e-4 * max|ref|, as for the UNet's steps (fp32 both sides,
summation order alone through four models).
"""

import dataclasses
import importlib.util
import os
from concurrent.futures import ThreadPoolExecutor
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import save_file

from vdpp_tpu.models.clip_encoder import CLIPVisionConfig as JaxClipConfig
from vdpp_tpu.models.clip_encoder import CLIPVisionEncoder as JaxClip
from vdpp_tpu.models.clip_encoder import preprocess_image as jax_preprocess
from vdpp_tpu.models.svd_unet import SVDUNet as JaxUNet
from vdpp_tpu.models.svd_unet import SVDUNetConfig as JaxUNetConfig
from vdpp_tpu.models.svd_wrapper import StableVideoUNet as JaxSVD
from vdpp_tpu.models.svd_wrapper import make_conditioning as jax_conditioning
from vdpp_tpu.models.vae import TemporalVAEDecoder as JaxDecoder
from vdpp_tpu.models.vae import VAEConfig as JaxVAEConfig
from vdpp_tpu.models.vae import VAEEncoder as JaxEncoder
from vdpp_tpu.utils.weights import (
    convert_clip_state_dict,
    convert_unet_state_dict,
    convert_vae_decoder_state_dict,
    convert_vae_encoder_state_dict,
    save_params,
)

from vdpp_tpu_torch.apps import generate_video as app
from vdpp_tpu_torch.models.clip_encoder import (
    CLIPVisionConfig,
    CLIPVisionEncoder,
    preprocess_image,
)
from vdpp_tpu_torch.models.svd_unet import SVDUNet, SVDUNetConfig
from vdpp_tpu_torch.models.svd_wrapper import StableVideoUNet
from vdpp_tpu_torch.models.vae import TemporalVAEDecoder, VAEConfig, VAEEncoder
from vdpp_tpu_torch.ops import flash_attention as fa
from vdpp_tpu_torch.utils import weights

from torch_port_helpers import one_torch_thread, random_state_dict  # noqa: F401

REL_TOL = 1e-4
ROOT = Path(__file__).resolve().parent.parent
KEYS_FIXTURE = ROOT / "tests" / "fixtures" / "svd_xt_unet_keys.txt"


def _jax_app():
    """``scripts/generate_video.py`` as a module (its helpers, not its main)."""
    spec = importlib.util.spec_from_file_location("jax_generate_video",
                                                  ROOT / "scripts" / "generate_video.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------ safetensors ------------------------------ #
def test_load_safetensors_is_bit_equal(tmp_path):
    """F32, F16 and BF16 tensors (and an I64 one, as an HF CLIP checkpoint's
    ``position_ids``) read back bit for bit as ``safetensors`` reads them."""
    from safetensors.torch import load_file

    g = torch.Generator().manual_seed(0)
    tensors = {"a.f32": torch.randn(3, 5, generator=g),
               "b.f16": torch.randn(7, generator=g).half(),
               "c.bf16": torch.randn(2, 3, 4, generator=g).bfloat16(),
               "d.scalar": torch.tensor(1.5),
               "e.empty": torch.zeros(0, 4),
               "position_ids": torch.arange(9)[None]}
    path = str(tmp_path / "t.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    want = load_file(path)
    got = weights.load_safetensors(path)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k].reshape(-1).view(torch.uint8),
                           v.reshape(-1).view(torch.uint8)), k


def _tiny_modules():
    unet = SVDUNet(SVDUNetConfig.tiny(), device="cpu").init_weights(
        torch.Generator().manual_seed(1))
    enc = VAEEncoder(VAEConfig.tiny(), device="cpu").init_weights(torch.Generator().manual_seed(2))
    dec = TemporalVAEDecoder(VAEConfig.tiny(), device="cpu").init_weights(
        torch.Generator().manual_seed(3))
    clip = CLIPVisionEncoder(CLIPVisionConfig.tiny(), device="cpu").init_weights(
        torch.Generator().manual_seed(4))
    for m in (unet, enc, dec, clip):  # move every value off its init
        g = torch.Generator().manual_seed(5)
        with torch.no_grad():
            for p in m.parameters():
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    return {"unet": unet, "vae_encoder": enc, "vae_decoder": dec, "clip": clip}


def test_load_svd_checkpoint_by_name(tmp_path):
    """A diffusers-layout directory written here (the UNet in two fp16
    shards, the VAE with a ``quant_conv`` the port has no use for, the tower
    with its ``position_ids``) loads into the port's modules by name."""
    mods = _tiny_modules()
    for sub in ("unet", "vae", "image_encoder"):
        os.makedirs(tmp_path / sub)
    unet_sd = {k: v.half() for k, v in mods["unet"].state_dict().items()}
    keys = sorted(unet_sd)
    save_file({k: unet_sd[k] for k in keys[:100]}, str(tmp_path / "unet" / "a.safetensors"))
    save_file({k: unet_sd[k] for k in keys[100:]}, str(tmp_path / "unet" / "b.safetensors"))
    vae_sd = {**mods["vae_encoder"].state_dict(), **mods["vae_decoder"].state_dict(),
              "quant_conv.weight": torch.zeros(8, 8, 1, 1), "quant_conv.bias": torch.zeros(8)}
    save_file(vae_sd, str(tmp_path / "vae" / "diffusion_pytorch_model.safetensors"))
    clip_sd = {**mods["clip"].state_dict(),
               "vision_model.embeddings.position_ids": torch.arange(17)[None]}
    save_file(clip_sd, str(tmp_path / "image_encoder" / "model.safetensors"))

    got = weights.load_svd_checkpoint(str(tmp_path), unet_config=SVDUNetConfig.tiny(),
                                      vae_config=VAEConfig.tiny(),
                                      clip_config=CLIPVisionConfig.tiny(), device="cpu")
    assert set(got) == set(mods)
    for name, m in mods.items():
        want = m.state_dict()
        have = got[name].state_dict()
        assert set(have) == set(want), name
        for k, v in want.items():
            ref = v.half().float() if name == "unet" else v  # stored as fp16
            assert torch.equal(have[k], ref), (name, k)

    os.remove(tmp_path / "unet" / "b.safetensors")  # a missing shard is refused
    with pytest.raises(KeyError, match="unet: missing keys"):
        weights.load_svd_checkpoint(str(tmp_path), unet_config=SVDUNetConfig.tiny(),
                                    vae_config=VAEConfig.tiny(),
                                    clip_config=CLIPVisionConfig.tiny(), device="cpu")


def test_unet_loader_is_pinned_to_the_svd_xt_keys():
    """The loader takes the SVD-XT UNet by the 1428 checkpoint keys and no
    other set: one key fewer or one more is refused."""
    keys = KEYS_FIXTURE.read_text().split()
    assert len(keys) == 1428
    unet = SVDUNet(SVDUNetConfig.svd_xt(), device="meta")
    shapes = {k: v.shape for k, v in unet.state_dict().items()}
    sd = {k: torch.empty(shapes[k], device="meta") for k in keys}
    weights._load_by_name(unet, sd, "unet", strict=True)
    with pytest.raises(KeyError, match="missing keys"):
        weights._load_by_name(unet, {k: v for k, v in sd.items() if k != keys[7]}, "unet",
                              strict=True)
    with pytest.raises(KeyError, match="unexpected keys"):
        weights._load_by_name(unet, {**sd, "extra.weight": torch.empty(1, device="meta")},
                              "unet", strict=True)


# ------------------------------ the app ---------------------------------- #
def test_load_and_preprocess_image_matches_jax(tmp_path):
    """The synthetic card at the target size is reproduced exactly without
    Pillow; a file of another aspect goes through Pillow's crop and LANCZOS
    resize as in the reference, so it also agrees exactly."""
    from PIL import Image

    jax_app = _jax_app()
    for w, h in ((64, 64), (96, 64)):
        np.testing.assert_array_equal(app.load_and_preprocess_image(None, w, h),
                                      jax_app.load_and_preprocess_image(None, w, h))
    img = (np.random.default_rng(6).random((50, 90, 3)) * 255).astype(np.uint8)
    path = str(tmp_path / "in.png")
    Image.fromarray(img).save(path)
    np.testing.assert_array_equal(app.load_and_preprocess_image(path, 64, 48),
                                  jax_app.load_and_preprocess_image(path, 64, 48))


@pytest.fixture(scope="module")
def tiny_pair():
    """The tiny preset's four models in both packages with the same weights
    (drawn once from a numpy seed with the checkpoint names, through each
    side's converter), the JAX ones jitted once for the module: ``(jax,
    port)``, where ``jax`` holds the parameter trees and the jitted calls
    and ``port()`` builds fresh port modules holding the weights."""
    unet_j = JaxUNetConfig.tiny()
    clip_j = dataclasses.replace(JaxClipConfig.tiny(), projection_dim=unet_j.cross_attention_dim)
    vae_j = JaxVAEConfig.tiny()
    jclip, jenc, jdec = JaxClip(clip_j), JaxEncoder(vae_j), JaxDecoder(vae_j)
    build = {"unet": lambda: SVDUNet(SVDUNetConfig.tiny(), device="cpu"),
             "clip": lambda: CLIPVisionEncoder(dataclasses.replace(
                 CLIPVisionConfig.tiny(), projection_dim=48), device="cpu"),
             "vae_encoder": lambda: VAEEncoder(VAEConfig.tiny(), device="cpu"),
             "vae_decoder": lambda: TemporalVAEDecoder(VAEConfig.tiny(), device="cpu")}
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    sd = {k: random_state_dict(b(), i, mix_base=0.5) for i, (k, b) in enumerate(build.items())}
    p = {"unet": to_np(convert_unet_state_dict(sd["unet"], num_levels=2, layers_per_block=1,
                                               dtype=jnp.float32)),
         "clip": to_np(convert_clip_state_dict(sd["clip"], num_layers=2, patch_size=8)),
         "vae_encoder": to_np(convert_vae_encoder_state_dict(sd["vae_encoder"], num_levels=2,
                                                             layers_per_block=1)),
         "vae_decoder": to_np(convert_vae_decoder_state_dict(sd["vae_decoder"], num_levels=2,
                                                             layers_per_block=1))}
    carry = {"unet": weights.from_jax_params, "clip": weights.from_jax_clip_params,
             "vae_encoder": weights.from_jax_vae_encoder_params,
             "vae_decoder": weights.from_jax_vae_decoder_params}
    states = {k: carry[k](p[k]) for k in build}

    def port() -> dict:
        models = {k: b() for k, b in build.items()}
        for k, m in models.items():
            m.load_state_dict(states[k])
        return models

    static = ("seq_axis", "seq_shards", "frame_axis", "frame_shards")
    jax_side = {"params": p, "unet": JaxUNetConfig.tiny(), "vae": vae_j, "enc": jenc,
                "clip_size": clip_j.image_size,
                "clip": jax.jit(jclip.apply), "encode": jax.jit(jenc.apply),
                "apply": jax.jit(JaxUNet(unet_j).apply, static_argnames=static),
                "decode": jax.jit(lambda p, x: jdec.decode_chunked(p, x, chunk_frames=4))}
    return jax_side, port


def _jax_denoise(j, jmodel, cond, x, steps: int):
    """JAX's steps one by one, eager around the module's jitted UNet call
    (``run_reference_single_device``'s loop for one sample)."""
    jmodel.unet.apply = j["apply"]
    for k in range(steps):
        x = jmodel.step(j["params"]["unet"], x, jnp.int32(k), cond)
    return x


def _jax_cond(j, image, clip_px, aug, frames: int):
    """``scripts/generate_video.py``'s conditioning: CLIP, the VAE encode of
    the noise-augmented image, ``.mode()``, ``make_conditioning``."""
    emb = j["clip"](j["params"]["clip"], jnp.asarray(clip_px, jnp.float32)[None])
    moments = j["encode"](j["params"]["vae_encoder"], jnp.asarray(image)[None]
                          + 0.02 * jnp.asarray(aug))
    lat = jnp.repeat(j["enc"].mode(moments)[:, None], frames, axis=1)
    return jax_conditioning(emb, lat, frames, fps=7, motion_bucket_id=127,
                            noise_aug_strength=0.02, guidance_scale=3.0)


def _assert_video_close(got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(want).all() and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= REL_TOL * np.abs(want).max(), (err, np.abs(want).max())


def test_image_to_video_matches_the_jax_sequence(tiny_pair):
    """The app's device work at the tiny preset, 48x32 (H != W, so a
    transposed axis fails), 4 frames, 2 steps of CFG sequential Euler,
    against ``scripts/generate_video.py``'s sequence in JAX. The weights are
    drawn once, from a numpy seed, and reach each side through its
    converter. (The flash route at this preset is held by
    ``test_torch_port_model.py`` and ``test_torch_port_vae.py``; here every
    attention is below L = 512, which keeps the JAX side to one compile of
    each model.)"""
    j, port = tiny_pair
    w, h = 48, 32
    frames, steps, seed = 4, 2, 42
    jmodel = JaxSVD(j["unet"], num_steps=steps, cfg_mode="sequential")
    wrapper = StableVideoUNet(SVDUNetConfig.tiny(), num_steps=steps, device="cpu")
    models = port()

    # The JAX app's inputs and noise draws.
    image = _jax_app().load_and_preprocess_image(None, w, h)
    clip_px = jax_preprocess(((image + 1.0) * 127.5).astype(np.uint8), size=j["clip_size"])
    aug = np.array(jax.random.normal(jax.random.key(seed + 4), image.shape, jnp.float32))
    lat_noise = np.array(jax.random.normal(jax.random.key(seed), (1, 1, frames, h // 2, w // 2, 4)))

    # The JAX sequence (scripts/generate_video.py).
    cond = _jax_cond(j, image, clip_px, aug, frames)
    x = _jax_denoise(j, jmodel, cond, jnp.asarray(lat_noise[0]) * jmodel.init_noise_sigma, steps)
    want = np.asarray(j["decode"](j["params"]["vae_decoder"], x / j["vae"].scaling_factor))

    # The port, on the same weights and inputs.
    fa.launches.clear()
    videos, times = app.image_to_video(models, wrapper, image, clip_px, aug, lat_noise,
                                       num_frames=frames, fps=7, guidance_scale=3.0)
    assert not fa.launches  # CPU tensors take the plain version, never the kernel
    assert set(models) == {"vae_decoder"}  # CLIP, the encoder and the UNet were let go
    assert set(times) == {"clip", "vae_encode", "encode", "diffusion", "decode"}
    assert tuple(videos[0].shape) == (1, frames, h, w, 3)
    _assert_video_close(videos[0], want)


def test_restyle_matches_the_jax_sequence(tiny_pair):
    """``apps.restyle_video.restyle`` at the tiny preset on 4 frames of
    48x32: strength 0.5 of 4 steps runs the last 2 (``denoise_from`` 2), from
    ``x0 + sigma_start * noise``, against ``scripts/restyle_video.py``'s
    sequence in JAX (frame 0 conditions; every frame's clean latent is
    ``.mode()`` x the scaling factor, encoded in one chunk of 4). JAX's
    noise draws are injected; CLIP's pixels are the port's
    ``preprocess_image`` on both sides (held apart in
    ``test_torch_port_clip.py``)."""
    from vdpp_tpu_torch.apps import restyle_video as restyle
    from vdpp_tpu_torch.parallel.mesh import Stage, make_pipeline_mesh

    j, port = tiny_pair
    frames_u8 = np.random.default_rng(50).integers(0, 256, (4, 32, 48, 3), dtype=np.uint8)
    args = restyle.build_parser().parse_args(
        ["--input", "-", "--random-weights", "--preset", "tiny", "--device", "cpu",
         "--strength", "0.5", "--steps", "4"])
    wrapper = restyle.wrapper_for(args, SVDUNetConfig.tiny(), 1, "cpu")
    assert restyle.denoise_from(0.5, 4) == 2 and wrapper.num_steps == 2
    frames = frames_u8.astype(np.float32) / 127.5 - 1.0
    clip_px = preprocess_image(frames_u8[0], size=j["clip_size"]).numpy()
    draws = {"aug": np.array(jax.random.normal(jax.random.key(46), frames[0].shape, jnp.float32)),
             "latent": np.array(jax.random.normal(jax.random.key(42), (1, 1, 4, 16, 24, 4),
                                                  jnp.float32))}

    jmodel = JaxSVD(j["unet"], num_steps=4, denoise_from=2, cfg_mode="sequential")
    assert jmodel.sigma_start == wrapper.sigma_start
    cond = _jax_cond(j, frames[0], clip_px, draws["aug"], 4)
    x0 = (j["enc"].mode(j["encode"](j["params"]["vae_encoder"], jnp.asarray(frames)))
          * j["vae"].scaling_factor)[None]
    x = _jax_denoise(j, jmodel, cond, x0 + jmodel.sigma_start * draws["latent"][0], 2)
    want = np.asarray(j["decode"](j["params"]["vae_decoder"], x / j["vae"].scaling_factor))

    models = port()
    got = restyle.restyle(Stage(make_pipeline_mesh(1, device="cpu"), 0), models, wrapper,
                          frames_u8, args, 7,
                          draw=lambda name, shape, dev: torch.from_numpy(draws[name]))
    assert set(models) == {"vae_decoder"}
    _assert_video_close(got, want)


def test_long_video_matches_the_jax_sequence(tiny_pair):
    """``apps.generate_video_long.long_video`` at the tiny preset: 2
    segments of 4 frames of 48x32, 2 Euler steps each, the second segment
    conditioned on the first's last decoded frame, 7 frames in all, against
    ``scripts/generate_video_long.py``'s sequence in JAX, JAX's draws
    injected (augmentation from ``seed + 100 + k``, latents from ``seed +
    k``), CLIP's pixels the port's ``preprocess_image`` on both sides, and
    the JAX side's second segment conditioned on the port's last frame."""
    from vdpp_tpu_torch.apps import generate_video_long as long_app
    from vdpp_tpu_torch.parallel.mesh import Stage, make_pipeline_mesh

    j, port = tiny_pair
    args = long_app.build_parser().parse_args(
        ["--random-weights", "--preset", "tiny", "--device", "cpu", "--width", "48",
         "--height", "32", "--num-frames", "4", "--steps", "2", "--segments", "2"])
    first = _jax_app().load_and_preprocess_image(None, 48, 32)
    draws = {(name, k): np.array(jax.random.normal(jax.random.key(42 + k + (100 if name == "aug"
                                                                        else 0)), shape))
             for k in range(2)
             for name, shape in (("aug", first.shape), ("latent", (1, 1, 4, 16, 24, 4)))}

    wrapper = app.make_wrapper(args, SVDUNetConfig.tiny(), torch.device("cpu"))
    got = long_app.long_video(Stage(make_pipeline_mesh(1, device="cpu"), 0), port(), wrapper,
                              first, args, (16, 24),
                              draw=lambda name, k, shape, dev: torch.from_numpy(
                                  draws[(name, k)]).float())
    assert got.shape == (7, 32, 48, 3)

    jmodel = JaxSVD(j["unet"], num_steps=2, cfg_mode="sequential")
    pieces = []
    # Segment 2 starts from the port's last frame on both sides: the uint8
    # cast of CLIP's input would turn a last-bit difference into a level.
    for k, image in enumerate((first, np.clip(got[3], -1.0, 1.0))):
        clip_px = preprocess_image(((image + 1.0) * 127.5).astype(np.uint8),
                                   size=j["clip_size"]).numpy()
        cond = _jax_cond(j, image, clip_px, draws[("aug", k)], 4)
        x = _jax_denoise(j, jmodel, cond, jnp.asarray(draws[("latent", k)][0])
                         * jmodel.init_noise_sigma, 2)
        vid = np.asarray(j["decode"](j["params"]["vae_decoder"],
                                     x / j["vae"].scaling_factor))[0]
        pieces.append(vid if k == 0 else vid[1:])
    _assert_video_close(got, np.concatenate(pieces))


def _y4m_frames(path: Path) -> tuple[int, int, int]:
    data = path.read_bytes()
    header = data[:data.index(b"\n")].split()
    w = int(next(t[1:] for t in header if t.startswith(b"W")))
    h = int(next(t[1:] for t in header if t.startswith(b"H")))
    return data.count(b"FRAME"), w, h


def test_main_tiny_on_cpu_writes_a_video(tmp_path):
    rc = app.main(["--random-weights", "--device", "cpu", "--preset", "tiny", "--width", "64",
                   "--height", "64", "--num-frames", "4", "--steps", "2", "--output-dir",
                   str(tmp_path), "--log-level", "WARNING"])
    assert rc == 0
    files = {p.suffix: p for p in tmp_path.iterdir() if p.stat().st_size > 0}
    assert ".gif" in files and {".mp4", ".avi", ".y4m"} & set(files), files
    if ".y4m" in files:
        assert _y4m_frames(files[".y4m"]) == (4, 64, 64)


def test_main_pipelined_writes_the_same_files(tmp_path):
    """``--num-stages 2`` (two processes over gloo: rank 0 encodes, the last
    rank decodes) writes the files ``--num-stages 1`` writes, byte for byte,
    here with dpmpp2m, whose x0_hat crosses the hand-off in the payload."""
    argv = ["--random-weights", "--device", "cpu", "--preset", "tiny", "--width", "64",
            "--height", "64", "--num-frames", "4", "--steps", "2", "--solver", "dpmpp2m",
            "--log-level", "WARNING", "--output-dir"]
    with ThreadPoolExecutor(1) as pool:  # the ranks start while one stage runs here
        two = pool.submit(app.main, argv + [str(tmp_path / "s2"), "--num-stages", "2"])
        assert app.main(argv + [str(tmp_path / "s1"), "--num-stages", "1"]) == 0
        assert two.result() == 0
    files = {d: {p.suffix: p.read_bytes() for p in (tmp_path / d).iterdir()}
             for d in ("s1", "s2")}
    assert ".gif" in files["s1"] and len(files["s1"]) >= 2
    assert files["s2"] == files["s1"]
    assert [p.name for p in (tmp_path / "s2").glob("*.gif")][0].count("_st2_") == 1


def test_read_y4m_matches_jax(tmp_path):
    """The port's own ``read_y4m`` reads what the native writer wrote exactly
    as the JAX package's reader does, with the fps; a 10-bit or truncated
    file is refused."""
    from vdpp_tpu.utils.video_io import read_y4m as jax_read_y4m

    from vdpp_tpu_torch.utils import native
    from vdpp_tpu_torch.utils.video_io import read_y4m

    frames = np.random.default_rng(60).integers(0, 256, (3, 16, 24, 3), dtype=np.uint8)
    path = native.write_y4m(str(tmp_path / "a.y4m"), frames, fps=9)
    got, fps = read_y4m(path)
    want, want_fps = jax_read_y4m(path)
    assert fps == want_fps == 9 and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert got.shape == frames.shape
    data = (tmp_path / "a.y4m").read_bytes()
    (tmp_path / "cut.y4m").write_bytes(data[:-10])
    with pytest.raises(ValueError, match="truncated"):
        read_y4m(str(tmp_path / "cut.y4m"))
    (tmp_path / "p10.y4m").write_bytes(data.replace(b"C420jpeg", b"C420p10", 1))
    with pytest.raises(ValueError, match="8-bit"):
        read_y4m(str(tmp_path / "p10.y4m"))


def test_restyle_and_long_pipelined_write_the_same_files(tmp_path):
    """At the tiny preset on the CPU, ``--num-stages 2`` (two processes over
    gloo) writes the files ``--num-stages 1`` writes, byte for byte: the
    restyle app on a 4-frame 64x64 Y4M at strength 0.5 of 5 steps (a 3-step
    tail, padded to 4 over 2 stages) with euler_a x DeepCache-2, and the
    long app, 2 segments of 4 frames, dpmpp2m x DeepCache-2 (7 frames)."""
    from vdpp_tpu_torch.apps import generate_video_long as long_app
    from vdpp_tpu_torch.apps import restyle_video as restyle
    from vdpp_tpu_torch.utils import native

    yy, xx = np.mgrid[0:64, 0:64]
    g = ((yy * 4 + xx * 4) / 2).astype(np.uint8)
    src = native.write_y4m(str(tmp_path / "in.y4m"),
                           np.stack([np.stack([g, np.roll(g, 7 * i, 0), g.T], -1)
                                     for i in range(4)]), fps=7)
    common = ["--random-weights", "--preset", "tiny", "--device", "cpu", "--log-level",
              "WARNING", "--deepcache", "2"]
    runs = {"restyle": (restyle.main, common + ["--input", src, "--strength", "0.5", "--steps",
                                                "5", "--solver", "euler_a"], 4),
            "long": (long_app.main, common + ["--width", "64", "--height", "64", "--num-frames",
                                              "4", "--steps", "2", "--segments", "2",
                                              "--solver", "dpmpp2m"], 7)}
    with ThreadPoolExecutor(2) as pool:  # the ranks start while one stage runs here
        two = {k: pool.submit(main, argv + ["--num-stages", "2", "--output-dir",
                                            str(tmp_path / k / "s2")])
               for k, (main, argv, _) in runs.items()}
        for k, (main, argv, _) in runs.items():
            assert main(argv + ["--num-stages", "1", "--output-dir", str(tmp_path / k / "s1")]) == 0
        assert all(t.result() == 0 for t in two.values())
    for k, (_, _, frames) in runs.items():
        files = {d: {p.suffix: p.read_bytes() for p in (tmp_path / k / d).iterdir()}
                 for d in ("s1", "s2")}
        assert ".gif" in files["s1"] and len(files["s1"]) >= 2, k
        assert files["s2"] == files["s1"], k
        y4m = next((tmp_path / k / "s1").glob("*.y4m"), None)
        if y4m is not None:
            assert _y4m_frames(y4m) == (frames, 64, 64), k


def test_main_reads_npz_and_diffusers_checkpoints(tmp_path):
    """``--checkpoint`` reads both layouts: the JAX package's ``save_params``
    files (written here through its converters) and a diffusers directory
    of ``*.safetensors`` (written here by the ``safetensors`` package). Both
    hold the weights ``--random-weights`` draws, so all three runs write the
    same GIF, byte for byte."""
    steps, seed = 2, 42
    unet_cfg = SVDUNetConfig.tiny()
    wrapper = StableVideoUNet(unet_cfg, num_steps=steps, device="cpu")
    mods = {"unet": wrapper.init(torch.Generator().manual_seed(seed)),
            "clip": CLIPVisionEncoder(dataclasses.replace(
                CLIPVisionConfig.tiny(), projection_dim=unet_cfg.cross_attention_dim),
                device="cpu"),
            "vae_encoder": VAEEncoder(VAEConfig.tiny(), device="cpu"),
            "vae_decoder": TemporalVAEDecoder(VAEConfig.tiny(), device="cpu")}
    for i, name in enumerate(("clip", "vae_encoder", "vae_decoder"), start=1):
        mods[name].init_weights(torch.Generator().manual_seed(seed + i))
    sd = {k: {n: v.numpy() for n, v in m.state_dict().items()} for k, m in mods.items()}

    npz = tmp_path / "npz"
    for name, tree in (
            ("unet", convert_unet_state_dict(sd["unet"], num_levels=2, layers_per_block=1,
                                             dtype=jnp.float32)),
            ("clip", convert_clip_state_dict(sd["clip"], num_layers=2, patch_size=8)),
            ("vae_encoder", convert_vae_encoder_state_dict(sd["vae_encoder"], num_levels=2,
                                                           layers_per_block=1)),
            ("vae_decoder", convert_vae_decoder_state_dict(sd["vae_decoder"], num_levels=2,
                                                           layers_per_block=1))):
        save_params(tree, str(npz / f"{name}.npz"))
    diffusers = tmp_path / "diffusers"
    for sub, parts, file in (("unet", ("unet",), "diffusion_pytorch_model"),
                             ("vae", ("vae_encoder", "vae_decoder"), "diffusion_pytorch_model"),
                             ("image_encoder", ("clip",), "model")):
        os.makedirs(diffusers / sub)
        save_file({k: v for part in parts for k, v in mods[part].state_dict().items()},
                  str(diffusers / sub / f"{file}.safetensors"))

    gifs = {}
    for what, flags in (("random", ["--random-weights"]), ("npz", ["--checkpoint", str(npz)]),
                        ("diffusers", ["--checkpoint", str(diffusers)])):
        out = tmp_path / f"out_{what}"
        assert app.main(flags + ["--device", "cpu", "--preset", "tiny", "--width", "64",
                                 "--height", "64", "--num-frames", "4", "--steps", str(steps),
                                 "--seed", str(seed), "--output-dir", str(out),
                                 "--log-level", "WARNING"]) == 0
        (gif,) = out.glob("*.gif")
        gifs[what] = gif.read_bytes()
    assert gifs["npz"] == gifs["random"]
    assert gifs["diffusers"] == gifs["random"]

    os.remove(diffusers / "image_encoder" / "model.safetensors")  # a part missing is refused
    with pytest.raises(FileNotFoundError, match="clip"):
        app.main(["--checkpoint", str(diffusers), "--device", "cpu", "--preset", "tiny",
                  "--output-dir", str(tmp_path / "out")])


def test_main_refuses_what_it_cannot_run(tmp_path, monkeypatch):
    base = ["--preset", "tiny", "--device", "cpu", "--output-dir", str(tmp_path)]
    assert app.main(base) == 1  # neither --checkpoint nor --random-weights
    run = base + ["--random-weights"]
    # The intra-sample flags' own checks, as the reference's: a latent width
    # (64 / 8 = 8) that 3 x 2 does not divide, frames (4) that 3 does not.
    assert app.main(run + ["--seq-parallel", "3"]) == 1
    assert app.main(run + ["--frame-parallel", "3"]) == 1
    # Two stages and a decode rank on two devices: oversubscribed.
    with pytest.raises(ValueError, match="devices"):
        app.main(run + ["--num-stages", "2", "--decode-devices", "1", "--devices", "cpu", "cpu"])
    monkeypatch.setitem(sys.modules, "PIL", None)  # Pillow missing: --image names it
    with pytest.raises(RuntimeError, match="Pillow"):
        app.load_and_preprocess_image(str(tmp_path / "x.png"), 64, 64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main(["--random-weights", "--preset", "tiny", "--output-dir", str(tmp_path)])
