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
from vdpp_tpu_torch.models.clip_encoder import CLIPVisionConfig, CLIPVisionEncoder
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


def test_image_to_video_matches_the_jax_sequence():
    """The app's device work at the tiny preset, 48x32 (H != W, so a
    transposed axis fails), 4 frames, 2 steps of CFG sequential Euler,
    against ``scripts/generate_video.py``'s sequence in JAX. The weights are
    drawn once, from a numpy seed, and reach each side through its
    converter. (The flash route at this preset is held by
    ``test_torch_port_model.py`` and ``test_torch_port_vae.py``; here every
    attention is below L = 512, which keeps the JAX side to one compile of
    each model.)"""
    w, h = 48, 32
    frames, steps, seed = 4, 2, 42
    unet_j = JaxUNetConfig.tiny()
    clip_j = dataclasses.replace(JaxClipConfig.tiny(), projection_dim=unet_j.cross_attention_dim)
    vae_j = JaxVAEConfig.tiny()
    jmodel = JaxSVD(unet_j, num_steps=steps, cfg_mode="sequential")
    jclip, jenc, jdec = JaxClip(clip_j), JaxEncoder(vae_j), JaxDecoder(vae_j)
    # The port's modules, and the JAX trees of the same weights: drawn from a
    # numpy seed with the checkpoint names, through the JAX converters.
    wrapper = StableVideoUNet(SVDUNetConfig.tiny(), num_steps=steps, device="cpu")
    models = {"unet": SVDUNet(SVDUNetConfig.tiny(), device="cpu"),
              "clip": CLIPVisionEncoder(dataclasses.replace(
                  CLIPVisionConfig.tiny(), projection_dim=48), device="cpu"),
              "vae_encoder": VAEEncoder(VAEConfig.tiny(), device="cpu"),
              "vae_decoder": TemporalVAEDecoder(VAEConfig.tiny(), device="cpu")}
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    sd = {k: random_state_dict(m, i, mix_base=0.5) for i, (k, m) in enumerate(models.items())}
    p_unet = to_np(convert_unet_state_dict(sd["unet"], num_levels=2, layers_per_block=1,
                                           dtype=jnp.float32))
    p_clip = to_np(convert_clip_state_dict(sd["clip"], num_layers=2, patch_size=8))
    p_enc = to_np(convert_vae_encoder_state_dict(sd["vae_encoder"], num_levels=2,
                                                 layers_per_block=1))
    p_dec = to_np(convert_vae_decoder_state_dict(sd["vae_decoder"], num_levels=2,
                                                 layers_per_block=1))
    models["unet"].load_state_dict(weights.from_jax_params(p_unet))
    models["clip"].load_state_dict(weights.from_jax_clip_params(p_clip))
    models["vae_encoder"].load_state_dict(weights.from_jax_vae_encoder_params(p_enc))
    models["vae_decoder"].load_state_dict(weights.from_jax_vae_decoder_params(p_dec))

    # The JAX app's inputs and noise draws.
    image = _jax_app().load_and_preprocess_image(None, w, h)
    clip_px = jax_preprocess(((image + 1.0) * 127.5).astype(np.uint8), size=clip_j.image_size)
    aug = np.array(jax.random.normal(jax.random.key(seed + 4), image.shape, jnp.float32))
    lat_noise = np.array(jax.random.normal(jax.random.key(seed), (1, 1, frames, h // 2, w // 2, 4)))

    # The JAX sequence (scripts/generate_video.py).
    emb = jax.jit(jclip.apply)(p_clip, jnp.asarray(clip_px, jnp.float32)[None])
    moments = jax.jit(jenc.apply)(p_enc, jnp.asarray(image)[None] + 0.02 * jnp.asarray(aug))
    lat = jnp.repeat(jenc.mode(moments)[:, None], frames, axis=1)
    cond = jax_conditioning(emb, lat, frames, fps=7, motion_bucket_id=127,
                            noise_aug_strength=0.02, guidance_scale=3.0)
    # ``run_reference_single_device``'s loop (which ``StepPipeline.run`` equals)
    # for the one sample, with the step jitted alone: about half the compile
    # time of its scan under vmap.
    step_fn = jax.jit(jmodel.pipeline_step_fn())
    x = jnp.asarray(lat_noise[0]) * jmodel.init_noise_sigma
    for k in range(steps):
        x = step_fn((p_unet, cond), x, jnp.int32(k))
    latents = x[None]
    decode = jax.jit(lambda p, x: jdec.decode_chunked(p, x, chunk_frames=4))
    want = np.asarray(decode(p_dec, latents[0] / vae_j.scaling_factor))

    # The port, on the same weights and inputs.
    fa.launches.clear()
    videos, times = app.image_to_video(models, wrapper, image, clip_px, aug, lat_noise,
                                       num_frames=frames, fps=7, guidance_scale=3.0)
    assert not fa.launches  # CPU tensors take the plain version, never the kernel
    assert set(models) == {"vae_decoder"}  # CLIP, the encoder and the UNet were let go
    assert set(times) == {"clip", "vae_encode", "encode", "diffusion", "decode"}
    got = videos[0]
    assert tuple(got.shape) == want.shape == (1, frames, h, w, 3)
    assert np.isfinite(want).all() and torch.isfinite(got).all()
    err = np.abs(got.numpy() - want).max()
    assert err <= REL_TOL * np.abs(want).max(), (err, np.abs(want).max())


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
    for extra, item in ((["--solver", "euler_a"], "A12"), (["--deepcache", "2"], "A12"),
                        (["--seq-parallel", "2"], "A13"),
                        (["--frame-parallel", "2"], "A13"), (["--decode-devices", "1"], "A13")):
        with pytest.raises(NotImplementedError, match=item):
            app.main(run + extra)
    monkeypatch.setitem(sys.modules, "PIL", None)  # Pillow missing: --image names it
    with pytest.raises(RuntimeError, match="Pillow"):
        app.load_and_preprocess_image(str(tmp_path / "x.png"), 64, 64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main(["--random-weights", "--preset", "tiny", "--output-dir", str(tmp_path)])
