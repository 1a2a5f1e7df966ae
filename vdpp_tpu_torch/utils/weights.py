"""Carry the JAX package's parameters over to the port.

``from_jax_params`` is the inverse of ``vdpp_tpu/utils/weights.py::
convert_unet_state_dict``: it takes the JAX UNet parameter tree (nested dicts
and lists of numpy arrays) and returns a diffusers-named state dict that
``SVDUNet.load_state_dict`` takes as it is. ``from_jax_vae_decoder_params``
is the inverse of ``convert_vae_decoder_state_dict`` and gives the
``decoder.*`` names that ``TemporalVAEDecoder.load_state_dict`` takes.
``from_jax_vae_encoder_params`` is the inverse of
``convert_vae_encoder_state_dict`` (``encoder.*`` names, for ``VAEEncoder``),
``from_jax_clip_params`` the inverse of ``convert_clip_state_dict``
(transformers ``CLIPVisionModelWithProjection`` names, for
``CLIPVisionEncoder``), ``from_jax_t5_params`` the inverse of
``convert_t5_encoder_state_dict`` (transformers ``T5EncoderModel`` names),
``from_jax_dit_params`` maps the DiT's tree onto ``DiTVideo``'s names,
which follow that tree, and ``from_jax_dummy_params`` the simulator's
``DummyUNet``. ``load_jax_npz`` reads the JAX package's own
``save_params`` files (``unet.npz``, ``clip.npz``, ``vae_encoder.npz``,
``vae_decoder.npz``, ``dit.npz``, ``t5.npz`` of a ``--checkpoint``
directory) with numpy alone.

``load_safetensors`` reads a ``.safetensors`` file with ``json`` and
``torch.frombuffer`` (no ``safetensors`` package), and
``load_svd_checkpoint`` loads a local diffusers SVD directory (``unet/``,
``vae/``, ``image_encoder/``) into the port's modules by name: their names
are the checkpoint's, so no layout changes. Layouts of the JAX trees go back
to PyTorch's:

* linear ``w (in, out)``           -> ``weight (out, in)``
* conv2d ``w (kh, kw, I, O)``      -> ``weight (O, I, kh, kw)``
* CLIP's patch embedding ``w (p * p * 3, D)``, a linear over patches
  flattened in (row, column, channel) order -> ``weight (D, 3, p, p)``
* temporal ``w (kd, 1, 1, I, O)``  -> ``weight (O, I, kd, 1, 1)``
* norm ``scale`` / ``bias``        -> ``weight`` / ``bias``
* ``mix_factor ()``                -> ``time_mixer.mix_factor (1,)``
"""

from __future__ import annotations

import glob
import json
import math
import os
import re
from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

_SEP = "//"  # the JAX package's flattened-key separator (utils/weights.py)
_BF16 = "__bf16__"  # its prefix for bf16 leaves, stored as uint16 views


def _t(a) -> torch.Tensor:
    """A contiguous CPU copy of ``a`` (a tensor or an array); bfloat16 arrays
    (numpy's extension type, which torch cannot read) go through fp32, which
    holds them exactly."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu").contiguous().clone()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(a)


def _listify(node):
    """``{'0': .., '1': ..}`` dicts back into lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(re.fullmatch(r"\d+", k) for k in node):
        idx = sorted(node, key=int)
        if [int(i) for i in idx] == list(range(len(idx))):
            return [node[i] for i in idx]
    return node


def load_jax_npz(path: str) -> dict:
    """A parameter tree saved by the JAX package's ``save_params``: flat
    ``"a//0//w"`` keys back into nested dicts and lists. Leaves are numpy
    arrays, and bf16 leaves (stored as ``__bf16__``-prefixed uint16 views)
    come back as bf16 CPU tensors, since numpy has no bf16 of its own."""
    root: dict = {}
    with np.load(path) as loaded:
        for key in loaded.files:
            arr = loaded[key]
            if key.startswith(_BF16):
                key = key[len(_BF16):]
                arr = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
            parts = key.split(_SEP)
            node = root
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = arr
    return _listify(root)


class _Out:
    def __init__(self):
        self.sd: dict[str, torch.Tensor] = {}

    def linear(self, prefix: str, p: Mapping) -> None:
        self.sd[prefix + ".weight"] = _t(p["w"]).T.contiguous()
        if "b" in p:
            self.sd[prefix + ".bias"] = _t(p["b"])

    def conv(self, prefix: str, p: Mapping) -> None:
        w = _t(p["w"])
        perm = (3, 2, 0, 1) if w.ndim == 4 else (4, 3, 0, 1, 2)  # HWIO / DHWIO -> OI...
        self.sd[prefix + ".weight"] = w.permute(perm).contiguous()
        self.sd[prefix + ".bias"] = _t(p["b"])

    def norm(self, prefix: str, p: Mapping) -> None:
        self.sd[prefix + ".weight"] = _t(p["scale"])
        self.sd[prefix + ".bias"] = _t(p["bias"])

    def mix(self, prefix: str, value) -> None:
        self.sd[prefix + ".time_mixer.mix_factor"] = _t(value).reshape(1)

    def attention(self, prefix: str, p: Mapping) -> None:
        for name in ("to_q", "to_k", "to_v"):
            self.linear(f"{prefix}.{name}", p[name])
        self.linear(prefix + ".to_out.0", p["to_out"])

    def ff(self, prefix: str, p: Mapping) -> None:
        self.linear(prefix + ".net.0.proj", p["proj_in"])
        self.linear(prefix + ".net.2", p["proj_out"])

    def mlp(self, prefix: str, p: Mapping) -> None:
        self.linear(prefix + ".linear_1", p["linear_1"])
        self.linear(prefix + ".linear_2", p["linear_2"])

    def resblock(self, prefix: str, p: Mapping) -> None:
        sp, tp = p["spatial"], p["temporal"]
        s = prefix + ".spatial_res_block"
        self.norm(s + ".norm1", sp["norm1"])
        self.conv(s + ".conv1", sp["conv1"])
        if "time_emb_proj" in sp:  # the UNet's; the VAE decoder's ResNets have none
            self.linear(s + ".time_emb_proj", sp["time_emb_proj"])
        self.norm(s + ".norm2", sp["norm2"])
        self.conv(s + ".conv2", sp["conv2"])
        if "conv_shortcut" in sp:
            self.conv(s + ".conv_shortcut", sp["conv_shortcut"])
        t = prefix + ".temporal_res_block"
        self.norm(t + ".norm1", tp["norm1"])
        self.conv(t + ".conv1", tp["conv1"])
        if "time_emb_proj" in tp:
            self.linear(t + ".time_emb_proj", tp["time_emb_proj"])
        self.norm(t + ".norm2", tp["norm2"])
        self.conv(t + ".conv2", tp["conv2"])
        self.mix(prefix, p["mix_factor"])

    def temporal_block(self, prefix: str, p: Mapping) -> None:
        for n in ("norm_in", "norm1", "norm2", "norm3"):
            self.norm(f"{prefix}.{n}", p[n])
        self.ff(prefix + ".ff_in", p["ff_in"])
        self.attention(prefix + ".attn1", p["attn1"])
        self.attention(prefix + ".attn2", p["attn2"])
        self.ff(prefix + ".ff", p["ff"])

    def transformer(self, prefix: str, p: Mapping) -> None:
        self.norm(prefix + ".norm", p["norm"])
        self.linear(prefix + ".proj_in", p["proj_in"])
        self.mlp(prefix + ".time_pos_embed", p["time_pos_embed"])
        for i, blk in enumerate(p["blocks"]):
            b = f"{prefix}.transformer_blocks.{i}"
            for n in ("norm1", "norm2", "norm3"):
                self.norm(f"{b}.{n}", blk[n])
            self.attention(b + ".attn1", blk["attn1"])
            self.attention(b + ".attn2", blk["attn2"])
            self.ff(b + ".ff", blk["ff"])
        for i, blk in enumerate(p["temporal_blocks"]):
            self.temporal_block(f"{prefix}.temporal_transformer_blocks.{i}", blk)
        self.mix(prefix, p["mix_factor"])
        self.linear(prefix + ".proj_out", p["proj_out"])


def from_jax_params(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``SVDUNet`` parameter tree (numpy leaves) -> diffusers-named state
    dict of CPU tensors in the leaves' dtypes."""
    out = _Out()
    out.conv("conv_in", params["conv_in"])
    out.mlp("time_embedding", params["time_embedding"])
    out.mlp("add_embedding", params["add_embedding"])
    for i, block in enumerate(params["down_blocks"]):
        base = f"down_blocks.{i}"
        for j, res in enumerate(block["resnets"]):
            out.resblock(f"{base}.resnets.{j}", res)
        # A block without attention holds an empty list, which a save_params
        # file does not keep.
        for j, att in enumerate(block.get("attentions", ())):
            out.transformer(f"{base}.attentions.{j}", att)
        if "downsample" in block:
            out.conv(f"{base}.downsamplers.0.conv", block["downsample"])
    mid = params["mid_block"]
    for j, res in enumerate(mid["resnets"]):
        out.resblock(f"mid_block.resnets.{j}", res)
    out.transformer("mid_block.attentions.0", mid["attentions"][0])
    for i, block in enumerate(params["up_blocks"]):
        base = f"up_blocks.{i}"
        for j, res in enumerate(block["resnets"]):
            out.resblock(f"{base}.resnets.{j}", res)
        for j, att in enumerate(block.get("attentions", ())):
            out.transformer(f"{base}.attentions.{j}", att)
        if "upsample" in block:
            out.conv(f"{base}.upsamplers.0.conv", block["upsample"])
    out.norm("conv_norm_out", params["conv_norm_out"])
    out.conv("conv_out", params["conv_out"])
    return out.sd


def from_jax_dummy_params(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``DummyUNet`` parameters -> the state dict that
    ``vdpp_tpu_torch.models.dummy_unet.DummyUNet.load_state_dict`` takes
    (both hold conv kernels as ``(O, I, kd, kh, kw)``)."""
    sd = {f"{name}.{leaf}": _t(params[name][key]) for name in ("conv1", "conv2")
          for leaf, key in (("weight", "w"), ("bias", "b"))}
    if "ln" in params:
        sd["ln.weight"], sd["ln.bias"] = _t(params["ln"]["w"]), _t(params["ln"]["b"])
    return sd


def from_jax_vae_decoder_params(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``TemporalVAEDecoder`` parameter tree (numpy leaves) -> the
    diffusers ``decoder.*`` state dict of CPU tensors in the leaves' dtypes."""
    out = _Out()
    out.conv("decoder.conv_in", params["conv_in"])
    mid = params["mid"]
    out.resblock("decoder.mid_block.resnets.0", mid["resnet1"])
    out.norm("decoder.mid_block.attentions.0.group_norm", mid["attn"]["norm"])
    out.attention("decoder.mid_block.attentions.0", mid["attn"]["attn"])
    out.resblock("decoder.mid_block.resnets.1", mid["resnet2"])
    for i, block in enumerate(params["up_blocks"]):
        base = f"decoder.up_blocks.{i}"
        for j, res in enumerate(block["resnets"]):
            out.resblock(f"{base}.resnets.{j}", res)
        if "upsample" in block:
            out.conv(f"{base}.upsamplers.0.conv", block["upsample"])
    out.norm("decoder.conv_norm_out", params["norm_out"])
    out.conv("decoder.conv_out", params["conv_out"])
    out.conv("decoder.time_conv_out", params["time_conv_out"])
    return out.sd


def from_jax_t5_params(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``T5TextEncoder`` parameter tree -> the transformers
    ``T5EncoderModel`` state dict that ``vdpp_tpu_torch.models.t5_encoder.
    T5TextEncoder.load_state_dict`` takes (gated or ReLU feed-forward, as the
    tree holds)."""
    out = _Out()
    out.sd["shared.weight"] = _t(params["embed"])
    out.sd["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = _t(
        params["rel_bias"])
    for i, blk in enumerate(params["blocks"]):
        a = f"encoder.block.{i}.layer.0"
        ff = f"encoder.block.{i}.layer.1"
        out.sd[a + ".layer_norm.weight"] = _t(blk["ln1"]["scale"])
        for name in ("q", "k", "v", "o"):
            out.linear(f"{a}.SelfAttention.{name}", blk[name])
        out.sd[ff + ".layer_norm.weight"] = _t(blk["ln2"]["scale"])
        if "wi0" in blk:
            out.linear(ff + ".DenseReluDense.wi_0", blk["wi0"])
            out.linear(ff + ".DenseReluDense.wi_1", blk["wi1"])
        else:
            out.linear(ff + ".DenseReluDense.wi", blk["wi"])
        out.linear(ff + ".DenseReluDense.wo", blk["wo"])
    out.sd["encoder.final_layer_norm.weight"] = _t(params["final_ln"]["scale"])
    return out.sd


def from_jax_dit_params(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``DiTVideo`` parameter tree -> the state dict that
    ``vdpp_tpu_torch.models.dit.DiTVideo.load_state_dict`` takes. A MoE
    block's gate is a linear; its expert stacks keep their ``(E, ...)``
    layout (``ops/moe.py``)."""
    out = _Out()
    out.linear("patch_embed", params["patch_embed"])
    out.mlp("t_embed", params["t_embed"])
    for i, blk in enumerate(params["blocks"]):
        b = f"blocks.{i}"
        for name in ("norm1", "norm2", "norm_cross"):
            if name in blk:
                out.norm(f"{b}.{name}", blk[name])
        out.attention(b + ".attn", blk["attn"])
        if "cross_attn" in blk:
            out.attention(b + ".cross_attn", blk["cross_attn"])
        if "moe" in blk:
            moe = blk["moe"]
            out.linear(b + ".moe.gate", moe["gate"])
            for name in ("w_in", "b_in", "w_out", "b_out"):
                out.sd[f"{b}.moe.{name}"] = _t(moe[name])
        for name in ("mlp_in", "mlp_out", "ada"):
            if name in blk:
                out.linear(f"{b}.{name}", blk[name])
    out.norm("final_norm", params["final_norm"])
    out.linear("final_ada", params["final_ada"])
    out.linear("final_proj", params["final_proj"])
    return out.sd


def _resnet2d(out: _Out, prefix: str, p: Mapping) -> None:
    """A plain 2-D ResNet (the KL encoder's; no time embedding)."""
    for n in ("norm1", "norm2"):
        out.norm(f"{prefix}.{n}", p[n])
    for n in ("conv1", "conv2", "conv_shortcut"):
        if n in p:
            out.conv(f"{prefix}.{n}", p[n])


def from_jax_vae_encoder_params(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``VAEEncoder`` parameter tree (numpy leaves) -> the diffusers
    ``encoder.*`` state dict that ``VAEEncoder.load_state_dict`` takes."""
    out = _Out()
    out.conv("encoder.conv_in", params["conv_in"])
    for i, block in enumerate(params["down_blocks"]):
        base = f"encoder.down_blocks.{i}"
        for j, res in enumerate(block["resnets"]):
            _resnet2d(out, f"{base}.resnets.{j}", res)
        if "downsample" in block:
            out.conv(f"{base}.downsamplers.0.conv", block["downsample"])
    mid = params["mid"]
    _resnet2d(out, "encoder.mid_block.resnets.0", mid["resnet1"])
    out.norm("encoder.mid_block.attentions.0.group_norm", mid["attn"]["norm"])
    out.attention("encoder.mid_block.attentions.0", mid["attn"]["attn"])
    _resnet2d(out, "encoder.mid_block.resnets.1", mid["resnet2"])
    out.norm("encoder.conv_norm_out", params["norm_out"])
    out.conv("encoder.conv_out", params["conv_out"])
    return out.sd


def from_jax_clip_params(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``CLIPVisionEncoder`` parameter tree (numpy leaves) -> the
    transformers ``CLIPVisionModelWithProjection`` state dict that
    ``CLIPVisionEncoder.load_state_dict`` takes."""
    out = _Out()
    vm = "vision_model."
    w = _t(params["patch_embed"]["w"])  # (p * p * 3, D), rows in (row, column, channel) order
    p = math.isqrt(w.shape[0] // 3)
    out.sd[vm + "embeddings.patch_embedding.weight"] = (
        w.reshape(p, p, 3, -1).permute(3, 2, 0, 1).contiguous())
    out.sd[vm + "embeddings.class_embedding"] = _t(params["class_embed"])
    out.sd[vm + "embeddings.position_embedding.weight"] = _t(params["pos_embed"])
    out.norm(vm + "pre_layrnorm", params["pre_ln"])
    for i, layer in enumerate(params["layers"]):
        base = f"{vm}encoder.layers.{i}"
        out.norm(base + ".layer_norm1", layer["ln1"])
        for ours, theirs in (("q_proj", "to_q"), ("k_proj", "to_k"), ("v_proj", "to_v"),
                             ("out_proj", "to_out")):
            out.linear(f"{base}.self_attn.{ours}", layer["attn"][theirs])
        out.norm(base + ".layer_norm2", layer["ln2"])
        out.linear(base + ".mlp.fc1", layer["mlp_in"])
        out.linear(base + ".mlp.fc2", layer["mlp_out"])
    out.norm(vm + "post_layernorm", params["post_ln"])
    out.linear("visual_projection", params["projection"])
    return out.sd


# The safetensors dtypes of SVD's checkpoints: weights in F32, F16 or BF16,
# and the I64 ``position_ids`` an HF CLIP checkpoint may carry.
_ST_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
              "I64": torch.int64}


def load_safetensors(path: str) -> dict[str, torch.Tensor]:
    """A ``.safetensors`` file as CPU tensors, read with ``json`` and
    ``torch.frombuffer``: an 8-byte little-endian header length, a JSON
    header of ``{name: {dtype, shape, data_offsets}}`` (offsets into the
    bytes after it), then the raw little-endian data. The tensors share one
    buffer holding the file."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    n = int.from_bytes(data[:8], "little")
    header = json.loads(data[8:8 + n])
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, not read")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = math.prod(shape)
        if end - begin != count * torch.empty((), dtype=dtype).element_size():
            raise ValueError(f"{path}: tensor {name!r} spans {end - begin} bytes, not its shape's")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        out[name] = torch.frombuffer(data, dtype=dtype, count=count,
                                     offset=base + begin).reshape(shape)
    return out


def _load_dir(model_dir: str, sub: str) -> dict[str, torch.Tensor]:
    """Every ``*.safetensors`` shard under ``model_dir/sub``, merged."""
    sd: dict[str, torch.Tensor] = {}
    for path in sorted(glob.glob(os.path.join(model_dir, sub, "*.safetensors"))):
        sd.update(load_safetensors(path))
    return sd


def _load_by_name(module: torch.nn.Module, sd: Mapping[str, torch.Tensor], what: str,
                  strict: bool) -> None:
    """``module.load_state_dict`` by name; every parameter must be in ``sd``
    with its shape. Other keys of ``sd`` are an error when ``strict``, and
    are passed over otherwise, as the JAX package's non-strict converters
    pass them over."""
    own = module.state_dict()
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    if missing or (strict and extra):
        raise KeyError(f"{what}: missing keys {missing[:10]}, unexpected keys {extra[:10]}")
    for k, v in own.items():
        if tuple(sd[k].shape) != tuple(v.shape):
            raise ValueError(f"{what}: {k} has shape {tuple(sd[k].shape)}, the model "
                             f"{tuple(v.shape)}")
    module.load_state_dict({k: sd[k] for k in own})


def load_svd_checkpoint(model_dir: str, *, unet_config=None, vae_config=None,
                        clip_config=None, device: str | torch.device | None = None,
                        parts=("unet", "vae_encoder", "vae_decoder", "clip"),
                        ) -> dict[str, torch.nn.Module]:
    """A local diffusers-layout SVD checkpoint (``unet/``, ``vae/``,
    ``image_encoder/`` with ``*.safetensors`` shards) loaded into the port's
    modules by name: ``{"unet": SVDUNet, "vae_encoder": VAEEncoder,
    "vae_decoder": TemporalVAEDecoder, "clip": CLIPVisionEncoder}`` for the
    folders present, in their configs' dtypes (defaults: SVD-XT, the SVD VAE
    in fp32, ViT-H/14). The counterpart of the JAX package's
    ``convert_svd_checkpoint``. The UNet's keys must be exactly the model's
    (1428 at SVD-XT), and so must the VAE's ``encoder.*`` and ``decoder.*``
    subtrees; the vision tower must hold all of its model's keys. Keys
    outside those (the VAE's ``quant_conv``, the tower's ``position_ids``)
    are passed over, as that converter passes them over. Only the modules
    named in ``parts`` are built and read."""
    from vdpp_tpu_torch.models.clip_encoder import CLIPVisionConfig, CLIPVisionEncoder
    from vdpp_tpu_torch.models.svd_unet import SVDUNet, SVDUNetConfig
    from vdpp_tpu_torch.models.vae import TemporalVAEDecoder, VAEConfig, VAEEncoder

    out: dict[str, torch.nn.Module] = {}
    sd = _load_dir(model_dir, "unet") if "unet" in parts else {}
    if sd:
        out["unet"] = SVDUNet(unet_config or SVDUNetConfig.svd_xt(), device=device)
        _load_by_name(out["unet"], sd, "unet", strict=True)
    vae_parts = [(name, cls, prefix) for name, cls, prefix in (
        ("vae_encoder", VAEEncoder, "encoder."), ("vae_decoder", TemporalVAEDecoder, "decoder."))
        if name in parts]
    sd = _load_dir(model_dir, "vae") if vae_parts else {}
    if sd:
        vae_config = vae_config or VAEConfig.svd()
        for name, cls, prefix in vae_parts:
            out[name] = cls(vae_config, device=device)
            _load_by_name(out[name], {k: v for k, v in sd.items() if k.startswith(prefix)},
                          name, strict=True)
    sd = _load_dir(model_dir, "image_encoder") if "clip" in parts else {}
    if sd:
        out["clip"] = CLIPVisionEncoder(clip_config or CLIPVisionConfig.vit_h_14(), device=device)
        _load_by_name(out["clip"], sd, "image_encoder", strict=False)
    return out
