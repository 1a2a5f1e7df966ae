"""Carry the JAX package's UNet and VAE-decoder parameters over to the port.

``from_jax_params`` is the inverse of ``vdpp_tpu/utils/weights.py::
convert_unet_state_dict``: it takes the JAX UNet parameter tree (nested dicts
and lists of numpy arrays) and returns a diffusers-named state dict that
``SVDUNet.load_state_dict`` takes as it is. ``from_jax_vae_decoder_params``
is the inverse of ``convert_vae_decoder_state_dict`` and gives the
``decoder.*`` names that ``TemporalVAEDecoder.load_state_dict`` takes.
Layouts go back to PyTorch's:

* linear ``w (in, out)``           -> ``weight (out, in)``
* conv2d ``w (kh, kw, I, O)``      -> ``weight (O, I, kh, kw)``
* temporal ``w (kd, 1, 1, I, O)``  -> ``weight (O, I, kd, 1, 1)``
* norm ``scale`` / ``bias``        -> ``weight`` / ``bias``
* ``mix_factor ()``                -> ``time_mixer.mix_factor (1,)``
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    """A contiguous CPU copy of ``a``; bfloat16 leaves (numpy's extension
    type, which torch cannot read) go through fp32, which holds them exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(a)


class _Out:
    def __init__(self):
        self.sd: dict[str, torch.Tensor] = {}

    def linear(self, prefix: str, p: Mapping) -> None:
        self.sd[prefix + ".weight"] = _t(np.asarray(p["w"]).T)
        if "b" in p:
            self.sd[prefix + ".bias"] = _t(p["b"])

    def conv(self, prefix: str, p: Mapping) -> None:
        w = np.asarray(p["w"])
        perm = (3, 2, 0, 1) if w.ndim == 4 else (4, 3, 0, 1, 2)  # HWIO / DHWIO -> OI...
        self.sd[prefix + ".weight"] = _t(w.transpose(perm))
        self.sd[prefix + ".bias"] = _t(p["b"])

    def norm(self, prefix: str, p: Mapping) -> None:
        self.sd[prefix + ".weight"] = _t(p["scale"])
        self.sd[prefix + ".bias"] = _t(p["bias"])

    def mix(self, prefix: str, value) -> None:
        self.sd[prefix + ".time_mixer.mix_factor"] = _t(np.asarray(value).reshape(1))

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
            b = f"{prefix}.temporal_transformer_blocks.{i}"
            for n in ("norm_in", "norm1", "norm2", "norm3"):
                self.norm(f"{b}.{n}", blk[n])
            self.ff(b + ".ff_in", blk["ff_in"])
            self.attention(b + ".attn1", blk["attn1"])
            self.attention(b + ".attn2", blk["attn2"])
            self.ff(b + ".ff", blk["ff"])
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
        for j, att in enumerate(block["attentions"]):
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
        for j, att in enumerate(block["attentions"]):
            out.transformer(f"{base}.attentions.{j}", att)
        if "upsample" in block:
            out.conv(f"{base}.upsamplers.0.conv", block["upsample"])
    out.norm("conv_norm_out", params["conv_norm_out"])
    out.conv("conv_out", params["conv_out"])
    return out.sd


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
