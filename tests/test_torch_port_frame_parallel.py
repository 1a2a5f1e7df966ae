"""The port's frame parallelism for the SVD UNet against the JAX package,
fp32 on the CPU: ``conv_temporal_halo`` at 2 and 4 shards and
``temporal_self_attention`` over frame shards against the JAX package's
unsharded ops, both refusals of the halo conv, and the tiny model under
frame 2, stage 2 x frame 2 and seq 2 x frame 2 against JAX's single-device
oracle (``torch_port_intra.jax_oracle``).

Tolerance: ``rtol = atol = 2e-5`` for the model, the JAX package's own
(``tests/test_frame_parallel.py:150``); the ops 1e-5 absolute. Within the
port, stage 2 x frame 2 equals frame 2 at one stage bit for bit.

Under a frame axis ``VDPP_TEMPORAL_ATTN=pallas`` takes the default form, as
the reference routes it (the frame-attention kernel attends square): the
op case asks for it and counts the one call that fell back.

One fixture spawns a 2-rank and a 4-rank gloo group at once, each laid out
in turn as its cases need; JAX's oracle runs meanwhile in this thread.
"""

import functools
import importlib
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdpp_tpu.ops import conv as jconv
from vdpp_tpu.utils.weights import _conv_attention

from vdpp_tpu_torch.ops import conv as tconv
from vdpp_tpu_torch.ops.attention import Attention
from vdpp_tpu_torch.parallel.collectives import Axis

import torch_port_intra as intra
from torch_port_helpers import one_torch_thread  # noqa: F401

# vdpp_tpu.ops re-exports a function named like the module
jattn = importlib.import_module("vdpp_tpu.ops.attention")

OP_ATOL = 1e-5


def _conv3d(sd, pf):
    return sd.conv3d(pf)


def _ops():
    """``{name: (world, layout, args, JAX reference thunk)}`` of the op
    cases."""
    x = intra.x_of(1, 2, 4, 3, 5, 6)  # (B, F, H, W, C)
    state, p = intra.op_weights(tconv.ConvTemporal(6, 5), 2, _conv3d)
    want = functools.partial(jconv.conv_temporal, jnp.asarray(x), p)
    cases = {f"conv_temporal_halo_{n}": (n, {"frame": n}, ("conv_temporal_halo",
                                                           torch.from_numpy(x), state,
                                                           {"out": 5}), want)
             for n in (2, 4)}
    b, f, l, c, heads = 2, 4, 6, 16, 2
    xa = intra.x_of(3, b * f, l, c)
    state, p = intra.op_weights(Attention(c), 4, _conv_attention)
    kw = {"heads": heads, "batch": b, "frames": f, "env": {"VDPP_TEMPORAL_ATTN": "pallas"}}
    cases["temporal_self_attention"] = (
        2, {"frame": 2}, ("temporal_self_attention", torch.from_numpy(xa), state, kw),
        functools.partial(jattn.temporal_self_attention, p, jnp.asarray(xa), heads, b, f))
    return cases


# name: (world, layout, samples)
MODELS = {"frame2": (2, {"frame": 2}, 2), "stage2_frame2": (4, {"frame": 2}, 2),
          "seq2_frame2": (4, {"seq": 2, "frame": 2}, 1)}


@pytest.fixture(scope="module")
def runs():
    ops = _ops()
    groups = {2: [], 4: []}
    for name, (world, layout, args, _) in ops.items():
        groups[world].append((name, layout, "op", args))
    build, inputs = intra.port_case()
    for name, (world, layout, n) in MODELS.items():
        groups[world].append((name, layout, "pipeline", (build, inputs[:n], intra.STEPS)))
    with ThreadPoolExecutor(2) as pool:
        spawned = {w: pool.submit(intra.spawn, w, c) for w, c in groups.items()}
        refs = {name: np.asarray(ref()) for name, (*_, ref) in ops.items()}
        oracle = intra.jax_oracle()
        results = {**spawned[2].result(), **spawned[4].result()}
    return {"results": results, "ops": refs, "oracle": oracle}


@pytest.mark.parametrize("shards", [2, 4])
def test_conv_temporal_halo_matches_jax_unsharded(runs, shards):
    """One edge frame exchanged each way, zeros at the chain's ends: the
    unsharded SAME conv, down to one frame a shard."""
    name = f"conv_temporal_halo_{shards}"
    got, want = runs["results"][name], runs["ops"][name]
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=OP_ATOL, rtol=0)


def test_temporal_attention_over_frame_shards(runs):
    """Local frames attend over the frames gathered from every shard; asked
    for the frame-attention kernel, the call takes the default form and is
    counted (the reference's routing)."""
    (got, fallbacks), want = (runs["results"]["temporal_self_attention"],
                              runs["ops"]["temporal_self_attention"])
    np.testing.assert_allclose(got.numpy(), want, atol=OP_ATOL, rtol=0)
    assert fallbacks == 1


@pytest.mark.parametrize("kernel,frames,match", [(2, 4, "odd kernel"),
                                                 (5, 1, "smaller than the kernel halo")])
def test_conv_temporal_halo_refusals_match_jax(kernel, frames, match):
    """An even kernel, and a local shard shorter than the halo (one frame
    against a 5-frame kernel's 2), refused by both packages before any
    exchange."""
    x = intra.x_of(5, 1, frames, 2, 2, 3)
    conv = tconv.ConvTemporal(3, 3, kernel)
    state, p = intra.op_weights(conv, 6, _conv3d)
    conv.load_state_dict(state)
    with pytest.raises(ValueError, match=match):
        jconv.conv_temporal_halo(jnp.asarray(x), p, "frame")
    with pytest.raises(ValueError, match=match):
        tconv.conv_temporal_halo(torch.from_numpy(x), conv,
                                 Axis("frame", 2, 0, (0, 1), group=None))


@pytest.mark.parametrize("name", list(MODELS))
def test_frame_parallel_matches_jax_oracle(runs, name):
    """4 Euler steps with CFG, each forward's frames split over the frame
    ranks of each stage (and its W over seq ranks in seq2_frame2: the
    temporal GroupNorm statistics averaged over both axes), against the JAX
    single-device oracle."""
    got, counts = runs["results"][name]
    intra.assert_oracle(got, runs["oracle"][:len(got)])
    assert counts["halo"] and counts["all_gather"] and counts["mean"]


def test_stage_split_is_bit_equal_to_one_stage(runs):
    res = runs["results"]
    assert torch.equal(res["stage2_frame2"][0], res["frame2"][0])
