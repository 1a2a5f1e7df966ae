"""The port's reserved decode ranks and chunk-parallel VAE decode against the
JAX package, fp32 on the CPU: ``make_pipeline_and_decode_mesh`` (the
reference's ``make_pipeline_and_decode_meshes``), ``TemporalVAEDecoder.
decode_data_parallel`` over 2 and 3 ranks, and the image->video app's
overlapped decode (``--decode-devices 1``) and its decode over every stage
rank (``--num-stages 2``).

The tiny decoder holds the weights of ``tests/test_torch_port_vae.py``
(``random_state_dict`` through the JAX package's converter). Tolerances are
``tests/test_vae.py:80-105``'s: the chunk-parallel decode against JAX's
``decode_chunked`` within ``rtol = atol = 2e-5`` with full chunks and 1e-5
with a trailing partial one. Within the port it equals ``decode_chunked``
bit for bit (each chunk decoded alone at the same shape), and the app's
files are byte-equal across the decode layouts.

One fixture starts every spawned run at once: a 3-rank gloo group (a stage
rank and 2 decode ranks) for the decodes, and the app three times.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from vdpp_tpu.models.vae import TemporalVAEDecoder as JaxDecoder
from vdpp_tpu.models.vae import VAEConfig as JaxVAEConfig
from vdpp_tpu.parallel.mesh import make_pipeline_and_decode_meshes
from vdpp_tpu.utils.weights import convert_vae_decoder_state_dict

from vdpp_tpu_torch.apps import generate_video
from vdpp_tpu_torch.models.vae import TemporalVAEDecoder, VAEConfig
from vdpp_tpu_torch.parallel.mesh import Stage, make_pipeline_and_decode_mesh, run_stages
from vdpp_tpu_torch.utils.weights import from_jax_vae_decoder_params

import torch_port_helpers as helpers
from torch_port_helpers import one_torch_thread  # noqa: F401

LATENT = (1, 6, 8, 8, 4)
# name: (chunk frames, the ranks that decode: "decode" (2) or "all" (3))
DECODES = {"decode2_full_chunks": (2, "decode"), "decode2_partial_chunk": (4, "decode"),
           "all3_full_chunks": (2, "all"), "all3_partial_chunk": (4, "all")}
APP = ["--random-weights", "--preset", "tiny", "--device", "cpu", "--width", "64", "--height",
       "64", "--num-frames", "5", "--decode-chunk-frames", "2", "--steps", "2",
       "--num-samples", "2"]
APP_RUNS = {"one": ["--num-stages", "1"],
            "decode1": ["--num-stages", "1", "--decode-devices", "1"],
            "stages2": ["--num-stages", "2"]}


def _weights():
    """``(JAX params, the port's decoder holding them)``."""
    dec = TemporalVAEDecoder(VAEConfig.tiny(), device="cpu")
    sd = helpers.random_state_dict(dec, 0)
    params = jax.tree_util.tree_map(
        np.asarray, convert_vae_decoder_state_dict(sd, num_levels=2, layers_per_block=1))
    dec.load_state_dict(from_jax_vae_decoder_params(params))
    return params, dec


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    params, dec = _weights()
    lat = np.random.default_rng(7).standard_normal(LATENT).astype(np.float32)
    cases = [(name, torch.from_numpy(lat), chunk, over)
             for name, (chunk, over) in DECODES.items()]
    out = tmp_path_factory.mktemp("app")
    mesh = make_pipeline_and_decode_mesh(1, 2, device="cpu")
    with ThreadPoolExecutor(4) as pool:
        spawned = pool.submit(run_stages, mesh, helpers.decode_cases, dec.state_dict(), cases,
                              threads=1, timeout=600)
        apps = {k: pool.submit(generate_video.main, APP + extra + ["--output-dir", str(out / k)])
                for k, extra in APP_RUNS.items()}
        jdec = JaxDecoder(JaxVAEConfig.tiny())
        jdec.apply = jax.jit(jdec.apply)
        want = {c: np.asarray(jdec.decode_chunked(params, lat, chunk_frames=c)) for c in (2, 4)}
        ranks = spawned.result()
        rcs = {k: f.result() for k, f in apps.items()}
    with torch.inference_mode():
        own = {c: dec.decode_chunked(torch.from_numpy(lat), chunk_frames=c) for c in (2, 4)}
    return {"ranks": ranks, "want": want, "own": own, "apps": rcs, "out": out}


@pytest.mark.parametrize("name", list(DECODES))
def test_decode_data_parallel_matches_jax_decode_chunked(runs, name):
    """6 frames in chunks of 2 (three full chunks) and of 4 (a full chunk and
    a trailing partial one of 2 frames, decoded at its true length), split
    over the 2 decode ranks or all 3 ranks, gathered to the group's first
    rank: JAX's ``decode_chunked`` within the reference's tolerance, and the
    port's own bit for bit."""
    chunk, over = DECODES[name]
    root = 1 if over == "decode" else 0  # the decode ranks are 1 and 2
    got = runs["ranks"][root][name]
    assert all(r[name] is None for i, r in enumerate(runs["ranks"]) if i != root)
    tol = 2e-5 if LATENT[1] % chunk == 0 else 1e-5
    np.testing.assert_allclose(got.numpy(), runs["want"][chunk], rtol=tol, atol=tol)
    assert torch.equal(got, runs["own"][chunk])


def _view(mesh, rank: int) -> Stage:
    """A Stage's rank properties without its process groups."""
    stage = Stage.__new__(Stage)
    stage.mesh, stage.rank = mesh, rank
    return stage


def test_decode_mesh_sizes_and_oversubscription():
    """The stage and decode ranks drawn from one device list, as the
    reference's (``tests/test_pipeline.py:214-225``, ``tests/
    test_frame_parallel.py:312-316``): auto-sized stages after the
    reservation, disjoint ranks, and ValueError when oversubscribed."""
    eight = ["cpu"] * 8
    mesh = make_pipeline_and_decode_mesh(None, 2, devices=eight)
    jstage, jdecode = make_pipeline_and_decode_meshes(None, 2)
    assert (mesh.num_stages, mesh.decode) == (6, 2)
    assert (jstage.shape["stage"], jdecode.shape["data"]) == (6, 2)
    assert (mesh.stage_ranks, mesh.world_size) == (6, 8)
    stage, decode = _view(mesh, 5), _view(mesh, 6)
    assert not stage.is_decode and stage.is_last_rank and stage.is_decode_sender
    assert decode.is_decode and not decode.is_last_rank
    mesh2 = make_pipeline_and_decode_mesh(4, 0, devices=eight)
    jmesh2, none = make_pipeline_and_decode_meshes(4, 0)
    assert none is None and mesh2.decode == 0
    assert mesh2.num_stages == jmesh2.shape["stage"] == 4 and mesh2.world_size == 4
    seq = make_pipeline_and_decode_mesh(None, 1, devices=eight, seq=2)
    assert (seq.num_stages, seq.seq, seq.decode, seq.world_size) == (3, 2, 1, 7)
    with pytest.raises(ValueError, match="devices"):
        make_pipeline_and_decode_meshes(8, 1)
    with pytest.raises(ValueError, match="devices"):
        make_pipeline_and_decode_mesh(8, 1, devices=eight)
    with pytest.raises(ValueError, match="exceeds"):
        make_pipeline_and_decode_meshes(None, 0, frame=16)
    with pytest.raises(ValueError, match="exceeds"):
        make_pipeline_and_decode_mesh(None, 0, devices=eight, frame=16)


def test_app_decode_layouts_write_byte_equal_files(runs):
    """``apps.generate_video.main``, 2 samples of 5 frames decoded in chunks
    of 2: with a decode rank beside the stage rank (``--decode-devices 1``,
    each sample handed over as it finishes and decoded there) and over 2
    stage ranks with the decode split between them, the MP4 (or its
    stand-in), Y4M and GIF files are those of the one-rank run, byte for
    byte."""
    assert runs["apps"] == dict.fromkeys(APP_RUNS, 0)

    def files(run):
        # name: ..._st{stages}_fps7_seed{seed}.ext; the seed tells the samples apart
        return {p.name.split("_seed")[1]: p.read_bytes() for p in (runs["out"] / run).iterdir()}

    one = files("one")
    assert len(one) == 6 and {k.split(".")[1] for k in one} == {"mp4", "y4m", "gif"}
    assert files("decode1") == one
    assert files("stages2") == one
