"""The port's topology planner (``vdpp_tpu_torch/parallel/topology.py``) and
production's ``--auto-topology`` against the JAX package's, on the CPU.

* ``plan_topology`` gives the same plans, in the same order, with equal
  fields (and ``describe`` texts), over a grid of device counts, objectives,
  guidance, DeepCache, frames, widths, stream lengths and step counts (the
  cases of ``tests/test_topology.py``);
* ``count_unet_comm_sites`` of the port's UNet (its modules, or its state
  dict's names) equals the JAX package's of its parameter tree, at ``tiny``
  and at ``svd_xt`` (built on the meta device and through ``jax.eval_shape``);
* the census holds against the port's measured collectives
  (``collectives.counts``) in one tiny step at seq 2, at frame 2 and at cfg
  2, with the unit mapping of the module's docstring: ``collective_permute``
  = 2 x ``halo`` + ``swap``, ``all_gather`` = ``all_gather``, ``all_reduce`` =
  ``mean``;
* ``modes.production.main --devices cpu cpu --auto-topology latency`` runs
  the JAX planner's top plan for 2 devices, and its samples equal the run
  with that plan's flags given explicitly, bit for bit.
"""

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from vdpp_tpu.models.svd_unet import SVDUNet as JaxUNet
from vdpp_tpu.models.svd_unet import SVDUNetConfig as JaxConfig
from vdpp_tpu.parallel import topology as jtopo

from vdpp_tpu_torch.models.svd_unet import SVDUNet, SVDUNetConfig
from vdpp_tpu_torch.models.svd_wrapper import make_conditioning
from vdpp_tpu_torch.modes import production
from vdpp_tpu_torch.parallel import topology as ttopo
from vdpp_tpu_torch.parallel.mesh import make_pipeline_mesh, run_stages

import torch_port_helpers as helpers
import torch_port_intra as intra
from torch_port_helpers import one_torch_thread  # noqa: F401

# (frames, latent width, unit) of svd-xt's flagship, a 14-frame clip at a
# width 8 x 9 (seq 1, 3, 9 only) and a prime frame count, and the tiny UNet's.
SHAPES = ((25, 128, 8), (14, 128, 8), (7, 72, 8), (4, 16, 2))
PROD = ["--device", "cpu", "--devices", "cpu", "cpu", "--preset", "tiny", "--total-steps", "2",
        "--num-samples", "1", "--latent-shape", "1", "4", "4", "16", "16",
        "--guidance-scale", "3"]


def _plans(mod, n: int, **kw) -> list[dict]:
    out = []
    for p in mod.plan_topology(n, **kw):
        d = dataclasses.asdict(p)
        d["describe"], d["axes"] = p.describe(), p.axes
        out.append(d)
    return out


@pytest.mark.parametrize("n_devices", range(1, 9))
def test_plan_topology_matches_jax(n_devices):
    """Every plan, in order, field for field, over both objectives, guidance
    on and off, DeepCache 0 and 2, padding allowed or not, intra-sample axes
    allowed or not, and stream lengths 1, 16 and 1000."""
    cases = 0
    for frames, width, unit in SHAPES:
        for steps in (30, 25, 4):
            for objective in ("latency", "throughput"):
                for guidance in (True, False):
                    for deepcache in (0, 2):
                        for samples in (1, 16, 1000):
                            for pad, intra_ok in ((True, True), (False, True), (True, False)):
                                kw = dict(total_steps=steps, frames=frames, latent_w=width,
                                          num_samples=samples, seq_min_divisor_unit=unit,
                                          guidance=guidance, objective=objective,
                                          deepcache_interval=deepcache, allow_pad_steps=pad,
                                          allow_intra_sample=intra_ok)
                                want = _plans(jtopo, n_devices, **kw)
                                assert want and _plans(ttopo, n_devices, **kw) == want, kw
                                cases += 1
    assert cases == len(SHAPES) * 3 * 2 * 2 * 2 * 3 * 3
    with pytest.raises(ValueError, match="objective"):
        ttopo.plan_topology(n_devices, total_steps=4, frames=1, latent_w=8, objective="both")


@functools.cache
def _jax_sites(name: str) -> dict:
    params = jax.eval_shape(JaxUNet(getattr(JaxConfig, name)()).init, jax.random.key(0))
    return jtopo.count_unet_comm_sites(params)


@pytest.mark.parametrize("name", ["tiny", "svd_xt"])
def test_count_unet_comm_sites_matches_jax(name):
    """The port's UNet on the meta device, by its modules and by its state
    dict's names, against the JAX parameter tree's shapes."""
    unet = SVDUNet(getattr(SVDUNetConfig, name)(), device="meta")
    want = _jax_sites(name)
    assert ttopo.count_unet_comm_sites(unet) == want
    assert ttopo.count_unet_comm_sites(unet.state_dict()) == want
    for kw in (dict(seq=True), dict(frame=True), dict(cfg_parallel=True),
               dict(seq=True, frame=True, cfg_parallel=True), dict(seq=True, guidance=False)):
        assert dataclasses.astuple(ttopo.svd_step_comm_census(want, **kw)) == (
            dataclasses.astuple(jtopo.svd_step_comm_census(want, **kw)))


# name: (layout, guidance): one Euler step of the tiny UNet; seq and frame
# without guidance (one forward), cfg with it (one forward a rank).
CENSUS = {"seq2": ({"seq": 2}, None), "frame2": ({"frame": 2}, None), "cfg2": ({"cfg": 2}, 3.0)}


def _census_cases() -> list:
    _, state, emb, img, noise = intra.draws()
    cases = []
    for name, (layout, guidance) in CENSUS.items():
        cond = make_conditioning(torch.from_numpy(emb), torch.from_numpy(img), intra.F,
                                 guidance_scale=guidance)
        build = functools.partial(helpers.svd_build, SVDUNetConfig.tiny(), "euler", 1, None,
                                  state, cond)
        cases.append((name, layout, "pipeline", (build, torch.from_numpy(noise[:1]), 1)))
    return cases


def _production(extra: list[str]) -> tuple:
    args = production.build_parser().parse_args(PROD + extra)
    out = production.run(args)["out"]
    return out, (args.num_stages, args.seq_parallel, args.frame_parallel, args.cfg_parallel,
                 args.pad_schedule)


@pytest.fixture(scope="module")
def runs():
    mesh = make_pipeline_mesh(2, device="cpu")
    with ThreadPoolExecutor(3) as pool:
        census = pool.submit(run_stages, mesh, helpers.intra_cases, _census_cases(), threads=1,
                             timeout=600)
        auto = pool.submit(_production, ["--auto-topology", "latency"])
        explicit = pool.submit(_production, ["--num-stages", "1", "--cfg-parallel"])
        return {"census": census.result()[-1], "auto": auto.result(),
                "explicit": explicit.result()}


@pytest.mark.parametrize("name", list(CENSUS))
def test_census_matches_the_measured_collectives(runs, name):
    """One step of the tiny UNet (4 frames of 8x16, 2 levels: 8 st-resblocks,
    4 st-transformers, 4 halo convs) on 2 gloo ranks: the census the planner
    ranks by, in StableHLO ops, against the port's calls."""
    layout, guidance = CENSUS[name]
    _, counts = runs["census"][name]
    census = jtopo.svd_step_comm_census(
        _jax_sites("tiny"), seq="seq" in layout, frame="frame" in layout,
        cfg_parallel="cfg" in layout, guidance=guidance is not None)
    assert census.collective_permute == 2 * counts.get("halo", 0) + counts.get("swap", 0)
    assert census.all_gather == counts.get("all_gather", 0)
    assert census.all_reduce == counts.get("mean", 0)
    assert set(counts) <= {"halo", "swap", "all_gather", "mean"} and sum(counts.values())


def test_production_auto_topology_runs_the_jax_top_plan(runs):
    """``--auto-topology latency`` on 2 devices, the tiny UNet at 4 frames of
    16x16, CFG 3: the JAX planner's top plan (cfg 2 here: removing
    sequential CFG's second forward beats seq 2 and frame 2), applied; the
    samples bit-equal to the explicit ``--num-stages 1 --cfg-parallel``
    run's."""
    best = jtopo.plan_topology(2, total_steps=2, frames=4, latent_w=16, num_samples=1,
                               seq_min_divisor_unit=SVDUNetConfig.tiny().seq_min_divisor(1),
                               guidance=True, objective="latency")[0]
    out, flags = runs["auto"]
    assert flags == (best.stage, best.seq, best.frame, best.cfg == 2, False)
    assert (best.stage, best.cfg) == (1, 2)
    want, _ = runs["explicit"]
    assert out.shape == (1, 1, 4, 16, 16, 4) and torch.isfinite(out).all()
    assert torch.equal(out, want)
    assert np.isfinite(out.numpy()).all()
