"""Simulator mode: checks the step pipeline's logic with the DummyUNet.

    python -m vdpp_tpu_torch.modes.simulator --device cpu --num-stages 4 --total-steps 28

Port of ``vdpp_tpu/modes/simulator.py``, in the original system's shape: one
process per stage (gloo on the CPU, NCCL with a card per stage), the
DummyUNet through the step pipeline, the final latent norms logged. The
invariant is that the result does not depend on the stage count, so the
single-device run of every step is made too, here in this process on the
first stage's device, and the two must be equal bit for bit (the same
PyTorch ops on the same device type and thread count): a mismatch exits 1.
"""

from __future__ import annotations

import argparse
import logging
import sys

import torch

from vdpp_tpu_torch.models.dummy_unet import DummyUNet
from vdpp_tpu_torch.parallel.mesh import Stage, make_pipeline_mesh, run_stages
from vdpp_tpu_torch.parallel.pipeline import (
    PipelineConfig,
    StepPipeline,
    run_reference_single_device,
)

LOGGER = logging.getLogger("vdpp_torch.simulator")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--num-stages", "--world-size", dest="num_stages", type=int, default=None,
                   help="pipeline stages (default: every card; 1 on the CPU)")
    p.add_argument("--total-steps", type=int, default=28)
    p.add_argument("--num-samples", type=int, default=1)
    p.add_argument("--channels", type=int, default=8)
    p.add_argument("--hidden-channels", type=int, default=16)
    p.add_argument("--no-layernorm", action="store_true")
    p.add_argument("--latent-shape", type=int, nargs=5, default=[1, 8, 4, 16, 16],
                   metavar=("B", "C", "F", "H", "W"),
                   help="latent shape in the reference's (B,C,F,H,W) order")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--skip-oracle", action="store_true",
                   help="skip the single-device equality check")
    p.add_argument("--log-level", default="INFO")
    return p


def dummy_step(model: DummyUNet, x: torch.Tensor, step: int) -> torch.Tensor:
    """The simulator's model call."""
    return model(x, step)


def _model(model_kw: dict, state: dict, device) -> DummyUNet:
    model = DummyUNet(**model_kw, device=device)
    model.load_state_dict(state)
    return model


def _stage_run(stage: Stage, model_kw: dict, state: dict, inputs: torch.Tensor, total: int,
               step) -> torch.Tensor | None:
    """One rank: the DummyUNet through the pipeline. The reference simulator
    feeds descending timesteps [T-1 .. 0] to the model, so the pipeline's
    step k is the model's step T-1-k."""
    model = _model(model_kw, state, stage.device)
    pipe = StepPipeline(stage, lambda p, x, k: step(p, x, total - 1 - k),
                        PipelineConfig(total, stage.num_stages))
    out = pipe.run(model, inputs)
    return None if out is None else out.cpu()


def main(argv: list[str] | None = None, step=dummy_step) -> int:
    """``step(model, x, timestep)`` is the model call of every stage and of
    the single-device run (a module-level function: the stages import it)."""
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=getattr(logging, args.log_level.upper(), logging.INFO),
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    b, c, f, h, w = args.latent_shape
    if c != args.channels:
        LOGGER.warning("latent channels %d != --channels %d; using latent's", c, args.channels)
    mesh = make_pipeline_mesh(args.num_stages, device=args.device)
    stages, total = mesh.num_stages, args.total_steps
    PipelineConfig(total, stages)  # a bad split fails here, before any rank starts
    LOGGER.info("simulator: %d stages (%s), %d steps (%d per stage), latent (B,C,F,H,W)=%s",
                stages, mesh.backend, total, total // stages, tuple(args.latent_shape))

    model_kw = dict(channels=c, hidden_channels=args.hidden_channels,
                    use_layernorm=not args.no_layernorm)
    gen = torch.Generator().manual_seed(args.seed)
    state = DummyUNet(**model_kw, device="cpu").init_weights(gen).state_dict()
    inputs = torch.randn(args.num_samples, b, c, f, h, w,
                         generator=torch.Generator().manual_seed(args.seed + 1))

    out = run_stages(mesh, _stage_run, model_kw, state, inputs, total, step)[-1]
    for i in range(args.num_samples):
        LOGGER.info("sample %d final latent norm: %.2f", i, float(torch.linalg.norm(out[i])))
    if args.skip_oracle:
        return 0
    dev = mesh.devices[0]
    ref = run_reference_single_device(lambda p, x, k: step(p, x, total - 1 - k),
                                      _model(model_kw, state, dev), inputs.to(dev), total).cpu()
    LOGGER.info("max |pipelined - single-device| = %.3e", float((out - ref).abs().max()))
    if not torch.equal(out, ref):
        LOGGER.error("MISMATCH: pipeline is not stage-count invariant")
        return 1
    LOGGER.info("stage-count invariance verified (%d stages)", stages)
    return 0


if __name__ == "__main__":
    sys.exit(main())
