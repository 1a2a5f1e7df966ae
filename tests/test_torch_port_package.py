"""Rules the port's package keeps: it imports neither JAX nor the JAX
package, its entry points refuse to run on the CPU unless asked, and the
benchmark entry point runs end to end at the tiny preset on the CPU."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from vdpp_tpu_torch import bench
from vdpp_tpu_torch.models.clip_encoder import CLIPVisionConfig, CLIPVisionEncoder
from vdpp_tpu_torch.models.dummy_unet import DummyUNet
from vdpp_tpu_torch.models.svd_unet import SVDUNet, SVDUNetConfig
from vdpp_tpu_torch.models.svd_wrapper import StableVideoUNet
from vdpp_tpu_torch.models.vae import VAEConfig, VAEEncoder
from vdpp_tpu_torch.modes import benchmark, benchmark_data_parallel, simulator
from vdpp_tpu_torch.parallel.mesh import make_2d_mesh, make_data_mesh, make_pipeline_mesh
from vdpp_tpu_torch.utils.device import resolve_device

from torch_port_helpers import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "vdpp_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|vdpp_tpu)(\.|\s|,|$)"
    r"|import_module\(\s*['\"](jax|vdpp_tpu)['\".]",
    re.MULTILINE,
)


def test_port_sources_import_no_jax():
    assert len(PORT_FILES) > 10
    hits = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
            for p in PORT_FILES for m in FORBIDDEN.finditer(p.read_text())]
    assert not hits, hits


def test_port_modules_load_without_jax():
    """Importing every module of the port in a fresh interpreter leaves
    ``jax`` and ``vdpp_tpu`` unloaded, and also ``PIL`` and ``safetensors``,
    which the card's machine lacks (the image->video app imports Pillow only
    to read an ``--image`` file)."""
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts) for p in PORT_FILES[:-1]]
    mods = [m.removesuffix(".__init__") for m in mods]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'vdpp_tpu', 'PIL', 'safetensors'))\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StableVideoUNet(SVDUNetConfig.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SVDUNet(SVDUNetConfig.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--preset", "tiny"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CLIPVisionEncoder(CLIPVisionConfig.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VAEEncoder(VAEConfig.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DummyUNet()
    # The step pipeline's stages go on the cards unless the CPU is asked for.
    for kw in ({}, {"num_stages": 2}, {"devices": ["cuda:0", "cuda:0"]}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_pipeline_mesh(**kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulator.main(["--num-stages", "2"])
    # The benchmark modes and their meshes.
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_data_mesh(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_2d_mesh(2, 2)
    for mode_flags in ([], ["--fused"], ["--fsdp"],
                       ["--data-parallel-size", "2", "--num-samples", "3"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            benchmark.main(["--num-stages", "2", *mode_flags])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchmark_data_parallel.main(["--num-devices", "2"])
    # The apps built on the image->video app's pieces.
    from vdpp_tpu_torch.apps import generate_video_long, restyle_video

    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate_video_long.main(["--random-weights", "--preset", "tiny"])
    y4m = Path(tmp_path) / "in.y4m"
    y4m.write_bytes(b"YUV4MPEG2 W4 H4 F7:1 C420jpeg\nFRAME\n" + bytes(24))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        restyle_video.main(["--input", str(y4m), "--random-weights", "--preset", "tiny"])
    assert make_pipeline_mesh(2, device="cpu").backend == "gloo"
    assert resolve_device("cpu").type == "cpu"


def test_bench_tiny_on_cpu(capsys):
    assert bench.main(["--preset", "tiny", "--device", "cpu", "--steps", "2", "--videos", "1",
                       "--warmup", "0"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["unit"] == "s/video" and line["value"] > 0
    assert line["metric"].startswith("sec/video single cpu SVD 3f 16x16")


def test_production_and_resume_keep_the_rules(monkeypatch):
    """``modes/production.py`` and ``utils/resume.py`` import neither JAX nor
    the JAX package; production's ``--device`` defaults to ``cuda`` and,
    with no card, it raises before anything runs."""
    from vdpp_tpu_torch.modes import production
    from vdpp_tpu_torch.utils import resume

    for mod in (production, resume):
        path = Path(mod.__file__)
        assert path in PORT_FILES and not FORBIDDEN.search(path.read_text())
    assert production.build_parser().parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--preset", "tiny", "--num-stages", "2", "--total-steps", "4"],
                 ["--devices", "cuda:0", "cuda:0", "--total-steps", "4"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            production.main(argv)
