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
from vdpp_tpu_torch.models.svd_unet import SVDUNet, SVDUNetConfig
from vdpp_tpu_torch.models.svd_wrapper import StableVideoUNet
from vdpp_tpu_torch.utils.device import resolve_device

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
    ``jax`` and ``vdpp_tpu`` unloaded."""
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts) for p in PORT_FILES[:-1]]
    mods = [m.removesuffix(".__init__") for m in mods]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'vdpp_tpu'))\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StableVideoUNet(SVDUNetConfig.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SVDUNet(SVDUNetConfig.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--preset", "tiny"])
    assert resolve_device("cpu").type == "cpu"


def test_bench_tiny_on_cpu(capsys):
    assert bench.main(["--preset", "tiny", "--device", "cpu", "--steps", "2", "--videos", "1",
                       "--warmup", "0"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["unit"] == "s/video" and line["value"] > 0
    assert line["metric"].startswith("sec/video single cpu SVD 3f 16x16")
