"""Helpers shared by the port's parity tests (``tests/test_torch_port_*.py``)."""

import numpy as np
import pytest
import torch


def random_state_dict(module: torch.nn.Module, seed: int,
                      mix_base: float = 0.0) -> dict[str, np.ndarray]:
    """Checkpoint-named weights for ``module`` from a numpy seed: matrices and
    kernels LeCun-normal over their fan-in, norm scales (1-D ``.weight``)
    near 1, biases and embeddings near 0, mix factors near ``mix_base``. Off
    the values an init gives, so a misplaced one shows."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, p in module.state_dict().items():
        noise = rng.standard_normal(tuple(p.shape)).astype(np.float32)
        if p.ndim >= 2:
            sd[name] = noise / np.sqrt(p[0].numel())
        else:
            base = mix_base if name.endswith("mix_factor") else float(name.endswith(".weight"))
            sd[name] = (base + 0.1 * noise).astype(np.float32)
    return sd


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module's tests: their CPU tensors are
    small, and beside the suite's other parallel workers more threads only
    spin (measured here: 4x the CPU seconds for the same tests)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
