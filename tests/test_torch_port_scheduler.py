"""The port's schedule, Euler update and step assignment against the JAX
package. Tables are compared exactly (bit for bit); the fp32 Euler update
within 1e-6 relative (scalar rsqrt/log may differ by an ulp between the two
frameworks); an identity-padded step must be a bitwise no-op."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdpp_tpu.diffusion import scheduler as jsched
from vdpp_tpu.parallel import step_assignment as jsa

from vdpp_tpu_torch.diffusion import scheduler as tsched
from vdpp_tpu_torch.parallel import step_assignment as tsa


@pytest.mark.parametrize("n", [1, 2, 4, 25, 30])
def test_tables_equal_bitwise(n):
    np.testing.assert_array_equal(tsched.karras_sigmas(n), jsched.karras_sigmas(n))
    sig = jsched.karras_sigmas(n)
    np.testing.assert_array_equal(tsched.continuous_timesteps(sig),
                                  jsched.continuous_timesteps(sig))


@pytest.mark.parametrize("n,pad,denoise_from", [(30, None, 0), (30, 8, 0), (25, 4, 0),
                                                 (30, 8, 12), (7, 3, 2)])
def test_schedule_create_equal_bitwise(n, pad, denoise_from):
    got = tsched.EulerKarrasSchedule.create(n, pad_to_multiple_of=pad, denoise_from=denoise_from)
    want = jsched.EulerKarrasSchedule.create(n, pad_to_multiple_of=pad,
                                             denoise_from=denoise_from)
    np.testing.assert_array_equal(got.sigmas, want.sigmas)
    np.testing.assert_array_equal(got.timesteps, want.timesteps)
    assert got.num_steps == want.num_steps
    assert got.init_noise_sigma == want.init_noise_sigma


def test_identity_padded_step_is_bitwise_noop():
    sched = tsched.EulerKarrasSchedule.create(30, pad_to_multiple_of=8)
    assert sched.sigmas[0] == sched.sigmas[1]  # 2 leading identity steps
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 3, 8, 8, 4)).astype(np.float32)) * 700
    eps = torch.from_numpy(rng.standard_normal((1, 3, 8, 8, 4)).astype(np.float32))
    out = sched.step(x, eps, 0)
    assert torch.equal(out, x)


@pytest.mark.parametrize("k", [0, 10, 28, 29])
def test_euler_step_matches_jax(k):
    sig = jsched.karras_sigmas(30)
    rng = np.random.default_rng(k)
    x = (rng.standard_normal((1, 3, 8, 8, 4)) * sig[k]).astype(np.float32)
    eps = rng.standard_normal((1, 3, 8, 8, 4)).astype(np.float32)
    want = np.asarray(jsched.euler_step_v_prediction(jnp.asarray(x), jnp.asarray(eps),
                                                     sig[k], sig[k + 1]))
    got = tsched.euler_step_v_prediction(torch.from_numpy(x), torch.from_numpy(eps),
                                         sig[k], sig[k + 1]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_scale_model_input_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5)).astype(np.float32) * 80
    want = np.asarray(jsched.scale_model_input(jnp.asarray(x), 80.0))
    got = tsched.scale_model_input(torch.from_numpy(x), 80.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("total,world", [(30, 1), (30, 5), (30, 6), (24, 8), (7, 7)])
def test_step_assignment_copy_matches(total, world):
    for rank in range(world):
        a = tsa.assign_steps(total, world, rank)
        b = jsa.assign_steps(total, world, rank)
        assert (a.start, a.end) == (b.start, b.end)
        u = tsa.assign_steps_uneven(total + 1, world, rank)
        v = jsa.assign_steps_uneven(total + 1, world, rank)
        assert (u.start, u.end) == (v.start, v.end)
    if world > 1 and total % (world + 1):
        with pytest.raises(ValueError):
            tsa.assign_steps(total, world + 1, 0)
