"""The port's schedules, their updates and step assignment against the JAX
package. Tables are compared exactly (bit for bit); the fp32 Euler update
within 1e-6 relative (scalar rsqrt/log may differ by an ulp between the two
frameworks), the flow-matching update exactly (one multiply-add in fp32 on
both sides); an identity-padded step must be a bitwise no-op."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdpp_tpu.diffusion import scheduler as jsched
from vdpp_tpu.parallel import step_assignment as jsa

from vdpp_tpu_torch.diffusion import scheduler as tsched
from vdpp_tpu_torch.parallel import step_assignment as tsa

from torch_port_helpers import one_torch_thread  # noqa: F401


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


@pytest.mark.parametrize("n,shift", [(1, 3.0), (4, 3.0), (24, 3.0), (24, 1.0), (30, 7.5)])
def test_flowmatch_tables_equal_bitwise(n, shift):
    np.testing.assert_array_equal(tsched.flowmatch_sigmas(n, shift),
                                  jsched.flowmatch_sigmas(n, shift))


@pytest.mark.parametrize("n,pad", [(24, None), (24, 5), (7, 4), (3, 3)])
def test_flowmatch_schedule_create_equal_bitwise(n, pad):
    got = tsched.FlowMatchSchedule.create(n, shift=3.0, pad_to_multiple_of=pad)
    want = jsched.FlowMatchSchedule.create(n, shift=3.0, pad_to_multiple_of=pad)
    np.testing.assert_array_equal(got.sigmas, want.sigmas)
    np.testing.assert_array_equal(got.timesteps, want.timesteps)
    assert (got.num_steps, got.init_noise_sigma) == (want.num_steps, want.init_noise_sigma)
    for k in (0, got.num_steps - 1):
        assert got.sigma_at(k) == float(want.sigma_at(k))
        assert got.timestep_at(k) == float(want.timestep_at(k))


def test_flowmatch_schedule_rejects_bad_arguments():
    with pytest.raises(ValueError):
        tsched.flowmatch_sigmas(0)
    with pytest.raises(ValueError):
        tsched.flowmatch_sigmas(4, shift=0.0)


@pytest.mark.parametrize("k", [0, 11, 23])
def test_flowmatch_step_matches_jax(k):
    sig = jsched.flowmatch_sigmas(24, 3.0)
    rng = np.random.default_rng(100 + k)
    x = rng.standard_normal((1, 3, 8, 8, 4)).astype(np.float32)
    v = rng.standard_normal((1, 3, 8, 8, 4)).astype(np.float32)
    want = np.asarray(jsched.flowmatch_step(jnp.asarray(x), jnp.asarray(v), sig[k], sig[k + 1]))
    got = tsched.flowmatch_step(torch.from_numpy(x), torch.from_numpy(v), sig[k],
                                sig[k + 1]).numpy()
    np.testing.assert_array_equal(got, want)


def test_flowmatch_identity_padded_step_is_bitwise_noop():
    sched = tsched.FlowMatchSchedule.create(24, pad_to_multiple_of=5)
    assert sched.sigmas[0] == sched.sigmas[1]  # one leading identity step
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((1, 3, 8, 8, 4)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 3, 8, 8, 4)).astype(np.float32))
    assert torch.equal(sched.step(x, v, 0), x)


# The second-order solvers, on a smooth stand-in for the model (the same
# function of the scaled latent and the c_noise timestep on both sides).
def _jax_eps(xs, t):
    return jnp.tanh(xs) * 0.5 + 0.1 * t


def _torch_eps(xs, t):
    return torch.tanh(xs) * 0.5 + 0.1 * t


def _table(padded: bool) -> np.ndarray:
    """30 Karras steps; padded to a multiple of 8 (two leading identity steps)."""
    if padded:
        return jsched.EulerKarrasSchedule.create(30, pad_to_multiple_of=8).sigmas
    return jsched.karras_sigmas(30)


@pytest.mark.parametrize("case,k", [("first", 0), ("padded", 0), ("final", 29)])
def test_heun_step_matches_jax(case, k):
    """The first step, an identity-padded step (a bitwise no-op on both
    sides, whatever the model returns) and the final sigma = 0 (plain
    Euler)."""
    sig = _table(case == "padded")
    x = (np.random.default_rng(k).standard_normal((1, 3, 8, 8, 4)) * sig[k]).astype(np.float32)
    want = np.asarray(jsched.heun_step_v_prediction(jnp.asarray(x), _jax_eps, sig[k], sig[k + 1]))
    got = tsched.heun_step_v_prediction(torch.from_numpy(x), _torch_eps, sig[k], sig[k + 1])
    if case == "padded":
        assert torch.equal(got, torch.from_numpy(x)) and np.array_equal(want, x)
    if case == "final":
        eps = _torch_eps(torch.from_numpy(x) * torch.rsqrt(torch.tensor(sig[k]) ** 2 + 1.0),
                         0.25 * torch.log(torch.tensor(sig[k])))
        assert torch.equal(got, tsched.euler_step_v_prediction(torch.from_numpy(x), eps, sig[k],
                                                               0.0))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("case,k", [("first", 0), ("second_order", 10), ("padded", 0),
                                    ("after_padding", 2), ("final", 29)])
def test_dpmpp2m_step_matches_jax(case, k):
    """The first step (sigma_prev == sigma: first order), a second-order
    step, an identity-padded step (a bitwise no-op), the step after the
    padding (first order again: the carried x0_hat is not read) and the
    final sigma = 0 (x_next = x0_hat)."""
    sig = _table(case in ("padded", "after_padding"))
    rng = np.random.default_rng(50 + k)
    x, eps, old = rng.standard_normal((3, 1, 3, 8, 8, 4)).astype(np.float32)
    x = x * sig[k]
    s_prev, s, s_next = sig[max(k - 1, 0)], sig[k], sig[k + 1]
    want = [np.asarray(a) for a in jsched.dpmpp2m_step_v_prediction(
        jnp.asarray(x), jnp.asarray(eps), jnp.asarray(old), s_prev, s, s_next)]
    got = tsched.dpmpp2m_step_v_prediction(torch.from_numpy(x), torch.from_numpy(eps),
                                           torch.from_numpy(old), s_prev, s, s_next)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6 * np.abs(w).max())
    if case == "padded":
        assert torch.equal(got[0], torch.from_numpy(x)) and np.array_equal(want[0], x)
    if case in ("first", "after_padding"):  # the carried x0_hat is not read
        zeros = tsched.dpmpp2m_step_v_prediction(torch.from_numpy(x), torch.from_numpy(eps),
                                                 torch.zeros_like(torch.from_numpy(old)),
                                                 s_prev, s, s_next)
        assert torch.equal(got[0], zeros[0])
    if case == "final":
        torch.testing.assert_close(got[0], got[1], rtol=1e-6, atol=0)


# ------------------------ euler_a (ancestral) ------------------------ #
@pytest.mark.parametrize("k", [0, 10, 28, 29])
def test_euler_ancestral_step_matches_jax(k):
    """Same latent, model output and noise on both sides: within 1e-6 of
    max|ref| (scalar sqrt/rsqrt may differ by an ulp); step 29 is the last,
    to sigma 0."""
    sig = jsched.karras_sigmas(30)
    rng = np.random.default_rng(100 + k)
    x, eps, z = (rng.standard_normal((1, 3, 8, 8, 4)).astype(np.float32) for _ in range(3))
    x = x * np.float32(sig[k])
    want = np.asarray(jsched.euler_ancestral_step_v_prediction(
        jnp.asarray(x), jnp.asarray(eps), jnp.asarray(z), sig[k], sig[k + 1]))
    got = tsched.euler_ancestral_step_v_prediction(
        *(torch.from_numpy(a) for a in (x, eps, z)), sig[k], sig[k + 1]).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_euler_ancestral_exact_points():
    """A padded step (sigma_next == sigma) is a bitwise no-op whatever the
    noise; the last step (sigma_next == 0) ignores the noise and is the
    Euler step; the noise enters at exactly sigma_up, and sigma_up^2 +
    sigma_down^2 == sigma_next^2."""
    rng = np.random.default_rng(7)
    x, eps, z1, z2 = (torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32))
                      for _ in range(4))
    step = tsched.euler_ancestral_step_v_prediction
    assert torch.equal(step(x * 700, eps, z1, np.float32(700.0), np.float32(700.0)), x * 700)
    a, b = step(x, eps, z1, 0.002, 0.0), step(x, eps, z2, 0.002, 0.0)
    assert torch.equal(a, b)
    torch.testing.assert_close(a, tsched.euler_step_v_prediction(x, eps, 0.002, 0.0),
                               rtol=1e-6, atol=1e-7)
    zero = torch.zeros(2, 2)
    up = math.sqrt(1.25 ** 2 * (2.5 ** 2 - 1.25 ** 2) / 2.5 ** 2)
    diff = step(zero, zero, torch.ones(2, 2), 2.5, 1.25) - step(zero, zero, zero, 2.5, 1.25)
    torch.testing.assert_close(diff, torch.full((2, 2), up), rtol=1e-6, atol=0)
    down2 = 1.25 ** 2 - up ** 2
    assert math.isclose(up ** 2 + down2, 1.25 ** 2, rel_tol=1e-12)


def test_ancestral_noise_is_a_pure_function_of_seed_and_step():
    """The port's draw (its own generator, not JAX's stream): standard
    normal, the same for the same (seed, step) in any process, different
    for another seed or step (the pair is hashed into the generator's seed,
    of which the CPU generator reads 32 bits)."""
    draw = tsched.ancestral_noise
    z = draw(3, 5, (4, 64, 64), "cpu")
    assert z.dtype == torch.float32 and z.shape == (4, 64, 64)
    assert abs(z.mean().item()) < 0.05 and abs(z.std().item() - 1.0) < 0.05
    assert torch.equal(z, draw(3, 5, (4, 64, 64), "cpu"))
    for seed, step in ((3, 6), (4, 5), (2 ** 31 + 3, 5), (5, 3), (-3, 5)):
        assert not torch.equal(z, draw(seed, step, (4, 64, 64), "cpu")), (seed, step)
