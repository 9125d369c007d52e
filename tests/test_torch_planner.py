"""The port's spline, norms, task cost and Predictive Sampling against JAX.

The slice as a whole: one Cartpole `optimize` step in both packages from
the same state, with the same noise (regenerated from the JAX key split
that sampling.sample_candidates uses), must give the same candidates, the
same returns, the same winner and the same new policy. Small sizes: 16
candidates, a 10-step horizon.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu.ops import norms as jnorms
from mujoco_mpc_tpu.ops import spline as jspline
from mujoco_mpc_tpu.physics.model import make_data as jmake_data
from mujoco_mpc_tpu.planners import sampling as jsampling
from mujoco_mpc_tpu.tasks import registry as jregistry
from mujoco_mpc_tpu_torch import agent
from mujoco_mpc_tpu_torch.ops import norms
from mujoco_mpc_tpu_torch.ops import spline
from mujoco_mpc_tpu_torch.physics.model import make_data
from mujoco_mpc_tpu_torch.planners import sampling
from mujoco_mpc_tpu_torch.tasks import registry

torch.set_num_threads(1)

NUM_SAMPLES = 15          # + the nominal = 16 candidates
HORIZON = 10


@pytest.mark.parametrize('interp', list(spline.Interp))
def test_spline_sample_resample_knots(interp):
  rng = np.random.default_rng(int(interp))
  times = np.sort(rng.uniform(0.0, 1.0, 6))
  values = rng.normal(size=(6, 3))
  ts = np.concatenate([[-0.1, times[0], times[3], times[-1], 1.5],
                       rng.uniform(-0.1, 1.1, 20)])
  got = spline.sample(torch.from_numpy(times), torch.from_numpy(values),
                      torch.from_numpy(ts), interp).numpy()
  want = np.stack([np.asarray(jspline.sample(
      jnp.asarray(times), jnp.asarray(values), t, interp)) for t in ts])
  # f64, same formulas: rounding only
  np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)

  new_t = np.array(jspline.knot_times(jnp.asarray(0.3), jnp.asarray(0.9),
                                        6, interp))
  got_t = spline.knot_times(torch.tensor(0.3, dtype=torch.float64),
                            torch.tensor(0.9, dtype=torch.float64), 6,
                            interp).numpy()
  np.testing.assert_allclose(got_t, new_t, rtol=1e-15)
  got_r = spline.resample(torch.from_numpy(times), torch.from_numpy(values),
                          torch.from_numpy(new_t), interp).numpy()
  want_r = np.asarray(jspline.resample(jnp.asarray(times),
                                       jnp.asarray(values),
                                       jnp.asarray(new_t), interp))
  np.testing.assert_allclose(got_r, want_r, rtol=1e-12, atol=1e-12)


NORM_PARAMS = {
    norms.NormType.NULL: [0.0, 0.0, 0.0],
    norms.NormType.QUADRATIC: [0.0, 0.0, 0.0],
    norms.NormType.L22: [0.3, 1.7, 0.0],
    norms.NormType.L2: [0.2, 0.0, 0.0],
    norms.NormType.COSH: [0.8, 0.0, 0.0],
    norms.NormType.POWER_LOSS: [1.5, 0.0, 0.0],
    norms.NormType.SMOOTH_ABS_LOSS: [0.1, 0.0, 0.0],
    norms.NormType.SMOOTH_ABS2_LOSS: [0.2, 3.0, 0.0],
    norms.NormType.RECTIFY_LOSS: [0.5, 0.0, 0.0],
}


@pytest.mark.parametrize('norm_type', list(norms.NormType))
def test_norm_value(norm_type):
  x = np.random.default_rng(5).normal(size=(7, 3))
  params = np.asarray(NORM_PARAMS[norm_type])
  got = norms.norm_value(torch.from_numpy(x), torch.from_numpy(params),
                         norm_type).numpy()
  want = np.asarray(jnorms.norm_value(jnp.asarray(x), jnp.asarray(params),
                                      norm_type))
  np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


@pytest.fixture(scope='module')
def tasks():
  return (jregistry.get_task('Cartpole'),
          registry.get_task('Cartpole', device='cpu'))


@pytest.mark.parametrize('risk', [0.0, 0.35])
def test_task_cost_with_risk(tasks, risk):
  jspec, spec = tasks
  res = np.random.default_rng(6).normal(size=(5, 4, 4)).astype(np.float32)
  jp = jspec.default_params.replace(risk=jnp.asarray(risk, jnp.float32))
  p = spec.default_params.replace(risk=torch.tensor(risk))
  want = np.asarray(jspec.cost(jnp.asarray(res), jp))
  got = spec.cost(torch.from_numpy(res), p).numpy()
  # f32, and exp() of the risk transform amplifies the last ulp
  np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)


def _jax_noise(key, num_points, nu):
  """sampling.py:108-114's draws, from the same key split."""
  k_noise, k_mix = jax.random.split(key)
  eps = jax.random.normal(k_noise, (NUM_SAMPLES, num_points, nu),
                          dtype=jnp.float32)
  use2 = jax.random.bernoulli(k_mix, jsampling.STD2_PROPORTION,
                              (NUM_SAMPLES,))
  return (torch.from_numpy(np.array(eps)),
          torch.from_numpy(np.array(use2)))


@pytest.mark.parametrize('std2', [0.0, 0.9])
def test_candidates_from_noise(tasks, std2):
  jspec, spec = tasks
  key = jax.random.key(3)
  jcfg = jsampling.default_config(jspec).replace(
      noise_std2=jnp.asarray(std2, jnp.float32))
  cfg = sampling.default_config(spec)
  cfg = sampling.SamplingConfig(cfg.noise_std, torch.tensor(std2),
                                cfg.timestep, cfg.horizon_time)
  jnom = jsampling.default_policy(jspec, 10)
  jnom = jnom.replace(values=jnp.linspace(-0.9, 0.9, 10)[:, None].astype(
      jnp.float32))
  nom = sampling.SamplingPolicy(torch.from_numpy(np.array(jnom.times)),
                                torch.from_numpy(np.array(jnom.values)))
  want = np.asarray(jsampling.sample_candidates(jspec, jnom, NUM_SAMPLES,
                                                jcfg, key))
  got = sampling.candidates_from_noise(spec, nom, *_jax_noise(key, 10, 1),
                                       cfg).numpy()
  # f32 elementwise scale-add-clip, same order of operations
  np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_optimize_step_matches_jax(tasks):
  """The slice: resample, candidates, knots -> actions, rollouts of the
  Cartpole physics (limit rows, Newton, Euler), returns, argmin."""
  jspec, spec = tasks
  interp = int(spline.Interp.ZERO)
  key = jax.random.key(11)
  qpos0 = np.asarray([1.0, 3.14159], np.float32)
  jd0 = jmake_data(jspec.model).replace(qpos=jnp.asarray(qpos0))
  jpol = jsampling.default_policy(jspec, 10)
  jpol = jpol.replace(values=jnp.asarray(
      np.random.default_rng(7).uniform(-1, 1, (10, 1)), jnp.float32))
  jcfg = jsampling.default_config(jspec)

  @jax.jit
  def jplan(pol, k):
    return jsampling.optimize(jspec, pol, jd0, jspec.default_params, jcfg,
                              k, NUM_SAMPLES, HORIZON, interp)

  jnew, jinfo = jplan(jpol, key)

  d0 = make_data(spec.model).replace(qpos=torch.from_numpy(qpos0)[None])
  pol = sampling.SamplingPolicy(torch.from_numpy(np.array(jpol.times)),
                                torch.from_numpy(np.array(jpol.values)))
  new, info = sampling.optimize(
      spec, pol, d0, spec.default_params, sampling.default_config(spec),
      _jax_noise(key, 10, 1), HORIZON, interp)

  # f32 rollouts of 10 steps: the two frameworks round transcendental and
  # summed terms differently, which grows to ~1e-6 relative in the returns
  np.testing.assert_allclose(info['returns'].numpy(),
                             np.asarray(jinfo['returns']), rtol=1e-4)
  assert int(info['winner']) == int(jinfo['winner'])
  assert float(info['best_return']) <= float(info['nominal_return'])
  np.testing.assert_array_equal(new.times.numpy(), np.asarray(jnew.times))
  np.testing.assert_allclose(new.values.numpy(), np.asarray(jnew.values),
                             rtol=1e-6, atol=1e-7)


def test_synchronous_mpc_smoke(tasks):
  _, spec = tasks
  gen = torch.Generator().manual_seed(0)
  sim0 = make_data(spec.model).replace(
      qpos=torch.tensor([[1.0, 3.14159]]))
  carry, costs = agent.synchronous_mpc(spec, NUM_SAMPLES, total_steps=10,
                                       steps_per_plan=5, generator=gen,
                                       sim0=sim0)
  assert costs.shape == (10,)
  assert torch.isfinite(costs).all()
  assert float(carry.sim.time[0]) == pytest.approx(0.1, abs=1e-6)
  assert torch.isfinite(carry.sim.qpos).all()
