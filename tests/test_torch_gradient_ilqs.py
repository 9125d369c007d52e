"""The port's Gradient and iLQS planners against the JAX package, float64.

* derivatives.spline_mapping for every Interp (rtol 1e-12): JAX takes
  jacfwd of the sampler, the port evaluates it on the unit knot vectors;
* gradient_planner.adjoint_sweep on random derivatives, and the line
  search's steps (logspace's one-point case at K 2);
* gradient_planner.optimize on Cartpole;
* ilqs._trajectory_to_spline;
* ilqs.optimize along both branches, each at rtol 1e-6: sampling improves
  (a noisy draw), and sampling does not (every candidate equal to the
  nominal: exploration 0) so that eager iLQG runs; then one iteration
  from the state iLQG left, whose sampling nominal is iLQG's plan
  converted to a spline; and the host-read count;
* one more iteration in both packages from a JAX iLQS state carried
  across by convert.

Cartpole with the cart moving, a 10-step horizon, 5 knots; the sampling
noise is regenerated from the JAX key as in tests/test_torch_planners.py.
JAX's Gradient and iLQS optimize are replayed from their recorded calls
(assets/gradient_ilqs_jax_calls_golden.npz, tests/torch_recorded.py: the
iLQS compile took ~40 s); the slow test_jax_calls_golden_is_jaxs makes
them live.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu.ops import spline as jspline
from mujoco_mpc_tpu.physics.model import make_data as jmake_data
from mujoco_mpc_tpu.planners import derivatives as jder
from mujoco_mpc_tpu.planners import gradient_planner as jgrad
from mujoco_mpc_tpu.planners import ilqg as jilqg
from mujoco_mpc_tpu.planners import ilqs as jilqs
from mujoco_mpc_tpu.planners import sampling as jsampling
from mujoco_mpc_tpu.tasks import registry as jregistry
from mujoco_mpc_tpu_torch import convert
from mujoco_mpc_tpu_torch.ops import spline
from mujoco_mpc_tpu_torch.physics.model import make_data
from mujoco_mpc_tpu_torch.planners import derivatives
from mujoco_mpc_tpu_torch.planners import gradient_planner
from mujoco_mpc_tpu_torch.planners import ilqg
from mujoco_mpc_tpu_torch.planners import ilqs
from mujoco_mpc_tpu_torch.planners import sampling
from mujoco_mpc_tpu_torch.tasks import registry
from tests.test_torch_cube import QUICK_COMPILE
from tests.torch_recorded import RecordedJax

torch.set_num_threads(1)

F64 = torch.float64
HORIZON = 10
POINTS = 5
SAMPLES = 15
ILQG_CANDIDATES = 4
INTERP = int(spline.Interp.LINEAR)


def _f64(tree):
  return jax.tree.map(
      lambda x: x.astype(jnp.float64)
      if jnp.issubdtype(getattr(x, 'dtype', np.int32), jnp.floating) else x,
      tree)


def _np(x):
  return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x)


def _close(got, want, what, rtol):
  np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=rtol * 1e-3,
                             err_msg=what)


@pytest.fixture(scope='module')
def cart():
  """(JAX spec in f64, its d0, the port's spec in f64, its d0)."""
  with pytest.MonkeyPatch.context() as mp:
    # JAX's rollout scan not unrolled: half the compile, the same result
    mp.setenv('MJPC_TPU_UNROLL', '1')
    jspec = jregistry.get_task('Cartpole')
    jspec = dataclasses.replace(jspec, model=_f64(jspec.model),
                                default_params=_f64(jspec.default_params))
    q, v = [0.3, 2.8], [0.6, -0.9]
    jd0 = jmake_data(jspec.model, dtype=jnp.float64).replace(
        qpos=jnp.asarray(q), qvel=jnp.asarray(v))
    spec = registry.get_task('Cartpole', device='cpu', dtype=F64)
    d0 = make_data(spec.model).replace(qpos=torch.tensor([q], dtype=F64),
                                       qvel=torch.tensor([v], dtype=F64))
    yield jspec, jd0, spec, d0
  jax.clear_caches()


def _values(seed):
  return np.random.default_rng(seed).uniform(-0.8, 0.8, (POINTS, 1))


# the module's JAX optimize calls, replayed from their recorded calls
# (tests/torch_recorded.py)
JAX_CALLS = 'gradient_ilqs_jax_calls_golden.npz'
GRADIENT_CANDIDATES = 6


@pytest.fixture(scope='module')
def jax_calls(cart):
  """JAX's 'gradient' optimize (6 candidates) and 'ilqs' optimize (the
  sampling config an argument, so that both branches share it), each
  jitted once."""
  jspec, jd0, _, _ = cart

  def live():
    fns = {'gradient': functools.partial(
        jgrad.optimize, jspec, cfg=jgrad.default_config(jspec, jnp.float64),
        num_candidates=GRADIENT_CANDIDATES, horizon_steps=HORIZON,
        interp=INTERP),
           'ilqs': functools.partial(
               jilqs.optimize, jspec, d0=jd0, params=jspec.default_params,
               icfg=jilqg.default_config(jspec, dtype=jnp.float64),
               num_samples=SAMPLES, num_ilqg_candidates=ILQG_CANDIDATES,
               horizon_steps=HORIZON, interp=INTERP)}
    return {k: jax.jit(f, compiler_options=QUICK_COMPILE)
            for k, f in fns.items()}

  rec = RecordedJax(os.path.join(registry.ASSETS, JAX_CALLS), live)
  yield rec
  if rec.recording:
    rec.save()


# ---------------------------------------------------------------------------
# spline mapping, adjoint sweep, line-search steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('interp', list(spline.Interp))
def test_spline_mapping_matches_jax(interp):
  rng = np.random.default_rng(int(interp))
  times = np.sort(rng.uniform(0.0, 1.0, 6))
  # inside, on and outside the knots
  ts = np.concatenate([[-0.2, times[0], times[2], times[-1], 1.3],
                       rng.uniform(-0.1, 1.1, 12)])
  got = derivatives.spline_mapping(torch.from_numpy(times),
                                   torch.from_numpy(ts), int(interp))
  want = jder.spline_mapping(jnp.asarray(times), jnp.asarray(ts),
                             int(interp))
  assert got.shape == (ts.shape[0], 6)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                             atol=1e-14)
  # the mapping is the sampler: M v = sample_many(v) for any knot values
  v = rng.normal(size=(6, 2))
  np.testing.assert_allclose(
      (got @ torch.from_numpy(v)).numpy(),
      np.asarray(jspline.sample_many(jnp.asarray(times), jnp.asarray(v),
                                     jnp.asarray(ts), int(interp))),
      rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize('seed', [0, 1])
def test_adjoint_sweep_matches_jax(seed):
  rng = np.random.default_rng(seed)
  t_steps, nd, nu = 7, 4, 2
  raw = dict(a=np.eye(nd) + 0.2 * rng.normal(size=(t_steps - 1, nd, nd)),
             b=rng.normal(size=(t_steps - 1, nd, nu)),
             cx=rng.normal(size=(t_steps, nd)),
             cu=rng.normal(size=(t_steps, nu)),
             cxx=rng.normal(size=(t_steps, nd, nd)),
             cxu=rng.normal(size=(t_steps, nd, nu)),
             cuu=rng.normal(size=(t_steps, nu, nu)))
  got = gradient_planner.adjoint_sweep(derivatives.Derivatives(
      **{k: torch.from_numpy(v) for k, v in raw.items()}))
  want = jgrad.adjoint_sweep(jder.Derivatives(
      **{k: jnp.asarray(v) for k, v in raw.items()}))
  for name, g, w in zip(('qu', 'k', 'dv'), got, want):
    _close(g, w, name, 1e-12)


@pytest.mark.parametrize('k', [2, 3, 9])
def test_linesearch_steps_match_jax(k):
  """K - 1 log-spaced steps then 0; at K 2 logspace's one point is its
  start, 1."""
  got = gradient_planner.linesearch_steps(k, F64)
  want = jnp.concatenate([jnp.logspace(0.0, jnp.log10(
      jgrad.MIN_LINESEARCH_STEP), k - 1, dtype=jnp.float64),
                          jnp.zeros(1)])
  _close(got, want, 'steps', 1e-13)


# ---------------------------------------------------------------------------
# Gradient planner
# ---------------------------------------------------------------------------


def test_gradient_optimize_matches_jax(cart, jax_calls):
  jspec, jd0, spec, d0 = cart
  jpol = jsampling.default_policy(jspec, POINTS, dtype=jnp.float64).replace(
      values=jnp.asarray(_values(1)))
  pol = sampling.SamplingPolicy(torch.from_numpy(np.array(jpol.times)),
                                torch.from_numpy(_values(1)))
  jnew, jinfo = jax_calls('gradient', jpol, d0=jd0,
                          params=jspec.default_params)
  new, info = gradient_planner.optimize(
      spec, pol, d0, spec.default_params,
      gradient_planner.default_config(spec), GRADIENT_CANDIDATES, HORIZON,
      INTERP)
  assert float(info['action_step']) == float(jinfo['action_step'])
  for key in ('best_return', 'nominal_return', 'improvement', 'action_step',
              'expected', 'qu_norm'):
    _close(info[key], jinfo[key], key, 1e-8)
  _close(new.values, jnew.values, 'values', 1e-8)
  _close(new.times, jnew.times, 'times', 1e-12)
  assert float(info['best_return']) <= float(info['nominal_return'])
  assert float(info['qu_norm']) > 0.0


# ---------------------------------------------------------------------------
# iLQS
# ---------------------------------------------------------------------------


def _ilqg_policy(jspec, spec, seed):
  """A JAX iLQG policy with random actions and gains, and the port's."""
  rng = np.random.default_rng(seed)
  jst = jilqg.default_state(jspec, HORIZON, dtype=jnp.float64)
  jpol = jst.policy.replace(
      times=jst.policy.times + 0.05,
      actions=jnp.asarray(rng.uniform(-0.9, 0.9, (HORIZON, 1))),
      feedback_gain=jnp.asarray(0.1 * rng.normal(size=(HORIZON, 1, 4))))
  pol = ilqg.ILQGPolicy(**{k: torch.from_numpy(np.array(v))
                           for k, v in vars(jpol).items()})
  return jst.replace(policy=jpol), pol


def test_trajectory_to_spline_matches_jax(cart):
  jspec, _, spec, _ = cart
  jst, pol = _ilqg_policy(jspec, spec, 2)
  ts = jnp.asarray(0.01)
  want = jilqs._trajectory_to_spline(jspec, jst.policy, POINTS, HORIZON, ts,
                                     INTERP)
  got = ilqs._trajectory_to_spline(spec, pol, POINTS, HORIZON,
                                   torch.tensor(0.01, dtype=F64), INTERP)
  _close(got.times, want.times, 'times', 1e-12)
  _close(got.values, want.values, 'values', 1e-9)


def _sampling_noise(key):
  k_noise, k_mix = jax.random.split(key)
  return (torch.from_numpy(np.array(jax.random.normal(
      k_noise, (SAMPLES, POINTS, 1), dtype=jnp.float64))),
          torch.from_numpy(np.array(jax.random.bernoulli(
              k_mix, jsampling.STD2_PROPORTION, (SAMPLES,)))))


def _leaves(state, prefix=''):
  if dataclasses.is_dataclass(state):
    out = {}
    for f in dataclasses.fields(state):
      out.update(_leaves(getattr(state, f.name), prefix + f.name + '.'))
    return out
  return {prefix[:-1]: state}


def _check_ilqs(state, jstate, info, jinfo, what):
  for k, v in _leaves(state).items():
    w = jstate
    for part in k.split('.'):
      w = getattr(w, part)
    _close(v, w, f'{what}: {k}', 1e-6)
  for k in ('best_return', 'sampling_return', 'ilqg_return', 'active'):
    _close(info[k], jinfo[k], f'{what}: {k}', 1e-6)


@pytest.fixture(scope='module')
def jilqs_opt(jax_calls):
  """JAX's iLQS optimize (jax_calls)."""
  return functools.partial(jax_calls, 'ilqs')


def _ilqs_start(jspec, spec):
  jpol = jsampling.default_policy(jspec, POINTS, dtype=jnp.float64).replace(
      values=jnp.asarray(_values(3)))
  jstate = jilqs.default_state(jspec, POINTS, HORIZON,
                               dtype=jnp.float64).replace(
                                   sampling_policy=jpol)
  state = dataclasses.replace(
      ilqs.default_state(spec, POINTS, HORIZON),
      sampling_policy=sampling.SamplingPolicy(
          torch.from_numpy(np.array(jpol.times)),
          torch.from_numpy(_values(3))))
  return jstate, state


def test_ilqs_optimize_both_branches_match_jax(cart, jilqs_opt):
  """Three iterations in both packages, each from its own previous state:
  (1) exploration 0, so no candidate beats the nominal and eager iLQG
  runs; (2) from iLQG's state, sampling from its converted plan; (3) a
  second noisy draw. The host branch reads the device once an
  iteration."""
  jspec, jd0, spec, d0 = cart
  jscfg = jsampling.default_config(jspec, dtype=jnp.float64)
  scfg = sampling.default_config(spec)
  icfg = ilqg.default_config(spec)
  jstate, state = _ilqs_start(jspec, spec)
  zero = jnp.zeros((), jnp.float64)
  reads0 = ilqs.host_reads
  branches = []
  for it, (key, quiet) in enumerate(((jax.random.key(4), True),
                                     (jax.random.key(5), False),
                                     (jax.random.key(6), False))):
    jcfg_it = jscfg.replace(noise_std=zero) if quiet else jscfg
    cfg_it = (dataclasses.replace(scfg, noise_std=torch.zeros((), dtype=F64))
              if quiet else scfg)
    jstate, jinfo = jilqs_opt(jstate, scfg=jcfg_it, key=key)
    state, info = ilqs.optimize(spec, state, d0, spec.default_params, cfg_it,
                                icfg, _sampling_noise(key), ILQG_CANDIDATES,
                                HORIZON, INTERP)
    _check_ilqs(state, jstate, info, jinfo, f'iteration {it}')
    branches.append(bool(info['sampling_improved']))
    if it == 0:
      assert int(state.active) == ilqs.ACTIVE_ILQG, 'iLQG did not win'
  assert ilqs.host_reads - reads0 == 3
  # iLQG ran in the first iteration only; sampling improved in the others
  assert branches == [False, True, True]
  u = ilqs.action_from_policy(spec, state, d0.qpos, d0.qvel, d0.act,
                              d0.time, INTERP)
  ju = jilqs.action_from_policy(jspec, jstate, jd0.qpos, jd0.qvel, jd0.act,
                                jd0.time, INTERP)
  _close(u[0], ju, 'action', 1e-6)


def test_convert_continues_a_jax_ilqs_state(cart, jilqs_opt):
  """JAX's state after an iteration in which iLQG won (active 1), carried
  across by convert, and one more iteration in both packages: sampling
  from iLQG's plan converted to a spline."""
  jspec, _, spec, d0 = cart
  jscfg = jsampling.default_config(jspec, dtype=jnp.float64)
  jstate, _ = _ilqs_start(jspec, spec)
  jstate, _ = jilqs_opt(jstate, scfg=jscfg.replace(
      noise_std=jnp.zeros((), jnp.float64)), key=jax.random.key(4))
  assert int(jstate.active) == ilqs.ACTIVE_ILQG
  js = jstate.ilqg_state
  state = convert.ilqs_state_from_arrays(
      vars(jstate.sampling_policy), vars(js.policy),
      {k: getattr(js, k) for k in convert.ILQG_STATE_FIELDS}, jstate.active,
      device='cpu', dtype=F64)
  key = jax.random.key(8)
  jnew, jinfo = jilqs_opt(jstate, scfg=jscfg, key=key)
  new, info = ilqs.optimize(spec, state, d0, spec.default_params,
                            sampling.default_config(spec),
                            ilqg.default_config(spec), _sampling_noise(key),
                            ILQG_CANDIDATES, HORIZON, INTERP)
  _check_ilqs(new, jnew, info, jinfo, 'continued')


@pytest.mark.slow
def test_jax_calls_golden_is_jaxs(jax_calls):
  """The recorded JAX calls are what the JAX package computes now."""
  jax_calls.check_live()
