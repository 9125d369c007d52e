"""The port's sampling-family planners against the JAX package, float64.

* rollout.noisy_rollout_return (the Ornstein-Uhlenbeck body wrenches of
  the Robust planner) at B 6;
* Cross Entropy's and Sample Gradient's optimize: candidates, returns,
  winner and new state; and one more iteration in both packages from a
  JAX state carried across by convert;
* the three ranked delegates' optimize_candidates and select, and
  robust.optimize_ranked over each;
* the robust_delegate key of make_planner;
* the tie order of the ranks (lax.top_k) and of Sample Gradient's
  argsort (jnp.argsort) on crafted returns with ties, and
  _fitness_weights exactly.

Cartpole from a state with both joints moving, 15 noisy candidates (16
with the nominal), a 10-step horizon, 5 knots. The noise is regenerated
from the JAX keys with JAX's own draws and handed to the port. The
returns are means over 10 steps of f64 physics in two frameworks, so they
agree to rounding: rtol 1e-9. JAX's rollout scan is traced without
unrolling here (MJPC_TPU_UNROLL=1, which halves its compile and changes
no result), and each delegate's candidates and its Robust iteration are
one jit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu.physics.model import make_data as jmake_data
from mujoco_mpc_tpu.planners import cross_entropy as jcem
from mujoco_mpc_tpu.planners import ranked as jranked
from mujoco_mpc_tpu.planners import registry as jplanners
from mujoco_mpc_tpu.planners import robust as jrobust
from mujoco_mpc_tpu.planners import rollout as jrollout
from mujoco_mpc_tpu.planners import sample_gradient as jsg
from mujoco_mpc_tpu.planners import sampling as jsampling
from mujoco_mpc_tpu.tasks import registry as jregistry
from mujoco_mpc_tpu_torch import convert
from mujoco_mpc_tpu_torch.ops import spline
from mujoco_mpc_tpu_torch.physics.model import make_data
from mujoco_mpc_tpu_torch.planners import cross_entropy
from mujoco_mpc_tpu_torch.planners import ranked
from mujoco_mpc_tpu_torch.planners import registry as planners
from mujoco_mpc_tpu_torch.planners import robust
from mujoco_mpc_tpu_torch.planners import rollout
from mujoco_mpc_tpu_torch.planners import sample_gradient
from mujoco_mpc_tpu_torch.planners import sampling
from mujoco_mpc_tpu_torch.tasks import registry

torch.set_num_threads(1)

F64 = torch.float64
SAMPLES = 15               # noisy candidates; + the nominal = 16
HORIZON = 10
POINTS = 5
NCAND, NREP = 4, 3         # Robust's re-rollouts: 12
INTERP = int(spline.Interp.LINEAR)
RTOL = 1e-9


def _f64(tree):
  return jax.tree.map(
      lambda x: x.astype(jnp.float64)
      if jnp.issubdtype(getattr(x, 'dtype', np.int32), jnp.floating) else x,
      tree)


def _np(x):
  return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x)


def _close(got, want, what, rtol=RTOL):
  np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=1e-12,
                             err_msg=what)


@pytest.fixture(scope='module')
def cart():
  """(JAX spec in f64, its d0, the port's spec in f64, its d0)."""
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv('MJPC_TPU_UNROLL', '1')
    yield from _cart()
  jax.clear_caches()


def _cart():
  jspec = jregistry.get_task('Cartpole')
  jspec = dataclasses.replace(jspec, model=_f64(jspec.model),
                              default_params=_f64(jspec.default_params))
  q, v = [0.5, 3.0], [0.4, -1.2]
  jd0 = jmake_data(jspec.model, dtype=jnp.float64).replace(
      qpos=jnp.asarray(q), qvel=jnp.asarray(v), time=jnp.asarray(0.13))
  spec = registry.get_task('Cartpole', device='cpu', dtype=F64)
  d0 = make_data(spec.model).replace(
      qpos=torch.tensor([q], dtype=F64), qvel=torch.tensor([v], dtype=F64),
      time=torch.tensor([0.13], dtype=F64))
  yield jspec, jd0, spec, d0


def _values(seed, nu=1):
  return np.random.default_rng(seed).uniform(-0.8, 0.8, (POINTS, nu))


def _policies(jspec, spec, seed):
  jpol = jsampling.default_policy(jspec, POINTS, dtype=jnp.float64)
  jpol = jpol.replace(values=jnp.asarray(_values(seed)))
  return jpol, sampling.SamplingPolicy(torch.from_numpy(np.array(jpol.times)),
                                       torch.from_numpy(_values(seed)))


# ---------------------------------------------------------------------------
# the noise, regenerated from the JAX keys
# ---------------------------------------------------------------------------


def _normal(key, shape):
  return torch.from_numpy(np.array(jax.random.normal(key, shape,
                                                     dtype=jnp.float64)))


def sampling_noise(key, k):
  """sampling.sample_candidates' draws (sampling.py:108-114)."""
  k_noise, k_mix = jax.random.split(key)
  return (_normal(k_noise, (k, POINTS, 1)), torch.from_numpy(np.array(
      jax.random.bernoulli(k_mix, jsampling.STD2_PROPORTION, (k,)))))


def xfrc_noise(keys, nbody):
  """noisy_rollout_return's draws: split(key, T), one (nbody, 6) normal a
  step (rollout.py:115-122), for each key."""
  def one(k):
    return jax.vmap(lambda kt: jax.random.normal(kt, (nbody, 6),
                                                 dtype=jnp.float64))(
                                                     jax.random.split(
                                                         k, HORIZON))
  return torch.from_numpy(np.array(jax.vmap(one)(keys)))


def delegate_noise(delegate_id, key, k):
  if delegate_id == planners.CEM:
    return _normal(key, (k, POINTS, 1))
  if delegate_id == planners.SAMPLE_GRADIENT:
    num_noisy, _ = sample_gradient.split(k, planners.num_gradient_candidates(
        k))
    return _normal(key, (num_noisy - 1, POINTS, 1))
  return sampling_noise(key, k)


# ---------------------------------------------------------------------------
# noisy_rollout_return
# ---------------------------------------------------------------------------


def test_noisy_rollout_return_matches_jax(cart):
  jspec, jd0, spec, d0 = cart
  rng = np.random.default_rng(1)
  acts = rng.uniform(-1.0, 1.0, (6, HORIZON, 1))
  keys = jax.random.split(jax.random.key(2), 6)
  std, rate = 0.7, 0.2
  want = jax.jit(jax.vmap(lambda a, k: jrollout.noisy_rollout_return(
      jspec, jd0, a, jspec.default_params, k, jnp.asarray(std),
      jnp.asarray(rate))))(jnp.asarray(acts), keys)
  eps = xfrc_noise(keys, spec.model.nbody)
  got = rollout.noisy_rollout_return(
      spec, d0, torch.from_numpy(acts), spec.default_params, eps,
      torch.tensor(std, dtype=F64), torch.tensor(rate, dtype=F64))
  _close(got, want, 'returns')
  # the wrenches moved the returns: the same rollouts without them differ
  plain = rollout.batched_returns(spec, d0, torch.from_numpy(acts),
                                  spec.default_params)
  assert float(torch.max(torch.abs(plain - got))) > 1e-3


# ---------------------------------------------------------------------------
# Cross Entropy and Sample Gradient
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def jax_opt(cart):
  """JAX's CEM and Sample Gradient optimize, jitted once a module so that
  the continuation tests reuse the compiles."""
  jspec, jd0, _, _ = cart
  jsg_cfg = jsg.default_config(jspec, dtype=jnp.float64).replace(
      gradient_filter=jnp.asarray(0.7))
  opts = {'cem': jax.jit(functools.partial(
      jcem.optimize, jspec, d0=jd0, params=jspec.default_params,
      cfg=jcem.default_config(jspec, dtype=jnp.float64),
      num_samples=SAMPLES, n_elite=N_ELITE, horizon_steps=HORIZON,
      interp=INTERP))}
  for ng in (1, 4):
    opts[ng] = jax.jit(functools.partial(
        jsg.optimize, jspec, d0=jd0, params=jspec.default_params,
        cfg=jsg_cfg, num_samples=SAMPLES, num_gradient=ng,
        horizon_steps=HORIZON, interp=INTERP))
  return opts


N_ELITE = 4


def _cem_states(jspec, spec):
  jpol, pol = _policies(jspec, spec, 3)
  var = np.random.default_rng(4).uniform(0.01, 0.3, (POINTS, 1))
  return (jcem.CEMState(policy=jpol, variance=jnp.asarray(var)),
          cross_entropy.CEMState(policy=pol, variance=torch.from_numpy(var)))


def _check_cem(new, info, jnew, jinfo):
  for k in ('best_return', 'elite_avg_return', 'improvement'):
    _close(info[k], jinfo[k], k)
  _close(new.policy.times, jnew.policy.times, 'times')
  _close(new.policy.values, jnew.policy.values, 'mean')
  _close(new.variance, jnew.variance, 'variance')


def test_cem_optimize_matches_jax(cart, jax_opt):
  jspec, _, spec, d0 = cart
  jstate, state = _cem_states(jspec, spec)
  key = jax.random.key(5)
  jnew, jinfo = jax_opt['cem'](jstate, key=key)
  cfg = cross_entropy.default_config(spec)
  eps = _normal(key, (SAMPLES, POINTS, 1))
  new, info = cross_entropy.optimize(spec, state, d0, spec.default_params,
                                     cfg, eps, N_ELITE, HORIZON, INTERP)
  _check_cem(new, info, jnew, jinfo)
  # the candidates: the new mean is the mean of the 4 lowest returns'
  nominal = sampling.resample_nominal(spec, state.policy, d0.time[0],
                                      HORIZON,
                                      cross_entropy.sampling_config(cfg),
                                      INTERP)
  cands = cross_entropy.candidates_from_noise(spec, nominal, state.variance,
                                              eps, cfg)
  idx = torch.argsort(info['returns'], stable=True)[:N_ELITE]
  _close(cands[idx].mean(0), jnew.policy.values, 'elite mean')
  assert float(info['best_return']) == float(info['returns'].min())


def test_convert_continues_a_jax_cem_state(cart, jax_opt):
  """JAX's state after two iterations, carried across by convert, and one
  more iteration in both packages."""
  jspec, _, spec, d0 = cart
  jstate, _ = _cem_states(jspec, spec)
  for k in (5, 6):
    jstate, _ = jax_opt['cem'](jstate, key=jax.random.key(k))
  state = convert.cem_state_from_arrays(
      {'times': jstate.policy.times, 'values': jstate.policy.values},
      jstate.variance, device='cpu', dtype=F64)
  key = jax.random.key(7)
  jnew, jinfo = jax_opt['cem'](jstate, key=key)
  new, info = cross_entropy.optimize(
      spec, state, d0, spec.default_params,
      cross_entropy.default_config(spec), _normal(key, (SAMPLES, POINTS, 1)),
      N_ELITE, HORIZON, INTERP)
  _check_cem(new, info, jnew, jinfo)


def _sg_states(jspec, spec, seed):
  jpol, pol = _policies(jspec, spec, seed)
  rng = np.random.default_rng(seed + 10)
  g, gp = rng.normal(size=(2, POINTS, 1)) * 0.05
  return (jsg.SGState(policy=jpol, gradient=jnp.asarray(g),
                      gradient_prev=jnp.asarray(gp)),
          sample_gradient.SGState(policy=pol, gradient=torch.from_numpy(g),
                                  gradient_prev=torch.from_numpy(gp)))


def _run_sg(spec, d0, state, key, num_gradient):
  cfg = dataclasses.replace(sample_gradient.default_config(spec),
                            gradient_filter=torch.tensor(0.7, dtype=F64))
  eps = _normal(key, (SAMPLES - num_gradient - 1, POINTS, 1))
  return sample_gradient.optimize(spec, state, d0, spec.default_params, cfg,
                                  eps, SAMPLES, num_gradient, HORIZON,
                                  INTERP)


def _check_sg(new, info, jnew, jinfo):
  assert int(info['winner']) == int(jinfo['winner'])
  for k in ('best_return', 'nominal_return', 'improvement'):
    _close(info[k], jinfo[k], k)
  _close(new.policy.values, jnew.policy.values, 'values')
  _close(new.gradient, jnew.gradient, 'gradient')
  _close(new.gradient_prev, jnew.gradient_prev, 'gradient_prev')


@pytest.mark.parametrize('num_gradient', [1, 4])
def test_sample_gradient_optimize_matches_jax(cart, jax_opt, num_gradient):
  """num_gradient 1 takes logspace's one-point case (its start value)."""
  jspec, _, spec, d0 = cart
  jstate, state = _sg_states(jspec, spec, 6)
  key = jax.random.key(7)
  jnew, jinfo = jax_opt[num_gradient](jstate, key=key)
  new, info = _run_sg(spec, d0, state, key, num_gradient)
  _check_sg(new, info, jnew, jinfo)
  assert info['returns'].shape == (SAMPLES,)
  assert float(info['best_return']) <= float(info['nominal_return'])


def test_convert_continues_a_jax_sample_gradient_state(cart, jax_opt):
  jspec, _, spec, d0 = cart
  jstate, _ = _sg_states(jspec, spec, 6)
  for k in (8, 9):
    jstate, _ = jax_opt[4](jstate, key=jax.random.key(k))
  state = convert.sg_state_from_arrays(
      {'times': jstate.policy.times, 'values': jstate.policy.values},
      jstate.gradient, jstate.gradient_prev, device='cpu', dtype=F64)
  key = jax.random.key(10)
  jnew, jinfo = jax_opt[4](jstate, key=key)
  new, info = _run_sg(spec, d0, state, key, 4)
  _check_sg(new, info, jnew, jinfo)


# ---------------------------------------------------------------------------
# ranked delegates and Robust
# ---------------------------------------------------------------------------

DELEGATES = {planners.SAMPLING: 'Sampling', planners.CEM: 'Cross Entropy',
             planners.SAMPLE_GRADIENT: 'Sample Gradient'}


def _delegates(cart, delegate_id):
  """(JAX delegate, its state, the port's delegate, its state), each
  from a non-default state (random plan, variance, gradients)."""
  jspec, _, spec, _ = cart
  ng = planners.num_gradient_candidates(SAMPLES)
  if delegate_id == planners.CEM:
    jd = jranked.make_cem_delegate(
        jspec, jcem.default_config(jspec, dtype=jnp.float64), SAMPLES, POINTS,
        HORIZON, INTERP, dtype=jnp.float64)
    d = ranked.make_cem_delegate(spec, cross_entropy.default_config(spec),
                                 SAMPLES, POINTS, HORIZON, INTERP)
    jpol, pol = _policies(jspec, spec, 8)
    var = np.random.default_rng(9).uniform(0.01, 0.3, (POINTS, 1))
    return (jd, jcem.CEMState(policy=jpol, variance=jnp.asarray(var)), d,
            cross_entropy.CEMState(policy=pol, variance=torch.from_numpy(var)))
  if delegate_id == planners.SAMPLE_GRADIENT:
    jd = jranked.make_sample_gradient_delegate(
        jspec, jsg.default_config(jspec, dtype=jnp.float64), SAMPLES, ng,
        POINTS, HORIZON, INTERP, dtype=jnp.float64)
    d = ranked.make_sample_gradient_delegate(
        spec, sample_gradient.default_config(spec), SAMPLES, ng, POINTS,
        HORIZON, INTERP)
    return (jd,) + _sg_states(jspec, spec, 11)[:1] + (d,) + _sg_states(
        jspec, spec, 11)[1:]
  jd = jranked.make_sampling_delegate(
      jspec, jsampling.default_config(jspec, dtype=jnp.float64), SAMPLES,
      POINTS, HORIZON, INTERP, dtype=jnp.float64)
  d = ranked.make_sampling_delegate(spec, sampling.default_config(spec),
                                    SAMPLES, POINTS, HORIZON, INTERP)
  jpol, pol = _policies(jspec, spec, 12)
  return jd, jpol, d, pol


def _state_leaves(state):
  """The tensors of a planner state, by dotted field name."""
  if isinstance(state, torch.Tensor) or not dataclasses.is_dataclass(state):
    return {'': state}
  out = {}
  for f in dataclasses.fields(state):
    for k, v in _state_leaves(getattr(state, f.name)).items():
      out[f.name + ('.' + k if k else '')] = v
  return out


def _check_states(got, want, what):
  for k, v in _state_leaves(got).items():
    w = want
    for part in filter(None, k.split('.')):
      w = getattr(w, part)
    _close(v, w, f'{what} {k}')


@pytest.fixture(scope='module')
def jax_ranked(cart):
  """delegate id -> JAX's (ranked candidates from key 13, select(2) of
  them, Robust's new state and info from key 17), one jit a delegate."""
  jspec, jd0, _, _ = cart
  jrcfg = jrobust.default_config(jspec, dtype=jnp.float64)
  out = {}

  def get(delegate_id):
    if delegate_id not in out:
      jd, jstate, _, _ = _delegates(cart, delegate_id)

      def run(s, k_rank, k_robust):
        rc = jd.optimize_candidates(s, jd0, jspec.default_params, k_rank,
                                    NCAND)
        return (rc, jd.select(rc, 2)) + jrobust.optimize_ranked(
            jspec, jd, s, jd0, jspec.default_params, jrcfg, k_robust, NCAND,
            NREP, HORIZON, INTERP)
      out[delegate_id] = jax.jit(run)(jstate, jax.random.key(13),
                                      jax.random.key(17))
    return out[delegate_id]
  return get


@pytest.mark.parametrize('delegate_id', list(DELEGATES))
def test_ranked_delegate_matches_jax(cart, jax_ranked, delegate_id):
  _, _, spec, d0 = cart
  _, _, d, state = _delegates(cart, delegate_id)
  key = jax.random.key(13)
  jrc, jselect, _, _ = jax_ranked(delegate_id)
  rc = d.optimize_candidates(state, d0, spec.default_params,
                             delegate_noise(delegate_id, key, SAMPLES), NCAND)
  _close(rc.times, jrc.times, 'times')
  _close(rc.values, jrc.values, 'values')
  _close(rc.scores, jrc.scores, 'scores')
  assert bool(torch.all(rc.scores[1:] >= rc.scores[:-1]))
  for got, want in zip(jax.tree.leaves(rc.aux), jax.tree.leaves(jrc.aux)):
    _close(got, want, 'aux')
  _check_states(d.select(rc, torch.tensor(2)), jselect, 'select(2)')


@pytest.mark.parametrize('delegate_id', list(DELEGATES))
def test_robust_optimize_ranked_matches_jax(cart, jax_ranked, delegate_id):
  _, _, spec, d0 = cart
  _, _, d, state = _delegates(cart, delegate_id)
  key = jax.random.key(17)
  _, _, jnew, jinfo = jax_ranked(delegate_id)
  k_sample, k_noise = jax.random.split(key)
  noise = (delegate_noise(delegate_id, k_sample, SAMPLES),
           xfrc_noise(jax.random.split(k_noise, NCAND * NREP),
                      spec.model.nbody))
  new, info = robust.optimize_ranked(spec, d, state, d0, spec.default_params,
                                     robust.default_config(spec), noise,
                                     NCAND, NREP, HORIZON, INTERP)
  assert int(info['winner']) == int(jinfo['winner'])
  for k in ('best_return', 'best_robust_score', 'nominal_return'):
    _close(info[k], jinfo[k], k)
  _check_states(new, jnew, 'new state')


def test_robust_over_sampling_and_the_delegate_key(cart):
  """robust.optimize (Robust over Sampling) is optimize_ranked over the
  Sampling delegate; make_planner's robust_delegate numeric picks the
  delegate as JAX's does (0 Sampling, 5 Cross Entropy, 6 Sample
  Gradient)."""
  jspec, _, spec, d0 = cart
  _, pol = _policies(jspec, spec, 12)
  gen = torch.Generator().manual_seed(3)
  scfg = sampling.default_config(spec)
  d = ranked.make_sampling_delegate(spec, scfg, SAMPLES, POINTS, HORIZON,
                                    INTERP)
  noise = robust.sample_noise(spec, d, NCAND, NREP, HORIZON, gen)
  assert noise[1].shape == (NCAND * NREP, HORIZON, spec.model.nbody, 6)
  rcfg = robust.default_config(spec)
  a, ia = robust.optimize(spec, pol, d0, spec.default_params, scfg, rcfg,
                          noise, SAMPLES, NCAND, NREP, HORIZON, INTERP)
  b, ib = robust.optimize_ranked(spec, d, pol, d0, spec.default_params,
                                 rcfg, noise, NCAND, NREP, HORIZON, INTERP)
  assert torch.equal(a.values, b.values)
  assert float(ia['best_robust_score']) == float(ib['best_robust_score'])

  want = {0: jsampling.SamplingPolicy, 5: jcem.CEMState, 6: jsg.SGState}
  got = {0: sampling.SamplingPolicy, 5: cross_entropy.CEMState,
         6: sample_gradient.SGState}
  for key, cls in got.items():
    jp = jplanners.make_planner(dataclasses.replace(
        jspec, config={**jspec.config, 'robust_delegate': key}),
        jplanners.ROBUST, 8, HORIZON, POINTS)
    p = planners.make_planner(dataclasses.replace(
        spec, config={**spec.config, 'robust_delegate': key}),
        planners.ROBUST, 8, HORIZON, POINTS)
    assert isinstance(jp.init(), want[key])
    state = p.init()
    assert isinstance(state, cls)
    new, info = p.optimize(state, d0, spec.default_params, gen)
    assert isinstance(new, cls) and bool(torch.isfinite(
        info['best_robust_score']))


# ---------------------------------------------------------------------------
# tie order and the NES weights
# ---------------------------------------------------------------------------

# ties among equal returns, diverged rollouts (MAX_RETURN_VALUE) and a
# clipped pair
TIED = np.array([3.0, 1.0, 1.0e6, 1.0, 1.0e6, 0.5, 1.0, 1.0e6, 0.5, 2.0,
                 1.0e6, 3.0])


@pytest.mark.parametrize('n', [1, 4, 7, 12])
def test_rank_tie_order_matches_top_k(n):
  scores, idx = ranked._rank(torch.from_numpy(TIED), n)
  jscores, jidx = jranked._rank(jnp.asarray(TIED), n)
  np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
  np.testing.assert_array_equal(scores.numpy(), np.asarray(jscores))
  cscores, cidx = cross_entropy.elites(torch.from_numpy(TIED), n)
  np.testing.assert_array_equal(cidx.numpy(), np.asarray(jidx))


def test_sample_gradient_tie_order_matches_argsort():
  """fit_gradient's ranks on tied returns: the JAX lines
  (sample_gradient.py:119-124) with jnp.argsort."""
  num_noisy = 9          # the first 9 returns are the noisy candidates'
  noise = np.random.default_rng(14).normal(size=(num_noisy - 1, POINTS, 2))
  got = sample_gradient.fit_gradient(torch.from_numpy(TIED),
                                     torch.from_numpy(noise))
  noisy_noise = jnp.concatenate([jnp.zeros((1, POINTS, 2)),
                                 jnp.asarray(noise)])
  order = jnp.argsort(jnp.asarray(TIED)[:num_noisy])
  want = jnp.einsum('i,ipk->pk', jsg._fitness_weights(num_noisy, jnp.float64),
                    noisy_noise[order]) / num_noisy
  np.testing.assert_array_equal(
      np.argsort(TIED[:num_noisy], kind='stable'), np.asarray(order))
  _close(got, want, 'gradient', rtol=1e-14)


@pytest.mark.parametrize('n', [1, 2, 5, 16, 8184])
def test_fitness_weights_exactly(n):
  np.testing.assert_array_equal(sample_gradient._fitness_weights(n),
                                np.asarray(jsg._fitness_weights(
                                    n, jnp.float64)))
