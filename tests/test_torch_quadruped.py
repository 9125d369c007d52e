"""The Quadruped Flat slice of the port against the JAX package, float64.

Both packages get the same compiled task (the JAX task's model and
parameters cast to float64; the port loads its snapshot in float64) and
the same states, made with numpy. One jitted JAX step (forward, residual,
cost, Euler), vmapped over 9 samples, is the reference for everything
here, so the JAX side compiles once:
* forward and step from 9 states around `home` with contacts and joint
  limits active: kinematics of the free-joint tree, qacc,
  qfrc_constraint, then qpos and qvel after the step;
* the residual and the cost at those states;
* one sampling.optimize of the port (8 candidates + the nominal, 3 steps)
  against the JAX step rolled out over the same candidate tensor: the
  same returns and the same winner;
* the transition (unbatched, eager JAX) where its random goal draw does
  not fire, and where it fires with the port's draw handed to JAX.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu.physics import forward as jfwd
from mujoco_mpc_tpu.physics import kinematics as jkin
from mujoco_mpc_tpu.physics.model import make_data as jmake_data
from mujoco_mpc_tpu.planners import rollout as jrollout
from mujoco_mpc_tpu.planners import sampling as jsampling
from mujoco_mpc_tpu.tasks import registry as jregistry
from mujoco_mpc_tpu_torch import agent
from mujoco_mpc_tpu_torch.ops import spline
from mujoco_mpc_tpu_torch.physics import forward as fwd
from mujoco_mpc_tpu_torch.physics import kinematics as kin
from mujoco_mpc_tpu_torch.physics.model import make_data
from mujoco_mpc_tpu_torch.planners import sampling
from mujoco_mpc_tpu_torch.tasks import registry

torch.set_num_threads(1)

NSAMPLE = 9               # 8 candidates + the nominal
HORIZON = 3
KINEMATICS = ('xpos', 'xquat', 'geom_xpos', 'geom_xmat', 'site_xpos',
              'subtree_com', 'cdof', 'cvel')


def _f64(tree):
  return jax.tree.map(
      lambda x: x.astype(jnp.float64)
      if jnp.issubdtype(getattr(x, 'dtype', np.int32), jnp.floating) else x,
      tree)


@pytest.fixture(scope='module')
def tasks():
  """(JAX spec, its model and params in f64, a jitted vmapped JAX step,
  the port's spec in f64)."""
  jspec = jregistry.get_task('Quadruped Flat')
  jm, jparams = _f64(jspec.model), _f64(jspec.default_params)
  jd0 = jmake_data(jm, dtype=jnp.float64)

  def one(t, q, v, u):
    d = jfwd.forward(jm, jd0.replace(time=t, qpos=q, qvel=v, ctrl=u))
    res = jspec.residual_fn(jm, d, jparams.residual_params)
    d2 = jfwd.integrate(jm, d)
    out = {k: getattr(d, k) for k in KINEMATICS + ('qacc',
                                                   'qfrc_constraint')}
    out.update(residual=res, cost=jspec.cost(res, jparams), time=d2.time,
               qpos=d2.qpos, qvel=d2.qvel)
    return out

  spec = registry.get_task('Quadruped Flat', device='cpu',
                           dtype=torch.float64)
  return jspec, jm, jparams, jax.jit(jax.vmap(one)), spec


@pytest.fixture(scope='module')
def jax_kinematics(tasks):
  """Jitted JAX kinematics, com and com velocities of one state."""
  jm = tasks[1]
  return jax.jit(lambda d: jkin.com_vel(jm, jkin.com_pos(
      jm, jkin.kinematics(jm, d))))


def _states(spec, seed):
  """NSAMPLE states around `home`: the trunk lowered into the floor,
  joints spread (one thigh past its limit), random velocities and
  controls."""
  rng = np.random.default_rng(seed)
  home = spec.model.keyframe_qpos('home').numpy()
  qpos = np.tile(home, (NSAMPLE, 1))
  qpos[:, 2] -= rng.uniform(0.0, 0.06, NSAMPLE)
  qpos[:, 7:] += rng.normal(scale=0.35, size=(NSAMPLE, 12))
  qpos[0, 8] = 1.7
  qvel = rng.normal(scale=0.5, size=(NSAMPLE, spec.model.nv))
  ctrl = rng.normal(scale=0.3, size=(NSAMPLE, spec.model.nu))
  return np.zeros(NSAMPLE), qpos, qvel, ctrl


@pytest.fixture(scope='module')
def stepped(tasks):
  """(JAX step outputs, the port's forward Data, residual, cost, and
  stepped Data) at _states."""
  _, _, _, jstep, spec = tasks
  state = _states(spec, 0)
  want = jstep(*(jnp.asarray(x) for x in state))
  m, p = spec.model, spec.default_params
  t, q, v, u = (torch.from_numpy(x) for x in state)
  d = fwd.forward(m, make_data(m, NSAMPLE).replace(time=t, qpos=q, qvel=v,
                                                    ctrl=u))
  res = spec.residual_fn(m, d, p.residual_params)
  return want, d, res, spec.cost(res, p), fwd.integrate(m, d)


def _close(got, want, name, rtol=1e-9, atol=1e-9):
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                             atol=atol, err_msg=name)


def test_forward_and_step(stepped):
  want, d, _, _, d2 = stepped
  # f64, the same formulas: kinematics to rounding
  for k in KINEMATICS:
    _close(getattr(d, k), want[k], k, atol=1e-10)
  # f64 Newton to tol 1e-8 in both (capped at the model's 6 iterations,
  # the same iterations); qacc reaches ~1e3 in contact
  _close(d.qacc, want['qacc'], 'qacc', rtol=1e-7, atol=1e-6)
  _close(d.qfrc_constraint, want['qfrc_constraint'], 'qfrc_constraint',
         rtol=1e-7, atol=1e-6)
  for k in ('qpos', 'qvel', 'time'):
    _close(getattr(d2, k), want[k], k, rtol=1e-8, atol=1e-8)


def test_residual_and_cost(stepped):
  want, _, res, cost, _ = stepped
  _close(res, want['residual'], 'residual', rtol=1e-8, atol=1e-8)
  _close(cost, want['cost'], 'cost', rtol=1e-8, atol=1e-8)


def test_optimize_matches_jax_rollouts(tasks):
  """The slice: resample, candidates, knots -> actions, rollouts of the
  contact physics (B1, B2 plain versions), residuals, costs, argmin."""
  jspec, _, _, jstep, spec = tasks
  interp = int(spline.Interp.ZERO)
  rng = np.random.default_rng(11)
  m = spec.model
  d0 = make_data(m).replace(qpos=m.keyframe_qpos('home')[None])
  cfg = sampling.default_config(spec)
  pol = sampling.SamplingPolicy(
      torch.linspace(0.0, 1.0, 10, dtype=torch.float64),
      torch.from_numpy(rng.uniform(-0.5, 0.5, (10, m.nu))))
  eps = torch.from_numpy(rng.normal(size=(NSAMPLE - 1, 10, m.nu)))
  use2 = torch.from_numpy(rng.uniform(size=NSAMPLE - 1) < 0.2)
  new, info = sampling.optimize(spec, pol, d0, spec.default_params, cfg,
                                (eps, use2), HORIZON, interp)

  nominal = sampling.resample_nominal(spec, pol, d0.time[0], HORIZON, cfg,
                                      interp)
  cands = sampling.candidates_from_noise(spec, nominal, eps, use2, cfg)
  times = jnp.asarray(nominal.times.numpy())
  acts = np.asarray(jax.vmap(lambda vals: jsampling.candidate_actions(
      times, vals, HORIZON, float(cfg.timestep), interp))(
          jnp.asarray(cands.numpy())))
  t, q = np.zeros(NSAMPLE), np.tile(d0.qpos.numpy(), (NSAMPLE, 1))
  v = np.zeros((NSAMPLE, m.nv))
  costs = []
  for k in range(HORIZON):
    out = jstep(t, q, v, acts[:, k])
    costs.append(out['cost'])
    t, q, v = out['time'], out['qpos'], out['qvel']
  want = np.asarray(jrollout.total_return(jnp.stack(costs, -1)))

  np.testing.assert_allclose(info['returns'].numpy(), want, rtol=1e-8)
  assert int(info['winner']) == int(np.argmin(want))
  assert float(info['best_return']) <= float(info['nominal_return'])
  np.testing.assert_array_equal(new.values.numpy(),
                                cands[int(info['winner'])].numpy())


def _transition_inputs(tasks, jax_kinematics, mode, goal_xy,
                       walk_turn=0.0):
  """The same B = 1 state after kinematics and com velocities in both
  packages, and parameters in `mode` with the gait switch on."""
  jspec, jm, jparams, _, spec = tasks
  m = spec.model
  names = spec.residual_param_names
  rng = np.random.default_rng(mode)
  qpos = m.keyframe_qpos('home').numpy().copy()
  qpos[:2] = (0.3, -0.2)
  qpos[7:] += rng.normal(scale=0.2, size=12)
  qvel = rng.normal(scale=0.8, size=m.nv)
  mocap = m.body_pos[m.body('goal')].numpy()[None].copy()
  mocap[0, :2] = goal_xy
  rp = spec.default_params.residual_params.numpy().copy()
  rp[names.index('select_Mode')] = mode
  rp[names.index('select_Gait switch')] = 1.0
  rp[names.index('Walk turn')] = walk_turn
  rp[names.index('_last_t')] = 0.3
  time = 1.7

  jd = jmake_data(jm, dtype=jnp.float64).replace(
      time=jnp.asarray(time), qpos=jnp.asarray(qpos),
      qvel=jnp.asarray(qvel), mocap_pos=jnp.asarray(mocap))
  jd = jax_kinematics(jd)
  d = make_data(m).replace(
      time=torch.tensor([time], dtype=torch.float64),
      qpos=torch.from_numpy(qpos)[None], qvel=torch.from_numpy(qvel)[None],
      mocap_pos=torch.from_numpy(mocap)[None])
  d = kin.com_vel(m, kin.com_pos(m, kin.kinematics(m, d)))
  return (jm, jd, jparams.replace(residual_params=jnp.asarray(rp)), d,
          spec.default_params.replace(residual_params=torch.from_numpy(rp)))


def _compare_transition(tasks, inputs, generator, draw=None,
                        monkeypatch=None):
  jspec, _, _, _, spec = tasks
  jm, jd, jparams, d, params = inputs
  if draw is not None:
    monkeypatch.setattr(jax.random, 'uniform',
                        lambda *a, **k: jnp.asarray(draw.numpy()))
  jd2, jp2 = jspec.transition_fn(jm, jd, jparams, jax.random.key(0))
  d2, p2 = spec.transition_fn(spec.model, d, params, generator)
  _close(p2.residual_params, jp2.residual_params, 'residual_params',
         rtol=1e-10, atol=1e-12)
  _close(p2.weights, jp2.weights, 'weights', rtol=1e-12, atol=0)
  _close(d2.mocap_pos[0], jd2.mocap_pos, 'mocap_pos', rtol=1e-10,
         atol=1e-12)
  return d2, p2


@pytest.mark.parametrize('mode', [0, 2, 4])
def test_transition_without_the_draw(tasks, jax_kinematics, mode):
  """Quadruped mode with the goal far away (no draw), Walk on a circle
  and Flip entered: gait switching, presets and the entry snapshots."""
  inputs = _transition_inputs(tasks, jax_kinematics, mode, (2.5, 2.0),
                              walk_turn=0.4 if mode == 2 else 0.0)
  d2, _ = _compare_transition(tasks, inputs, torch.Generator())
  if mode != 2:
    np.testing.assert_array_equal(d2.mocap_pos.numpy(),
                                  inputs[3].mocap_pos.numpy())


def test_transition_with_the_draw_handed_in(tasks, jax_kinematics,
                                           monkeypatch):
  """The goal is reached in Quadruped mode: a new goal is drawn from the
  generator; JAX gets the same draw in place of jax.random.uniform."""
  inputs = _transition_inputs(tasks, jax_kinematics, 0, (0.35, -0.25))
  draw = torch.rand((2,), generator=torch.Generator().manual_seed(5),
                    dtype=torch.float64) * 6.0 - 3.0
  d2, _ = _compare_transition(tasks, inputs,
                              torch.Generator().manual_seed(5), draw,
                              monkeypatch)
  np.testing.assert_array_equal(d2.mocap_pos[0, 0, :2].numpy(),
                                draw.numpy())


def test_first_plan_from_a_fresh_state_matches_jax(tasks):
  """One plan of synchronous MPC from make_data at `home`, moving, with
  Flip selected: its transition sees the zero-filled derived fields of
  JAX's make_data (no com velocity to filter, a zero trunk frame for the
  Flip and Walk entry snapshots), so the parameters and goal it carries on
  equal JAX's transition of JAX's fresh state."""
  jspec, jm, jparams, _, spec = tasks
  spec = dataclasses.replace(spec, config={**spec.config,
                                           'agent_horizon': 0.02})
  m = spec.model
  home = m.keyframe_qpos('home')
  qvel = np.random.default_rng(3).normal(scale=0.8, size=m.nv)
  rp = spec.default_params.residual_params.numpy().copy()
  rp[spec.residual_param_names.index('select_Mode')] = 4
  carry, costs = agent.synchronous_mpc(
      spec, 2, total_steps=1, steps_per_plan=1,
      generator=torch.Generator().manual_seed(0),
      sim0=make_data(m).replace(qpos=home[None],
                                qvel=torch.from_numpy(qvel)[None]),
      params=spec.default_params.replace(
          residual_params=torch.from_numpy(rp)))
  jd = jmake_data(jm, dtype=jnp.float64).replace(
      qpos=jnp.asarray(home.numpy()), qvel=jnp.asarray(qvel))
  jd2, jp2 = jspec.transition_fn(
      jm, jd, jparams.replace(residual_params=jnp.asarray(rp)),
      jax.random.key(0))
  assert torch.isfinite(costs).all()
  _close(carry.params.residual_params, jp2.residual_params,
         'residual_params', rtol=1e-10, atol=1e-12)
  _close(carry.params.weights, jp2.weights, 'weights', rtol=1e-12, atol=0)
  _close(carry.sim.mocap_pos[0], jd2.mocap_pos, 'mocap_pos', rtol=1e-10,
         atol=1e-12)


def test_synchronous_mpc_applies_the_transition(tasks):
  """Two plans of a 6-step horizon, one simulation step each."""
  spec = tasks[-1]
  spec = dataclasses.replace(spec, config={**spec.config,
                                           'agent_horizon': 0.05})
  m = spec.model
  sim0 = make_data(m).replace(qpos=m.keyframe_qpos('home')[None])
  carry, costs = agent.synchronous_mpc(
      spec, 4, total_steps=2, steps_per_plan=1,
      generator=torch.Generator().manual_seed(0), sim0=sim0)
  assert costs.shape == (2,) and torch.isfinite(costs).all()
  last_t = carry.params.residual_params[
      spec.residual_param_names.index('_last_t')]
  # the second plan's transition stamps the time of its state: 1 step
  assert float(last_t) == pytest.approx(float(m.opt.timestep))
