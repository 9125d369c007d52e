"""The Humanoid slice of the port against the JAX package, float64.

Humanoid Track, Stand and Walk share models/humanoid.xml (nv 23, a free
torso, 17 limited hinges, 7 floor pairs: 4 capsules, a sphere and 2
boxes). Both packages get the same compiled task (the JAX task's model
and parameters cast to float64; the port loads its snapshot in float64)
and the same states, made with numpy.

One jitted JAX step of Humanoid Track (forward, residual, cost, Euler)
is the reference for everything Track does here, so the JAX side
compiles once. It is jitted per sample and called once a sample: under
vmap JAX traces the Newton solve and every unrolled SPD solve a second
time (custom_vmap's rule beside the plain body), which took ~45 s more
to trace and compile on a CPU than the ~65 s of the unbatched step.
* forward and step from states around `home` (the clip's first pose)
  with contacts and joint limits active: kinematics of the free-joint
  tree, qacc, qfrc_constraint, then qpos and qvel after the step;
* the residual and the cost at those states, at times across the clip
  and past its end, with the clip time shifted by `_ref_time`;
* one sampling.optimize of the port (8 candidates + the nominal, 3 steps)
  against the JAX step rolled out over the same candidates: the same
  returns and the same winner;
* the transition (eager JAX) with and without a rewind of the time, and
  inside synchronous MPC;
* Stand and Walk residuals against one jitted JAX position/velocity pass
  of humanoid.xml.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu.physics import forward as jfwd
from mujoco_mpc_tpu.physics.model import make_data as jmake_data
from mujoco_mpc_tpu.planners import rollout as jrollout
from mujoco_mpc_tpu.planners import sampling as jsampling
from mujoco_mpc_tpu.tasks import registry as jregistry
from mujoco_mpc_tpu_torch import agent
from mujoco_mpc_tpu_torch import convert
from mujoco_mpc_tpu_torch.ops import spline
from mujoco_mpc_tpu_torch.physics import constraint
from mujoco_mpc_tpu_torch.physics import forward as fwd
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
  """(JAX spec, its model and params in f64, the JAX step over a batch of
  numpy states, the port's spec in f64)."""
  jspec = jregistry.get_task('Humanoid Track')
  jm, jparams = _f64(jspec.model), _f64(jspec.default_params)
  jd0 = jmake_data(jm, dtype=jnp.float64)

  @jax.jit
  def one(t, q, v, u, rp):
    d = jfwd.forward(jm, jd0.replace(time=t, qpos=q, qvel=v, ctrl=u))
    res = jspec.residual_fn(jm, d, rp)
    d2 = jfwd.integrate(jm, d)
    out = {k: getattr(d, k) for k in KINEMATICS + ('qacc',
                                                   'qfrc_constraint')}
    out.update(residual=res,
               cost=jspec.cost(res, jparams.replace(residual_params=rp)),
               time=d2.time, qpos=d2.qpos, qvel=d2.qvel)
    return out

  def step(t, q, v, u, rp=None):
    rp = jparams.residual_params if rp is None else jnp.asarray(rp)
    outs = [one(*(jnp.asarray(x[i]) for x in (t, q, v, u)), rp)
            for i in range(len(t))]
    return {k: np.stack([np.asarray(o[k]) for o in outs]) for k in outs[0]}

  spec = registry.get_task('Humanoid Track', device='cpu',
                           dtype=torch.float64)
  return jspec, jm, jparams, step, spec


def _states(spec, seed):
  """NSAMPLE states around `home`: the torso lowered by 0.2-0.6 m (the
  clip's first pose holds the feet ~0.2 m above the floor) and tilted, so
  that feet and shins reach into the floor, hinges spread by 0.4 rad (some
  past their limits), random velocities and controls, and times across
  the 12 s clip and past its end (the last frame holds)."""
  rng = np.random.default_rng(seed)
  home = spec.model.keyframe_qpos('home').numpy()
  qpos = np.tile(home, (NSAMPLE, 1))
  qpos[:, 2] -= rng.uniform(0.2, 0.6, NSAMPLE)
  quat = qpos[:, 3:7] + rng.normal(scale=0.1, size=(NSAMPLE, 4))
  qpos[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
  qpos[:, 7:] += rng.normal(scale=0.4, size=(NSAMPLE, 17))
  qpos[0, 12] = 2.9                 # the right knee past its 160 degrees
  qvel = rng.normal(scale=0.5, size=(NSAMPLE, spec.model.nv))
  ctrl = rng.normal(scale=0.3, size=(NSAMPLE, spec.model.nu))
  time = rng.uniform(0.0, 12.5, NSAMPLE)
  time[1] = 13.0
  return time, qpos, qvel, ctrl


def _params(spec, ref_time):
  rp = spec.default_params.residual_params.numpy().copy()
  rp[spec.residual_param_names.index('_ref_time')] = ref_time
  return rp


@pytest.fixture(scope='module')
def stepped(tasks):
  """(JAX step outputs, the port's forward Data, residual, cost, and
  stepped Data) at _states, the clip time shifted by 0.4 s."""
  _, _, _, jstep, spec = tasks
  state = _states(spec, 0)
  rp = _params(spec, 0.4)
  want = jstep(*state, rp)
  m = spec.model
  p = spec.default_params.replace(residual_params=torch.from_numpy(rp))
  t, q, v, u = (torch.from_numpy(x) for x in state)
  d = fwd.forward(m, make_data(m, NSAMPLE).replace(time=t, qpos=q, qvel=v,
                                                    ctrl=u))
  res = spec.residual_fn(m, d, p.residual_params)
  return want, d, res, spec.cost(res, p), fwd.integrate(m, d)


def _close(got, want, name, rtol=1e-9, atol=1e-9):
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                             atol=atol, err_msg=name)


def test_track_home_is_the_clips_first_pose(tasks):
  """The Track model's `home` key, patched by JAX to the clip's first
  pose, travels with the snapshot's model."""
  spec = tasks[-1]
  np.testing.assert_array_equal(
      spec.model.keyframe_qpos('home').numpy(),
      np.asarray(jregistry._track_clip_qpos()[0], np.float32))


def test_forward_and_step(tasks, stepped):
  want, d, _, _, d2 = stepped
  m = tasks[-1].model
  # every sample has a constraint force; most have floor contacts and
  # joints past their limits
  assert (np.abs(d.qfrc_constraint.numpy()) > 1e-3).any(1).all()
  points = constraint.make_rows_split(m, d)[2]
  assert (points[0].dvec > 0).any(1).sum() >= NSAMPLE // 2
  q = d.qpos.numpy()[:, 7:]
  rng = m.jnt_range.numpy()[1:]
  assert ((q < rng[:, 0]) | (q > rng[:, 1])).any(1).sum() >= NSAMPLE // 2
  # f64, the same formulas: kinematics to rounding
  for k in KINEMATICS:
    _close(getattr(d, k), want[k], k, atol=1e-10)
  # f64 Newton to tol 1e-8 in both (capped at the model's 6 iterations,
  # the same iterations); qacc reaches ~1e3 in contact
  _close(d.qacc, want['qacc'], 'qacc', rtol=1e-7, atol=1e-5)
  _close(d.qfrc_constraint, want['qfrc_constraint'], 'qfrc_constraint',
         rtol=1e-7, atol=1e-5)
  # Euler with the implicit joint damping (B1's second solve)
  for k in ('qpos', 'qvel', 'time'):
    _close(getattr(d2, k), want[k], k, rtol=1e-8, atol=1e-8)


def test_residual_and_cost(stepped):
  want, _, res, cost, _ = stepped
  # f32-rounded markers promoted to f64 in both; the rest to rounding
  _close(res, want['residual'], 'residual', rtol=1e-8, atol=1e-8)
  _close(cost, want['cost'], 'cost', rtol=1e-8, atol=1e-8)


def test_optimize_matches_jax_rollouts(tasks):
  """The slice: resample, candidates, knots -> actions, rollouts of the
  contact physics (B1, B2 plain versions), residuals, costs, argmin."""
  _, _, _, jstep, spec = tasks
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


@pytest.mark.parametrize('last_time,rewound', [(0.5, False), (2.0, True)])
def test_transition(tasks, last_time, rewound):
  """At time 1.0 with the clip started at 0.25: the clip time restarts
  only when the time went back past `_last_time`; both stamp the time."""
  jspec, jm, jparams, _, spec = tasks
  names = spec.residual_param_names
  rp = _params(spec, 0.25)
  rp[names.index('_last_time')] = last_time
  jd = jmake_data(jm, dtype=jnp.float64).replace(time=jnp.asarray(1.0))
  _, jp2 = jspec.transition_fn(
      jm, jd, jparams.replace(residual_params=jnp.asarray(rp)),
      jax.random.key(0))
  m = spec.model
  d = make_data(m).replace(time=torch.tensor([1.0], dtype=torch.float64))
  d2, p2 = spec.transition_fn(
      m, d, spec.default_params.replace(residual_params=torch.from_numpy(rp)),
      torch.Generator())
  assert d2 is d
  _close(p2.residual_params, jp2.residual_params, 'residual_params',
         rtol=0, atol=0)
  assert float(p2.residual_params[names.index('_ref_time')]) == (
      1.0 if rewound else 0.25)
  assert float(p2.residual_params[names.index('_last_time')]) == 1.0


def test_synchronous_mpc_restarts_the_clip_only_on_a_rewind(tasks):
  """Three plans of a 3-step horizon, one simulation step each, from a
  state at time 0 whose parameters saw time 2 (a reset): the first
  transition restarts the clip at 0, the next two only stamp the time
  (the zero-filled state the agent hands over keeps its time)."""
  spec = tasks[-1]
  spec = dataclasses.replace(spec, config={**spec.config,
                                           'agent_horizon': 0.04})
  m = spec.model
  names = spec.residual_param_names
  rp = _params(spec, 1.5)
  rp[names.index('_last_time')] = 2.0
  carry, costs = agent.synchronous_mpc(
      spec, 4, total_steps=3, steps_per_plan=1,
      generator=torch.Generator().manual_seed(0),
      sim0=make_data(m).replace(qpos=m.keyframe_qpos('home')[None]),
      params=spec.default_params.replace(
          residual_params=torch.from_numpy(rp)))
  assert costs.shape == (3,) and torch.isfinite(costs).all()
  out = carry.params.residual_params
  assert float(out[names.index('_ref_time')]) == 0.0
  # the third plan's transition stamps the time of its state: 2 steps
  assert float(out[names.index('_last_time')]) == pytest.approx(
      2 * float(m.opt.timestep))


def test_cmu_snapshot_is_refused(tasks):
  """A snapshot with marker sites (the CMU branch) names the clip files
  it waits for."""
  spec = tasks[-1]
  arrays, _ = convert.load_snapshot(
      f'{registry.ASSETS}/{registry.TASKS["Humanoid Track"][0]}')
  task = convert.group(arrays, 'task/')
  assert 'marker_sites' not in task
  with pytest.raises(NotImplementedError, match='CMU clip files'):
    registry._humanoid_track(spec, {**task,
                                    'marker_sites': np.arange(16)})


@pytest.fixture(scope='module')
def stand_walk():
  """The JAX Stand and Walk specs in f64 and one jitted, vmapped position
  and velocity pass of humanoid.xml that gives both residuals."""
  specs = [jregistry.get_task(n) for n in ('Humanoid Stand', 'Humanoid Walk')]
  jm = _f64(specs[0].model)
  jd0 = jmake_data(jm, dtype=jnp.float64)

  def one(q, v, u, rps):
    d = jd0.replace(qpos=q, qvel=v, ctrl=u)
    d = jfwd.fwd_velocity(jm, jfwd.fwd_position(jm, d))
    return [s.residual_fn(jm, d, rp) for s, rp in zip(specs, rps)]

  return specs, jax.jit(jax.vmap(one, in_axes=(0, 0, 0, None)))


@pytest.mark.parametrize('name', ['Humanoid Stand', 'Humanoid Walk'])
def test_stand_and_walk_residuals(tasks, stand_walk, name):
  """The Height, Balance, CoM Vel., Joint Vel., Control and Upright terms
  and the cost at the Track states (the same body tree), a speed goal of
  0.7 for Walk."""
  jspecs, jpass = stand_walk
  spec = registry.get_task(name, device='cpu', dtype=torch.float64)
  assert spec.transition_fn is None
  _, qpos, qvel, ctrl = _states(tasks[-1], 1)
  rps = [np.asarray(s.default_params.residual_params, np.float64)
         for s in jspecs]
  rps[1][1] = 0.7
  k = ('Humanoid Stand', 'Humanoid Walk').index(name)
  want = np.asarray(jpass(qpos, qvel, ctrl, [jnp.asarray(r) for r in rps])[k])
  m = spec.model
  d = make_data(m, NSAMPLE).replace(qpos=torch.from_numpy(qpos),
                                    qvel=torch.from_numpy(qvel),
                                    ctrl=torch.from_numpy(ctrl))
  d = fwd.fwd_velocity(m, fwd.fwd_position(m, d))
  rp = torch.from_numpy(rps[k])
  res = spec.residual_fn(m, d, rp)
  # f64, the same formulas: to rounding
  _close(res, want, 'residual', rtol=1e-9, atol=1e-10)
  jp = _f64(jspecs[k].default_params).replace(residual_params=jnp.asarray(
      rps[k]))
  _close(spec.cost(res, spec.default_params.replace(residual_params=rp)),
         jax.vmap(lambda r: jspecs[k].cost(r, jp))(jnp.asarray(want)),
         'cost', rtol=1e-9, atol=1e-10)
