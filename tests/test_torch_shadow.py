"""The Shadow Reorient slice of the port against the JAX package, float64.

Shadow Reorient is the generated hand of models/hands.py (nv 21: a free
cube and 15 limited, damped finger hinges; 15 position actuators) with a
chamfered-mesh cube: 32 condim-3 pairs, the fingertip spheres (sm) and
finger capsules (cm) against the cube's hull as batched clusters, the
floor and the palm against it and 10 fingertip pairs unrolled, one group
of P 57 points. Both packages get the same compiled task (the JAX task's
model and parameters cast to float64; the port loads its snapshot in
float64) and the same states, made with numpy.

One JAX step (forward, the stacked contact points, residual, cost, Euler)
is the reference, jitted per sample and called once a sample, as
tests/test_torch_humanoid.py does (under vmap JAX would trace the Newton
and SPD solves twice).
* forward and step from states around qpos0, the cube lowered into the
  palm and tilted, the fingers spread across and past their ranges:
  kinematics, the stacked contact points in JAX's order (sm, cm, then the
  unclustered pairs in collision_pairs order), qacc, qfrc_constraint,
  then qpos and qvel after the step; sample 0 is qpos0 itself, where 8
  hull vertices tie for the floor's 4 points;
* the residual and the cost at those states;
* one sampling.optimize of the port (8 candidates + the nominal, 3 steps)
  against the JAX step rolled out over the same candidates: the same
  returns and the same winner;
* the transition's solved, dropped and neither branches against JAX's
  (the goal JAX draws with its key is handed to the port's generator).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu.physics import constraint as jconstraint
from mujoco_mpc_tpu.physics import forward as jfwd
from mujoco_mpc_tpu.physics import kinematics as jkin
from mujoco_mpc_tpu.physics.model import make_data as jmake_data
from mujoco_mpc_tpu.planners import rollout as jrollout
from mujoco_mpc_tpu.planners import sampling as jsampling
from mujoco_mpc_tpu.tasks import registry as jregistry
from mujoco_mpc_tpu_torch.ops import spline
from mujoco_mpc_tpu_torch.physics import constraint
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
POINTS = ('pos3', 'dist', 'normal')


def _f64(tree):
  return jax.tree.map(
      lambda x: x.astype(jnp.float64)
      if jnp.issubdtype(getattr(x, 'dtype', np.int32), jnp.floating) else x,
      tree)


@pytest.fixture(scope='module')
def tasks():
  """(JAX spec, its model and params in f64, the JAX step over a batch of
  numpy states, the port's spec in f64)."""
  jspec = jregistry.get_task('Shadow Reorient')
  jm, jparams = _f64(jspec.model), _f64(jspec.default_params)
  jd0 = jmake_data(jm, dtype=jnp.float64)

  @jax.jit
  def one(q, v, u):
    d = jfwd.forward(jm, jd0.replace(qpos=q, qvel=v, ctrl=u))
    groups, _ = jconstraint._contact_groups(jm, d)
    pts = jconstraint._Stacked(groups[3])
    res = jspec.residual_fn(jm, d, jparams.residual_params)
    d2 = jfwd.integrate(jm, d)
    out = {k: getattr(d, k) for k in KINEMATICS + ('qacc',
                                                   'qfrc_constraint')}
    out.update({k: getattr(pts, k) for k in POINTS})
    out.update(residual=res, cost=jspec.cost(res, jparams),
               time=d2.time, qpos=d2.qpos, qvel=d2.qvel)
    return out

  def step(q, v, u):
    outs = [one(*(jnp.asarray(x[i]) for x in (q, v, u)))
            for i in range(len(q))]
    return {k: np.stack([np.asarray(o[k]) for o in outs]) for k in outs[0]}

  spec = registry.get_task('Shadow Reorient', device='cpu',
                           dtype=torch.float64)
  return jspec, jm, jparams, step, spec


def _states(spec, seed):
  """NSAMPLE states around qpos0 (the cube 20 mm above the palm): the
  cube lowered by 20-30 mm, so 0-10 mm into the palm, and tilted by up to
  5 degrees, the hinges spread uniformly over their ranges and 10% past
  each end, random velocities and controls; sample 0 is qpos0 at rest."""
  rng = np.random.default_rng(seed)
  m = spec.model
  qpos = np.tile(m.qpos0.numpy(), (NSAMPLE, 1))
  lo, hi = m.jnt_range.numpy()[1:].T
  span = hi - lo
  qpos[1:, 7:] = rng.uniform(lo - 0.1 * span, hi + 0.1 * span,
                             (NSAMPLE - 1, 15))
  qpos[1:, 2] -= rng.uniform(0.02, 0.03, NSAMPLE - 1)
  axis = rng.normal(size=(NSAMPLE - 1, 3))
  axis /= np.linalg.norm(axis, axis=1, keepdims=True)
  half = 0.5 * rng.uniform(0.0, np.deg2rad(5.0), NSAMPLE - 1)
  qpos[1:, 3:7] = np.concatenate([np.cos(half)[:, None],
                                  np.sin(half)[:, None] * axis], 1)
  qvel = rng.normal(scale=0.3, size=(NSAMPLE, m.nv))
  ctrl = rng.normal(scale=0.5, size=(NSAMPLE, m.nu))
  qvel[0] = ctrl[0] = 0.0
  return qpos, qvel, ctrl


@pytest.fixture(scope='module')
def stepped(tasks):
  """(JAX step outputs, the port's forward Data, stacked points, residual,
  cost, and stepped Data) at _states."""
  _, _, _, jstep, spec = tasks
  state = _states(spec, 0)
  want = jstep(*state)
  m, p = spec.model, spec.default_params
  q, v, u = (torch.from_numpy(x) for x in state)
  d = fwd.forward(m, make_data(m, NSAMPLE).replace(qpos=q, qvel=v, ctrl=u))
  pts = constraint._contact_groups(m, d)[3]
  res = spec.residual_fn(m, d, p.residual_params)
  return want, d, pts, res, spec.cost(res, p), fwd.integrate(m, d)


def _close(got, want, name, rtol=1e-9, atol=1e-9):
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                             atol=atol, err_msg=name)


def test_model_shape(tasks):
  """The slice's shapes: nv 21, 30 one-hot limit rows, one condim-3 group
  of 57 points stacked as JAX stacks them."""
  spec = tasks[-1]
  m = spec.model
  assert (m.nq, m.nv, m.nu, m.opt.iterations) == (22, 21, 15, 8)
  (group,) = m.contact
  assert group.condim == 3 and group.margin.shape == (57,)
  assert [(s.kind, len(s.pairs)) for s in group.sources[:4]] == [
      ('sm', 5), ('cm', 15), ('pair', 1), ('pair', 1)]
  assert [s.pairs[0] for s in group.sources[2:]] == [
      p for p in m.collision_pairs if m.geom_type[p[0]] != 3
      and not (m.geom_type[p[0]] == 2 and m.geom_type[p[1]] == 7)]
  assert len(m.idx.lim_dof2) == 30


def test_forward_and_step(tasks, stepped):
  want, d, pts, _, _, d2 = stepped
  m = tasks[-1].model
  # most samples touch the cube with fingers and palm; some hinges are
  # past their limits
  active = (pts.dist < 0).numpy()
  assert active[1:, :35].any(1).sum() >= NSAMPLE // 2
  assert active[1:, 39:47].any(1).sum() >= NSAMPLE // 2
  q = d.qpos.numpy()[:, 7:]
  rng = m.jnt_range.numpy()[1:]
  assert ((q < rng[:, 0]) | (q > rng[:, 1])).any(1).sum() >= NSAMPLE // 2
  # f64, the same formulas: kinematics and the contact points to rounding,
  # the points in JAX's order (sample 0 on the tie of 8 hull vertices)
  for k in KINEMATICS:
    _close(getattr(d, k), want[k], k, atol=1e-10)
  for k in POINTS:
    _close(getattr(pts, k), want[k], k, atol=1e-10)
  # f64 Newton to tol 1e-8 in both, capped at the model's 8 iterations;
  # qacc reaches ~1e3 in contact
  _close(d.qacc, want['qacc'], 'qacc', rtol=1e-7, atol=1e-5)
  _close(d.qfrc_constraint, want['qfrc_constraint'], 'qfrc_constraint',
         rtol=1e-7, atol=1e-5)
  # Euler with the implicit hinge damping (B1's second solve)
  for k in ('qpos', 'qvel', 'time'):
    _close(getattr(d2, k), want[k], k, rtol=1e-8, atol=1e-8)


def test_residual_and_cost(stepped):
  want, _, _, res, cost, _ = stepped
  _close(res, want['residual'], 'residual', rtol=1e-9, atol=1e-10)
  _close(cost, want['cost'], 'cost', rtol=1e-9, atol=1e-10)


def test_optimize_matches_jax_rollouts(tasks):
  """The slice: resample, candidates, knots -> actions, rollouts of the
  hull contacts (B1, B2 plain versions), residuals, costs, argmin, from
  the cube lowered 22 mm, 2 mm into the palm."""
  _, _, _, jstep, spec = tasks
  interp = int(spline.Interp.ZERO)
  rng = np.random.default_rng(11)
  m = spec.model
  q0 = m.qpos0.clone()
  q0[2] -= 0.022
  d0 = make_data(m).replace(qpos=q0[None])
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
  q = np.tile(d0.qpos.numpy(), (NSAMPLE, 1))
  v = np.zeros((NSAMPLE, m.nv))
  costs = []
  for k in range(HORIZON):
    out = jstep(q, v, acts[:, k])
    costs.append(out['cost'])
    q, v = out['qpos'], out['qvel']
  want = np.asarray(jrollout.total_return(jnp.stack(costs, -1)))

  np.testing.assert_allclose(info['returns'].numpy(), want, rtol=1e-8)
  assert int(info['winner']) == int(np.argmin(want))
  assert float(info['best_return']) <= float(info['nominal_return'])
  np.testing.assert_array_equal(new.values.numpy(),
                                cands[int(info['winner'])].numpy())


class _Goal(torch.Generator):
  """A generator whose one normal draw is JAX's: the port's transition
  draws its goal with torch.randn(generator=...)."""


@pytest.fixture(scope='module')
def jax_transition(tasks):
  """JAX's kinematics and transition of one state, jitted once: (qpos,
  qvel, mocap_quat, key) -> (state after the transition, its params)."""
  jspec, jm, jparams, _, _ = tasks
  jd0 = jmake_data(jm, dtype=jnp.float64)

  @jax.jit
  def run(q, v, mq, key):
    d = jkin.kinematics(jm, jd0.replace(qpos=q, qvel=v, mocap_quat=mq))
    return jspec.transition_fn(jm, d, jparams, key)
  return run


@pytest.mark.parametrize('branch', ['solved', 'dropped', 'neither'])
def test_transition(tasks, jax_transition, branch, monkeypatch):
  """Solved: the goal becomes JAX's unit normal draw (handed to the port
  through torch.randn); dropped: the cube goes back above the palm at
  rest; neither: nothing changes. On the B = 1 state after kinematics,
  with the goal mocap set so each branch is taken."""
  _, _, jparams, _, spec = tasks
  m = spec.model
  goal = m.body_mocapid[m.body('goal')]
  qpos = m.qpos0.numpy().copy()
  qvel = np.random.default_rng(3).normal(scale=0.3, size=m.nv)
  qpos[3:7] = [np.cos(0.3), np.sin(0.3), 0.0, 0.0]
  mocap_quat = np.array([[1.0, 0.0, 0.0, 0.0]])
  if branch == 'solved':          # orientation error 0.1 < 0.25
    mocap_quat[0] = [np.cos(0.25), np.sin(0.25), 0.0, 0.0]
  if branch == 'dropped':         # the cube site below -0.12
    qpos[2] = -0.2
  key = jax.random.key(5)
  jd2, jp2 = jax_transition(jnp.asarray(qpos), jnp.asarray(qvel),
                            jnp.asarray(mocap_quat), key)
  drawn = np.array(jax.random.normal(key, (4,), dtype=jnp.float64))

  d = kin.kinematics(m, make_data(m).replace(
      qpos=torch.from_numpy(qpos)[None], qvel=torch.from_numpy(qvel)[None],
      mocap_quat=torch.from_numpy(mocap_quat)[None]))
  randn = torch.randn
  monkeypatch.setattr(torch, 'randn', lambda shape, generator, **kw: (
      torch.from_numpy(drawn).to(kw['dtype']) if isinstance(
          generator, _Goal) else randn(shape, generator=generator, **kw)))
  d2, p2 = spec.transition_fn(m, d, spec.default_params, _Goal())
  assert p2 is spec.default_params
  for k in ('qpos', 'qvel', 'mocap_quat'):
    _close(getattr(d2, k)[0], getattr(jd2, k), k, rtol=0, atol=1e-15)
  moved = not np.allclose(d2.mocap_quat[0, goal].numpy(), mocap_quat[0])
  assert moved == (branch == 'solved')
  reset = np.allclose(d2.qpos[0, :7].numpy(), [0, 0, 0.065, 1, 0, 0, 0])
  assert reset == (branch == 'dropped')
  assert bool((d2.qvel == 0).all()) == (branch == 'dropped')
  np.testing.assert_array_equal(jp2.residual_params,
                                jparams.residual_params)
