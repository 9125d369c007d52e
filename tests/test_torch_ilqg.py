"""The port's iLQG slice against the JAX package, float64.

* B1's Function: ops/spd_solve.SpdSolve's jvp against jax.jvp of
  physics/forward._solve_m (custom_linear_solve), its vmap of jvp against
  a loop over the directions and as one solve at B * D.
* The norms' analytic gradients and Hessians, every type.
* Particle's step, and its exact derivatives (transition and cost) at
  T 4.
* boxqp and riccati on random inputs, mirroring tests/test_ilqg.py.
* ilqg.optimize on Particle: two pipelined iterations, then one eager, at
  T 6 with 4 candidates, from the same state: the same returns, winner,
  improvement and gains. JAX's iterations are replayed from their recorded
  calls (assets/particle_ilqg_optimize_golden.npz, tests/torch_recorded.py;
  its compiles took ~22 s); the slow test_optimize_golden_is_jaxs makes
  them live.
* make_planner's interface and convert's iLQG state.

B2's Function and Cartpole's derivatives and optimize (the slider past
its limit, so B2's tangent runs in the step) are in
tests/test_torch_tangents.py, Swimmer in tests/test_torch_swimmer.py:
each file's JAX compiles stay on their own worker.

The CPU runs the kernels' plain versions through the same Functions, so
their jvp and vmap rules are exercised here; the kernels themselves are
held against the plain versions on the card by chip_smoke.py.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jvp, vmap

from mujoco_mpc_tpu.ops import norms as jnorms
from mujoco_mpc_tpu.physics import forward as jfwd
from mujoco_mpc_tpu.physics.model import make_data as jmake_data
from mujoco_mpc_tpu.planners import derivatives as jder
from mujoco_mpc_tpu.planners import ilqg as jilqg
from mujoco_mpc_tpu.tasks import registry as jregistry
from mujoco_mpc_tpu_torch import convert
from mujoco_mpc_tpu_torch.ops import norms
from mujoco_mpc_tpu_torch.ops import spd_solve
from mujoco_mpc_tpu_torch.physics import forward as fwd
from mujoco_mpc_tpu_torch.physics.model import make_data
from mujoco_mpc_tpu_torch.planners import derivatives
from mujoco_mpc_tpu_torch.planners import ilqg
from mujoco_mpc_tpu_torch.planners import registry as planners
from mujoco_mpc_tpu_torch.tasks import registry
from tests.test_torch_cube import QUICK_COMPILE
from tests.torch_recorded import RecordedJax

torch.set_num_threads(1)

F64 = torch.float64


def _rel(got, want, rtol, what=''):
  """|got - want| <= rtol * max(|want|, 1) elementwise, per knot."""
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  scale = np.maximum(np.abs(want), 1.0)
  err = np.max(np.abs(got - want) / scale) if got.size else 0.0
  assert err <= rtol, f'{what}: relative error {err:.3e} > {rtol:.0e}'


def _f64(tree):
  return jax.tree.map(
      lambda x: x.astype(jnp.float64)
      if jnp.issubdtype(getattr(x, 'dtype', np.int32), jnp.floating) else x,
      tree)


# ---------------------------------------------------------------------------
# B1: SpdSolve
# ---------------------------------------------------------------------------


def _spd(rng, bsz, n):
  g = rng.normal(size=(bsz, n, n))
  a = g @ np.transpose(g, (0, 2, 1)) + n * np.eye(n)
  da = rng.normal(size=(bsz, n, n))
  return a, rng.normal(size=(bsz, n)), da + np.transpose(da, (0, 2, 1)), \
      rng.normal(size=(bsz, n))


@pytest.mark.parametrize('n', [2, 8])
def test_spd_function_jvp_matches_custom_linear_solve(n):
  a, b, da, db = _spd(np.random.default_rng(n), 6, n)
  x, dx = jvp(spd_solve.solve_spd, (torch.from_numpy(a), torch.from_numpy(b)),
              (torch.from_numpy(da), torch.from_numpy(db)))
  wx, wdx = jax.vmap(lambda *z: jax.jvp(jfwd._solve_m, z[:2], z[2:]))(
      *(jnp.asarray(v) for v in (a, b, da, db)))
  _rel(x, wx, 1e-10, 'x')
  _rel(dx, wdx, 1e-10, 'dx')


def test_spd_function_vmap_of_jvp_is_one_solve(monkeypatch):
  """D tangent directions of a (B, n) solve, sharing a: the same as a loop
  over the directions, and one plain solve at B * D after the primal."""
  rng = np.random.default_rng(3)
  a, b, _, _ = _spd(rng, 5, 4)
  dbs = torch.from_numpy(rng.normal(size=(7, 5, 4)))
  das = torch.from_numpy(rng.normal(size=(7, 5, 4, 4)))
  a, b = torch.from_numpy(a), torch.from_numpy(b)
  shapes = []
  solve = spd_solve._solve
  monkeypatch.setattr(spd_solve, '_solve', lambda x, y: (
      shapes.append(tuple(y.shape)), solve(x, y))[1])
  got = vmap(lambda u, v: jvp(spd_solve.solve_spd, (a, b), (u, v))[1])(
      das, dbs)
  assert shapes == [(5, 4), (35, 4)]
  want = torch.stack([jvp(spd_solve.solve_spd, (a, b),
                          (das[k], dbs[k]))[1] for k in range(7)])
  _rel(got, want, 1e-10, 'vmap(jvp)')


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

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
def test_norm_grad_and_hess(norm_type):
  x = np.random.default_rng(7).normal(size=(5, 3))
  x[0] = 0.0                                       # the zero guards
  for pv in (NORM_PARAMS[norm_type], [0.0, 2.0, 0.0]):
    params = np.asarray(pv)
    for port_fn, jax_fn in ((norms.norm_grad, jnorms.norm_grad),
                            (norms.norm_hess, jnorms.norm_hess)):
      got = port_fn(torch.from_numpy(x), torch.from_numpy(params),
                    norm_type).numpy()
      want = np.asarray(jax_fn(jnp.asarray(x), jnp.asarray(params),
                               norm_type))
      np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


# ---------------------------------------------------------------------------
# tasks, derivatives
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _tasks(name):
  """(JAX spec with its model and parameters in f64, its f64 data, the
  port's spec in f64)."""
  jspec = jregistry.get_task(name)
  jspec = dataclasses.replace(jspec, model=_f64(jspec.model),
                              default_params=_f64(jspec.default_params))
  spec = registry.get_task(name, device='cpu', dtype=F64)
  return jspec, jmake_data(jspec.model, dtype=jnp.float64), spec


# the start states: Particle off its goal and moving; Cartpole's cart past
# its slider limit and moving further out
STARTS = {'Particle': ([0.2, -0.1], [0.5, -0.3]),
          'Cartpole': ([2.0, 2.9], [1.0, 0.5])}


def test_particle_step_matches_jax():
  jspec, jd0, spec = _tasks('Particle')
  rng = np.random.default_rng(8)
  q = rng.uniform(-0.35, 0.35, size=(6, 2))         # some past a limit
  v = rng.normal(size=(6, 2))
  u = rng.uniform(-1.2, 1.2, size=(6, 2))
  t = rng.uniform(0.0, 3.0, size=6)
  m = spec.model
  d = fwd.forward(m, make_data(m, 6).replace(
      qpos=torch.from_numpy(q), qvel=torch.from_numpy(v),
      ctrl=torch.from_numpy(u), time=torch.from_numpy(t)))
  res = spec.residual_fn(m, d, spec.default_params.residual_params)
  d2 = fwd.integrate(m, d)

  @functools.partial(jax.jit, compiler_options=QUICK_COMPILE)
  def one(q, v, u, t):
    jm, jp = jspec.model, jspec.default_params
    dj = jfwd.forward(jm, jd0.replace(qpos=q, qvel=v, ctrl=u, time=t))
    return (jspec.residual_fn(jm, dj, jp.residual_params), dj.qacc,
            jfwd.integrate(jm, dj).qvel)
  want = [np.stack(x) for x in zip(*(one(q[i], v[i], u[i], t[i])
                                     for i in range(6)))]
  # qvel after the step carries the Euler solve of the stiff limit rows'
  # force (their impedance over dt^2), a few ulps of qacc amplified
  for name, g, w, tol in zip(('residual', 'qacc', 'qvel'),
                             (res, d.qacc, d2.qvel), want,
                             (1e-10, 1e-10, 1e-9)):
    _rel(g, w, tol, name)


def _trajectories(name, t_steps):
  jspec, jd0, spec = _tasks(name)
  q, v = STARTS[name]
  rng = np.random.default_rng(9)
  acts = rng.uniform(-1.0, 1.0, size=(t_steps, spec.model.nu))
  jd0 = jd0.replace(qpos=jnp.asarray(q), qvel=jnp.asarray(v))
  d0 = make_data(spec.model).replace(qpos=torch.tensor([q], dtype=F64),
                                     qvel=torch.tensor([v], dtype=F64))
  return jspec, jd0, spec, d0, acts


def check_derivatives(name):
  """transition_derivs and cost_derivs at T 4 against JAX, 1e-8 relative
  per knot."""
  jspec, jd0, spec, d0, acts = _trajectories(name, 4)
  jp = jspec.default_params
  jtraj = jder.nominal_trajectory(jspec, jd0, jnp.asarray(acts), jp)
  want = jax.jit(lambda tr: jder.compute(jspec, jd0, tr, jp),
                 compiler_options=QUICK_COMPILE)(jtraj)
  traj = derivatives.nominal_trajectory(spec, d0, torch.from_numpy(acts),
                                        spec.default_params)
  got = derivatives.compute(spec, d0, traj, spec.default_params)
  for k in ('qpos', 'qvel', 'residuals', 'costs'):
    _rel(getattr(traj, k), getattr(jtraj, k), 1e-10, k)
  for k in ('a', 'b', 'cx', 'cu', 'cxx', 'cxu', 'cuu'):
    _rel(getattr(got, k), getattr(want, k), 1e-8, k)
  return traj


def test_particle_derivatives_match_jax():
  check_derivatives('Particle')


# ---------------------------------------------------------------------------
# boxqp, riccati
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_boxqp_matches_jax(seed):
  rng = np.random.default_rng(seed)
  q = rng.standard_normal((4, 4))
  h = q @ q.T + 0.5 * np.eye(4)
  g = 3.0 * rng.standard_normal(4)
  lower, upper = -rng.uniform(0.1, 1.0, 4), rng.uniform(0.1, 1.0, 4)
  got = ilqg.boxqp(*(torch.from_numpy(x) for x in (h, g, lower, upper)))
  want = jilqg.boxqp(*(jnp.asarray(x) for x in (h, g, lower, upper)))
  _rel(got[0], want[0], 1e-10, 'x')
  assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
  assert bool(got[2]) == bool(want[2])


def _random_derivs(rng, t_steps, nd, nu):
  def spd(*lead, n):
    g = rng.normal(size=lead + (n, n))
    return g @ np.swapaxes(g, -1, -2) + 0.1 * np.eye(n)
  return dict(a=np.eye(nd) + 0.1 * rng.normal(size=(t_steps - 1, nd, nd)),
              b=0.1 * rng.normal(size=(t_steps - 1, nd, nu)),
              cx=rng.normal(size=(t_steps, nd)),
              cu=rng.normal(size=(t_steps, nu)),
              cxx=spd(t_steps, n=nd), cxu=0.1 * rng.normal(
                  size=(t_steps, nd, nu)), cuu=spd(t_steps, n=nu))


@pytest.mark.parametrize('reg_type,limits', [
    (ilqg.REG_CONTROL, True), (ilqg.REG_STATE_CONTROL, True),
    (ilqg.REG_VALUE, False), (ilqg.REG_NONE, False)])
def test_riccati_matches_jax(reg_type, limits):
  rng = np.random.default_rng(reg_type)
  raw = _random_derivs(rng, 6, 4, 2)
  actions = rng.uniform(-0.5, 0.5, size=(6, 2))
  ctrlrange = np.array([[-1.0, 1.0], [-0.3, 0.8]])
  got = ilqg.riccati(
      derivatives.Derivatives(**{k: torch.from_numpy(v)
                                 for k, v in raw.items()}),
      torch.tensor(0.3, dtype=F64), torch.from_numpy(actions),
      torch.from_numpy(ctrlrange), reg_type, limits)
  want = jilqg.riccati(
      jder.Derivatives(**{k: jnp.asarray(v) for k, v in raw.items()}),
      jnp.asarray(0.3), jnp.asarray(actions), jnp.asarray(ctrlrange),
      reg_type, limits)
  for name, g, w in zip(('k', 'K', 'dV'), got, want):
    _rel(g, w, 1e-10, name)
  assert bool(got[3]) == bool(want[3])


# ---------------------------------------------------------------------------
# optimize
# ---------------------------------------------------------------------------

T_STEPS, CANDIDATES = 6, 4
INFO = ('best_return', 'nominal_return', 'improvement', 'action_step',
        'surprise', 'regularization')


# JAX's optimize calls, replayed from their recorded calls
# (tests/torch_recorded.py)
OPTIMIZE_GOLDEN = '{}_ilqg_optimize_golden.npz'


def jax_optimize(name):
  """JAX's iLQG optimize on task `name` ('pipelined' and 'eager', each
  jitted once), replayed from assets/<name>_ilqg_optimize_golden.npz."""
  jspec, _, _, _, _ = _trajectories(name, T_STEPS)

  def live():
    jcfg = jilqg.default_config(jspec, dtype=jnp.float64)
    return {k: jax.jit(functools.partial(
        jilqg.optimize, jspec, cfg=jcfg, num_candidates=CANDIDATES,
        horizon_steps=T_STEPS, pipelined=k == 'pipelined'),
                       compiler_options=QUICK_COMPILE)
            for k in ('pipelined', 'eager')}
  return RecordedJax(os.path.join(registry.ASSETS, OPTIMIZE_GOLDEN.format(
      name.lower())), live)


def check_optimize(name):
  """Two pipelined iterations, then one eager, in both packages, each
  package from its own previous state: returns, the winning scale, the
  new policy's nominal, improvement and gains."""
  jspec, jd0, spec, d0, _ = _trajectories(name, T_STEPS)
  jp = jspec.default_params
  jstate = jilqg.default_state(jspec, T_STEPS, dtype=jnp.float64)
  jopt = jax_optimize(name)
  cfg = ilqg.default_config(spec)
  state = ilqg.default_state(spec, T_STEPS)
  for it, pipelined in enumerate((True, True, False)):
    jstate, jinfo = jopt('pipelined' if pipelined else 'eager', jstate,
                         d0=jd0, params=jp)
    state, info = ilqg.optimize(spec, state, d0, spec.default_params, cfg,
                                CANDIDATES, T_STEPS, pipelined=pipelined)
    assert bool(info['backward_pass_ok']) == bool(jinfo['backward_pass_ok'])
    for k in INFO:
      _rel(info[k], jinfo[k], 1e-8, f'iteration {it}: {k}')
    for k in ('actions', 'qpos', 'qvel', 'feedback_gain',
              'action_improvement'):
      _rel(getattr(state.policy, k), getattr(jstate.policy, k), 1e-8,
           f'iteration {it}: policy.{k}')
    _rel(state.expected_dv, jstate.expected_dv, 1e-8, 'expected_dv')
  # the planner improved on its nominal
  assert float(info['best_return']) <= float(info['nominal_return'])
  if jopt.recording:
    jopt.save()


def test_particle_optimize_matches_jax():
  check_optimize('Particle')


@pytest.mark.slow
def test_optimize_golden_is_jaxs():
  """The recorded calls of JAX's iLQG optimize on Particle are what the
  JAX package computes now."""
  jax_optimize('Particle').check_live()


def test_make_planner_ilqg_and_sampling():
  spec = registry.get_task('Particle', device='cpu', dtype=F64)
  d0 = make_data(spec.model)
  p = planners.make_planner(spec, planners.ILQG, CANDIDATES, T_STEPS, 3)
  state, info = p.optimize(p.init(), d0, spec.default_params, None)
  assert state.policy.feedback_gain.shape == (T_STEPS, 2, 4)
  assert bool(info['backward_pass_ok'])
  u = p.action(state, d0.qpos, d0.qvel, d0.act, d0.time)
  assert u.shape == (1, 2)
  assert torch.equal(p.nominal_action(state, d0.qpos, d0.qvel, d0.act,
                                      d0.time),
                     torch.clamp(state.policy.actions[:1], -1.0, 1.0))
  s = planners.make_planner(spec, planners.SAMPLING, 8, T_STEPS, 3)
  policy, sinfo = s.optimize(s.init(), d0, spec.default_params,
                             torch.Generator().manual_seed(0))
  assert s.action(policy, d0.qpos, d0.qvel, d0.act, d0.time).shape == (1, 2)
  # every id builds (tests/test_torch_agent.py runs each one)
  for pid in range(len(planners.PLANNER_NAMES)):
    p = planners.make_planner(spec, pid, 8, T_STEPS, 3)
    assert p.init() is not None and p.nominal_action is not None
  with pytest.raises(ValueError, match='unknown planner id'):
    planners.make_planner(spec, 7, 8, T_STEPS, 3)


def test_convert_carries_the_jax_ilqg_state():
  jspec, _, spec = _tasks('Particle')
  jstate = jilqg.default_state(jspec, T_STEPS, dtype=jnp.float64)
  jstate = jstate.replace(policy=jstate.policy.replace(
      feedback_gain=jnp.arange(T_STEPS * 8.0).reshape(T_STEPS, 2, 4)),
                          regularization=jnp.asarray(0.25))
  state = convert.ilqg_state_from_arrays(
      {k: np.asarray(v) for k, v in vars(jstate.policy).items()},
      {k: np.asarray(getattr(jstate, k))
       for k in convert.ILQG_STATE_FIELDS}, device='cpu', dtype=F64)
  assert float(state.regularization) == 0.25
  np.testing.assert_array_equal(state.policy.feedback_gain.numpy(),
                                np.asarray(jstate.policy.feedback_gain))
  assert state.policy.times.dtype == F64
