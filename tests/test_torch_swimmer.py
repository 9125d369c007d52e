"""The Swimmer slice of the port against the JAX package, float64.

Swimmer is the task with the inertia-box fluid drag (density 1000) and
the implicit integrator: its velocity derivative is a forward-mode
Jacobian nested inside the derivative pass's own. Held here:

* fluid (qfrc_passive with the drag), qacc and one implicit step, from a
  few states with every hinge bent and the body moving;
* the exact derivatives (transition and cost) at T 4 against JAX's
  derivatives.compute, its call replayed from
  assets/swimmer_derivatives_golden.npz (tests/torch_recorded.py;
  test_derivatives_golden_is_jaxs, slow, makes it live);
* riccati fed JAX's derivatives, against JAX's riccati;
* the transition's reached and not-reached branches (the target JAX draws
  with its key is handed to the port's generator).

Swimmer's full JAX iLQG compile stays out of the CPU tests; chip_smoke.py
runs the port's iLQG on Swimmer at 8 x 201 and holds the card against the
CPU plain path.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu.physics import fluid as jfluid
from mujoco_mpc_tpu.physics import forward as jfwd
from mujoco_mpc_tpu.physics import kinematics as jkin
from mujoco_mpc_tpu.physics import smooth as jsmooth
from mujoco_mpc_tpu.planners import derivatives as jder
from mujoco_mpc_tpu.planners import ilqg as jilqg
from mujoco_mpc_tpu_torch.physics import fluid
from mujoco_mpc_tpu_torch.physics import forward as fwd
from mujoco_mpc_tpu_torch.physics import kinematics as kin
from mujoco_mpc_tpu_torch.physics import smooth
from mujoco_mpc_tpu_torch.physics.model import make_data
from mujoco_mpc_tpu_torch.planners import derivatives
from mujoco_mpc_tpu_torch.planners import ilqg
from mujoco_mpc_tpu_torch.tasks import registry
from tests.test_torch_cube import QUICK_COMPILE
from tests.test_torch_ilqg import F64, _rel, _tasks
from tests.torch_recorded import Recorded

torch.set_num_threads(1)

NSTATE = 4
T_STEPS = 4
# JAX's derivatives.compute, its recorded call (tests/torch_recorded.py)
DERIVATIVES_GOLDEN = 'swimmer_derivatives_golden.npz'
DERIVATIVES = ('a', 'b', 'cx', 'cu', 'cxx', 'cxu', 'cuu')


def _states(spec, seed, n):
  rng = np.random.default_rng(seed)
  m = spec.model
  q = m.qpos0.numpy() + np.concatenate([rng.normal(scale=0.2, size=3),
                                        rng.uniform(-1.2, 1.2, size=5)])
  qs = q + rng.normal(scale=0.05, size=(n, m.nq))
  return (qs, rng.normal(scale=0.8, size=(n, m.nv)),
          rng.uniform(-1.0, 1.0, size=(n, m.nu)))


def test_swimmer_model():
  _, _, spec = _tasks('Swimmer')
  m = spec.model
  assert (m.nq, m.nv, m.nu, m.opt.integrator) == (8, 8, 5, 2)
  assert m.has_fluid and float(m.opt.density) == 1000.0


def test_swimmer_fluid_and_step_match_jax():
  jspec, jd0, spec = _tasks('Swimmer')
  jm = jspec.model
  q, v, u = _states(spec, 0, NSTATE)
  m = spec.model
  d = make_data(m, NSTATE).replace(qpos=torch.from_numpy(q),
                                   qvel=torch.from_numpy(v),
                                   ctrl=torch.from_numpy(u))
  dp = fwd.fwd_position(m, d)
  drag = fluid.fluid(m, smooth.passive(m, smooth.rne(m, kin.com_vel(
      m, dp)))).qfrc_passive
  df = fwd.forward(m, d)
  d2 = fwd.integrate(m, df)

  @functools.partial(jax.jit, compiler_options=QUICK_COMPILE)
  def one(q, v, u):
    dj = jd0.replace(qpos=q, qvel=v, ctrl=u)
    dpj = jfwd.fwd_position(jm, dj)
    dragj = jfluid.fluid(jm, jsmooth.passive(jm, jsmooth.rne(
        jm, jkin.com_vel(jm, dpj)))).qfrc_passive
    dfj = jfwd.forward(jm, dj)
    d2j = jfwd.integrate(jm, dfj)
    return dragj, dfj.qacc, d2j.qpos, d2j.qvel
  want = [np.stack(x) for x in zip(*(one(q[i], v[i], u[i])
                                     for i in range(NSTATE)))]
  # the drag is a real part of the force at these states
  assert np.abs(want[0] - np.asarray(
      smooth.passive(m, smooth.rne(m, kin.com_vel(m, dp))).qfrc_passive)
  ).max() > 1e-4
  for name, g, w in zip(('fluid', 'qacc', 'qpos', 'qvel'),
                        (drag, df.qacc, d2.qpos, d2.qvel), want):
    _rel(g, w, 1e-10, name)


@pytest.fixture(scope='module')
def jax_derivatives():
  """JAX's derivatives.compute of a nominal trajectory's leaves, jitted
  once, replayed from its recorded call (its trace and compile took ~65
  s on a CPU): the outputs, a dict of DERIVATIVES."""
  jspec, jd0, _ = _tasks('Swimmer')
  jp = jspec.default_params

  def live():
    tree = jax.tree.structure(_nominal(jspec, jd0))

    @functools.partial(jax.jit, compiler_options=QUICK_COMPILE)
    def call(qpos, qvel, *leaves):
      out = jder.compute(jspec, jd0.replace(qpos=qpos, qvel=qvel),
                         jax.tree.unflatten(tree, leaves), jp)
      return {k: getattr(out, k) for k in DERIVATIVES}
    return call

  recorded = Recorded(os.path.join(registry.ASSETS, DERIVATIVES_GOLDEN),
                      live)
  yield recorded
  if recorded.recording:
    recorded.save()


def _acts():
  return np.random.default_rng(2).uniform(-1.0, 1.0, size=(T_STEPS, 5))


def _nominal(jspec, jd0):
  return jder.nominal_trajectory(jspec, jd0, jnp.asarray(_acts()),
                                 jspec.default_params)


@pytest.fixture(scope='module')
def derivs(jax_derivatives):
  """Both packages' trajectories and derivatives at T 4 from one state
  (JAX's derivatives.compute: its recorded call)."""
  jspec, jd0, spec = _tasks('Swimmer')
  q, v, _ = _states(spec, 1, 1)
  acts = _acts()
  jd0 = jd0.replace(qpos=jnp.asarray(q[0]), qvel=jnp.asarray(v[0]))
  jtraj = _nominal(jspec, jd0)
  want = jder.Derivatives(**{k: jnp.asarray(x) for k, x in jax_derivatives(
      q[0], v[0], *jax.tree.leaves(jtraj)).items()})
  d0 = make_data(spec.model).replace(qpos=torch.from_numpy(q),
                                     qvel=torch.from_numpy(v))
  traj = derivatives.nominal_trajectory(spec, d0, torch.from_numpy(acts),
                                        spec.default_params)
  got = derivatives.compute(spec, d0, traj, spec.default_params)
  return jtraj, want, traj, got


def test_swimmer_derivatives_match_jax(derivs):
  jtraj, want, traj, got = derivs
  for k in ('qpos', 'qvel', 'residuals', 'costs'):
    _rel(getattr(traj, k), getattr(jtraj, k), 1e-10, k)
  for k in DERIVATIVES:
    _rel(getattr(got, k), getattr(want, k), 1e-8, k)
  # the fluid couples the joints: the velocity block is dense
  assert np.count_nonzero(np.abs(got.a[0, 8:, 8:].numpy()) > 1e-9) > 32


def test_swimmer_riccati_on_jax_derivatives(derivs):
  jtraj, want, _, _ = derivs
  jspec, _, spec = _tasks('Swimmer')
  port = derivatives.Derivatives(**{
      f.name: torch.from_numpy(np.array(getattr(want, f.name)))
      for f in dataclasses.fields(derivatives.Derivatives)})
  got = ilqg.riccati(port, torch.tensor(0.5, dtype=F64),
                     torch.from_numpy(np.asarray(jtraj.actions)),
                     spec.model.actuator_ctrlrange, ilqg.REG_CONTROL, True)
  ref = jilqg.riccati(want, jnp.asarray(0.5), jtraj.actions,
                      jspec.model.actuator_ctrlrange, jilqg.REG_CONTROL,
                      True)
  for name, g, w in zip(('k', 'K', 'dV'), got, ref):
    _rel(g, w, 1e-10, name)
  assert bool(got[3]) and bool(ref[3])


class _Target(torch.Generator):
  """Marks the transition's draw, which the test replaces with JAX's."""


@pytest.mark.parametrize('reached', [True, False])
def test_swimmer_transition_matches_jax(monkeypatch, reached):
  jspec, jd0, spec = _tasks('Swimmer')
  m = spec.model
  jm, jp = jspec.model, jspec.default_params
  mocap = np.array([[0.5, 0.5, 0.05]])
  if reached:                       # the nose (0.1, 0) within 0.04
    mocap[0, :2] = (0.12, 0.01)
  key = jax.random.key(3)
  jd = jkin.kinematics(jm, jd0.replace(mocap_pos=jnp.asarray(mocap)))
  jd2, _ = jspec.transition_fn(jm, jd, jp, key)
  drawn = np.array(jax.random.uniform(key, (2,), minval=-0.8, maxval=0.8,
                                      dtype=jnp.float64))
  d = kin.kinematics(m, make_data(m).replace(
      mocap_pos=torch.from_numpy(mocap)[None]))
  rand = torch.rand
  monkeypatch.setattr(torch, 'rand', lambda shape, generator, **kw: (
      torch.from_numpy((drawn + 0.8) / 1.6).to(kw['dtype'])
      if isinstance(generator, _Target)
      else rand(shape, generator=generator, **kw)))
  d2, p2 = spec.transition_fn(m, d, spec.default_params, _Target())
  assert p2 is spec.default_params
  _rel(d2.mocap_pos[0], jd2.mocap_pos, 1e-15, 'mocap_pos')
  assert np.allclose(d2.mocap_pos[0].numpy(), mocap) != reached


@pytest.mark.slow
def test_derivatives_golden_is_jaxs(jax_derivatives):
  """The recorded call of JAX's derivatives.compute is what the JAX
  package computes now (its trace and compile: ~65 s on a CPU)."""
  jax_derivatives.check_live()
