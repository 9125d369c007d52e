"""The port's Cartpole physics, stage by stage, against JAX and MuJoCo.

Both packages get the same compiled model (the JAX Model's leaves handed
to the port in float64) and the same random states, some with the cart
past its slider limit so that the limit rows and the Newton solve are
active. Every forward stage and one Euler step are compared with the JAX
pipeline; the constrained qacc is also compared with the MuJoCo C engine,
as tests/test_physics_golden.py does for the JAX package.
"""

import os

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu.physics import constraint as jconstraint
from mujoco_mpc_tpu.physics import forward as jfwd
from mujoco_mpc_tpu.physics import kinematics as jkin
from mujoco_mpc_tpu.physics import smooth as jsmooth
from mujoco_mpc_tpu.physics.model import load_model
from mujoco_mpc_tpu.physics.model import make_data as jmake_data
from mujoco_mpc_tpu_torch.physics import constraint
from mujoco_mpc_tpu_torch.physics import forward as fwd
from mujoco_mpc_tpu_torch.physics import kinematics as kin
from mujoco_mpc_tpu_torch.physics import model as model_lib
from mujoco_mpc_tpu_torch.physics import smooth
from tools import export_torch_snapshot as export

torch.set_num_threads(1)

XML = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'mujoco_mpc_tpu', 'models', 'cartpole.xml')
NSTATE = 8


@pytest.fixture(scope='module')
def setup():
  jm, mj = load_model(XML, dtype=jnp.float64)
  m = model_lib.from_arrays(*export.model_snapshot(jm), device='cpu',
                            dtype=torch.float64)
  rng = np.random.default_rng(0)
  qpos = np.stack([rng.uniform(-2.2, 2.2, NSTATE),
                   rng.uniform(-np.pi, np.pi, NSTATE)], 1)
  qpos[:2, 0] = (2.0, -1.95)        # two carts surely past a limit
  qpos[2, 0] = 0.3                  # and one surely inside
  qvel = rng.normal(scale=2.0, size=(NSTATE, 2))
  ctrl = rng.uniform(-1.2, 1.2, size=(NSTATE, 1))   # past ctrlrange too
  state = (qpos, qvel, ctrl)
  jd0 = jmake_data(jm, dtype=jnp.float64)

  def jdata(q, v, u):
    return jd0.replace(qpos=q, qvel=v, ctrl=u)

  d = model_lib.make_data(m, NSTATE).replace(
      qpos=torch.from_numpy(qpos), qvel=torch.from_numpy(qvel),
      ctrl=torch.from_numpy(ctrl))
  return jm, mj, m, state, jdata, d


def _jax_stage(jm, jdata, state, fn):
  return jax.vmap(lambda q, v, u: fn(jm, jdata(q, v, u)))(
      *(jnp.asarray(x) for x in state))


def _close(got, want, name, atol=1e-10):
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                             atol=atol, err_msg=name)


def test_kinematics_and_com(setup):
  jm, _, m, state, jdata, d = setup
  want = _jax_stage(jm, jdata, state, lambda jm_, x: jkin.com_vel(
      jm_, jkin.com_pos(jm_, jkin.kinematics(jm_, x))))
  got = kin.com_vel(m, kin.com_pos(m, kin.kinematics(m, d)))
  # f64, the same formulas: agreement to rounding
  for k in ('xpos', 'xquat', 'xmat', 'xipos', 'xanchor', 'xaxis',
            'site_xpos', 'geom_xpos', 'subtree_com', 'cinert', 'cdof',
            'cvel', 'cdof_dot'):
    _close(getattr(got, k), getattr(want, k), k)


def test_smooth_dynamics(setup):
  jm, _, m, state, jdata, d = setup

  def jax_smooth(jm_, x):
    x = jfwd.fwd_actuation(jm_, jfwd.fwd_velocity(jm_, jfwd.fwd_position(
        jm_, x)))
    x = jsmooth.crb(jm_, x)
    x = x.replace(qfrc_constraint=jnp.zeros(jm_.nv, jnp.float64))
    return jfwd.fwd_acceleration(jm_, x)

  want = _jax_stage(jm, jdata, state, jax_smooth)
  got = fwd.fwd_actuation(m, fwd.fwd_velocity(m, fwd.fwd_position(m, d)))
  got = smooth.crb(m, got).replace(qfrc_constraint=torch.zeros_like(d.qvel))
  got = fwd.fwd_acceleration(m, got)
  # f64: agreement to rounding, scaled by the force magnitudes (~1e2)
  for k in ('qM', 'qfrc_bias', 'qfrc_passive', 'actuator_length',
            'actuator_velocity', 'actuator_force', 'qfrc_actuator',
            'qfrc_smooth', 'qacc'):
    _close(getattr(got, k), getattr(want, k), k, atol=1e-9)


def test_limit_rows(setup):
  jm, _, m, state, jdata, d = setup

  def jax_rows(jm_, x):
    rows = jconstraint._limit_rows_scalar(jm_, jkin.kinematics(jm_, x))
    return rows.pos, rows.aref, rows.d, rows.active

  want = _jax_stage(jm, jdata, state, jax_rows)
  rows = constraint._limit_rows_scalar(m, d)
  assert rows.active.any() and not rows.active.all()   # both regimes
  for name, g, w in zip(('pos', 'aref', 'D'), (rows.pos, rows.aref, rows.d),
                        want[:3]):
    _close(g, w, name, atol=1e-8)
  np.testing.assert_array_equal(rows.active.numpy(), np.asarray(want[3]))
  np.testing.assert_array_equal(rows.dof.numpy(), [0, 0])
  np.testing.assert_array_equal(rows.sign.numpy(), [1.0, -1.0])


def test_constrained_forward_and_step(setup):
  jm, _, m, state, jdata, d = setup
  want = _jax_stage(jm, jdata, state, jfwd.forward)
  got = fwd.forward(m, d)
  # f64 Newton to tol 1e-8 in both; qacc reaches ~1e3 past the limit
  _close(got.qacc, want.qacc, 'qacc', atol=1e-7)
  _close(got.qfrc_constraint, want.qfrc_constraint, 'qfrc_constraint',
         atol=1e-7)
  want_step = _jax_stage(jm, jdata, state, jfwd.step)
  got_step = fwd.step(m, d)
  for k in ('qpos', 'qvel', 'time'):
    _close(getattr(got_step, k), getattr(want_step, k), k, atol=1e-9)


def test_qacc_matches_mujoco(setup):
  _, mj, m, state, _, d = setup
  got = fwd.forward(m, d).qacc.numpy()
  mjd = mujoco.MjData(mj)
  for i in range(NSTATE):
    mjd.qpos[:], mjd.qvel[:], mjd.ctrl[:] = (x[i] for x in state)
    mujoco.mj_forward(mj, mjd)
    # the C engine's Newton solve stops at its own tolerance; relative to
    # |qacc| (up to ~1e3 past the limit) the two agree to ~1e-8
    np.testing.assert_allclose(got[i], mjd.qacc, rtol=1e-6, atol=1e-6,
                               err_msg=f'state {i}')


STATIC_XML = """<mujoco>
  <worldbody>
    <geom type="plane" size="1 1 0.1"/>
    <body pos="0 0 1"><geom type="sphere" size="0.1"/></body>
  </worldbody>
</mujoco>"""


def test_static_scene_has_nothing_to_solve(monkeypatch):
  """nv 0 (a scene with no joints): fwd_acceleration returns its Data
  unchanged without reaching the SPD solve, as JAX's does
  (physics/forward.py:59-60), and the forward pass places the bodies as
  JAX's does."""
  jm, _ = load_model(xml_string=STATIC_XML, dtype=jnp.float64)
  m = model_lib.from_arrays(*export.model_snapshot(jm), device='cpu',
                            dtype=torch.float64)
  assert m.nv == 0

  def no_solve(*a, **k):
    raise AssertionError('solved a system at nv 0')
  monkeypatch.setattr(fwd.spd_solve, 'solve_spd', no_solve)
  d = fwd.fwd_actuation(m, fwd.fwd_velocity(
      m, fwd.fwd_position(m, model_lib.make_data(m, 3))))
  d = smooth.crb(m, d).replace(qfrc_constraint=torch.zeros_like(d.qvel))
  assert fwd.fwd_acceleration(m, d) is d
  got = fwd.forward(m, model_lib.make_data(m, 3))
  want = jfwd.forward(jm, jmake_data(jm, dtype=jnp.float64))
  for k in ('xpos', 'geom_xpos'):
    _close(getattr(got, k), np.broadcast_to(getattr(want, k),
                                            getattr(got, k).shape), k,
           atol=0)
