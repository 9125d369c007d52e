"""The port's tendons against the JAX package and MuJoCo, float64 on the CPU.

The models of tests/test_tendons.py (carried as assets/physics_models.npz;
JAX's references in assets/physics_features_golden.npz, see
tests/test_torch_convex_pairs.py), each test mirroring its namesake:
* fixed tendons: ten_length, ten_velocity and the tendon sensors against
  mj_forward (atol 1e-12) and JAX's forward (rtol 1e-8, atol 1e-10); the
  spring (deadband) and damper forces (1e-10); the limit engaged over 200
  steps (1e-6) and a tendon actuator's length, force and 100 steps
  (1e-12, 1e-8);
* spatial tendons: the sphere and cylinder wraps over the hinge sweep
  (length 1e-9, moment 1e-8 against MuJoCo; both branches seen), the
  site string at a random state and the pulley rig (1e-10), their spring
  trajectories over 150 of the JAX tests' 300 steps (qpos 1e-6, qvel
  1e-5; all 300 under -m slow) and the cable's actuator and limit over
  400 steps (5e-4);
* every tendon model's trajectory at 4 states against JAX's for 20 steps
  (rtol 1e-7, atol 1e-9).
"""

import mujoco
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu_torch.physics import forward as fwd
from mujoco_mpc_tpu_torch.physics import sensors
from tests.test_torch_convex_pairs import (check_golden_forward,
                                           check_golden_trajectory,
                                           golden_file, names, port_data,
                                           port_model, roll_with_mujoco, xmls)

torch.set_num_threads(1)

# the spring trajectories' steps here; the JAX tests' 300 under -m slow
SPRING_STEPS = 150


def _mujoco(name, qpos=None, qvel=None, ctrl=None):
  mjm = mujoco.MjModel.from_xml_string(xmls()[name])
  mjd = mujoco.MjData(mjm)
  for dst, src in ((mjd.qpos, qpos), (mjd.qvel, qvel), (mjd.ctrl, ctrl)):
    if src is not None:
      dst[:] = src
  mujoco.mj_forward(mjm, mjd)
  return mjm, mjd


def _forward(name, mjd):
  return fwd.forward(port_model(name), port_data(
      name, mjd.qpos.copy(), mjd.qvel.copy(), mjd.ctrl.copy()))


def test_tendon_length_velocity():
  _, mjd = _mujoco('coupled', [0.3, -0.2], [0.5, 0.8], [1.0])
  d = _forward('coupled', mjd)
  np.testing.assert_allclose(d.ten_length[0].numpy(), mjd.ten_length,
                             atol=1e-12)
  np.testing.assert_allclose(d.ten_velocity[0].numpy(), mjd.ten_velocity,
                             atol=1e-12)
  sd = sensors.sensordata(port_model('coupled'), d)
  np.testing.assert_allclose(sd[0].numpy(), mjd.sensordata, atol=1e-12)
  check_golden_forward('coupled', ('ten_length', 'ten_velocity', 'ten_J'), d)
  np.testing.assert_allclose(sd.numpy(),
                             golden_file()['coupled/fwd/sensordata'],
                             rtol=1e-8, atol=1e-10)


def test_tendon_spring_damper_force():
  _, mjd = _mujoco('coupled', [0.3, -0.2], [0.5, 0.8], [0.0])
  d = _forward('coupled', mjd)
  np.testing.assert_allclose(d.qfrc_passive[0].numpy(), mjd.qfrc_passive,
                             atol=1e-10)
  check_golden_forward('coupled', ('qfrc_passive',))


def test_tendon_limit_trajectory():
  """The coupled arm driven into the hamstring's limit."""
  mjd, d = roll_with_mujoco('coupled', 200, ctrl_fn=lambda i: [1.0],
                            state=(np.zeros(2), np.zeros(2), np.ones(1)))
  assert mjd.ten_length[0] > 0.3
  np.testing.assert_allclose(d.qpos[0].numpy(), mjd.qpos, atol=1e-6)
  np.testing.assert_allclose(d.qvel[0].numpy(), mjd.qvel, atol=1e-6)


def test_tendon_actuator():
  _, mjd = _mujoco('split', [0.0, 0.0], [0.0, 0.0], [0.7])
  d = _forward('split', mjd)
  np.testing.assert_allclose(d.actuator_length[0].numpy(),
                             mjd.actuator_length, atol=1e-12)
  np.testing.assert_allclose(d.qfrc_actuator[0].numpy(), mjd.qfrc_actuator,
                             atol=1e-12)
  assert d.actuator_moment.shape == (1, 1, 2)
  check_golden_forward('split', ('actuator_length', 'qfrc_actuator', 'qacc'),
                       d)
  mjd, d = roll_with_mujoco('split', 100)
  np.testing.assert_allclose(d.qpos[0].numpy(), mjd.qpos, atol=1e-8)


@pytest.mark.parametrize('name', ['wrap_cylinder', 'wrap_sphere'])
def test_geom_wrap_length_and_moment(name):
  """The hinge sweep as one batch of 9: no-wrap, tangent-engage and deep
  wraps, against mj_forward and JAX's forward."""
  g = golden_file()
  q = g[f'{name}/sweep/qpos']
  mjm = mujoco.MjModel.from_xml_string(xmls()[name])
  mjd = mujoco.MjData(mjm)
  d = fwd.forward(port_model(name), port_data(
      name, q, np.zeros_like(q), np.zeros((len(q), 0))))
  wrapped = straight = 0
  for i, qi in enumerate(q):
    mjd.qpos[:] = qi
    mujoco.mj_forward(mjm, mjd)
    np.testing.assert_allclose(d.ten_length[i].numpy(), mjd.ten_length,
                               atol=1e-9, err_msg=f'qpos {qi}')
    np.testing.assert_allclose(d.ten_J[i].numpy().ravel(),
                               np.asarray(mjd.ten_J).ravel(), atol=1e-8,
                               err_msg=f'qpos {qi}')
    if mjd.ten_wrapnum[0] > 2:
      wrapped += 1
    else:
      straight += 1
  assert wrapped >= 2 and straight >= 2, (wrapped, straight)
  check_golden_forward(name, ('ten_length', 'ten_J', 'qacc'), d,
                       key='sweep/fwd')


def _check_spring(name, steps):
  mjd, d = roll_with_mujoco(name, steps)
  np.testing.assert_allclose(d.qpos[0].numpy(), mjd.qpos, atol=1e-6)
  np.testing.assert_allclose(d.qvel[0].numpy(), mjd.qvel, atol=1e-5)


@pytest.mark.parametrize('name', ['wrap_cylinder', 'wrap_sphere'])
def test_geom_wrap_spring_trajectory(name):
  """The spring-loaded wrap tendon drives the arm through wrap engage and
  release, SPRING_STEPS of the JAX test's 300 steps (all of them in
  test_spring_trajectories_full)."""
  _check_spring(name, SPRING_STEPS)


def test_spatial_tendon_length_and_moment():
  g = golden_file()
  q, v = g['spatial/sweep/qpos'], g['spatial/sweep/qvel']
  _, mjd = _mujoco('spatial', q[0], v[0])
  d = fwd.forward(port_model('spatial'),
                  port_data('spatial', q, v, np.zeros((1, 0))))
  for k, atol in (('ten_length', 1e-10), ('ten_velocity', 1e-10)):
    np.testing.assert_allclose(getattr(d, k)[0].numpy(), getattr(mjd, k),
                               atol=atol)
  np.testing.assert_allclose(d.ten_J[0, 0].numpy(),
                             np.asarray(mjd.ten_J).reshape(1, 2)[0],
                             atol=1e-10)
  check_golden_forward('spatial', ('ten_length', 'ten_velocity', 'ten_J'),
                       d, key='sweep/fwd')


def test_spatial_tendon_spring_trajectory():
  """SPRING_STEPS of the JAX test's 300 steps (all of them in
  test_spring_trajectories_full)."""
  _check_spring('spatial', SPRING_STEPS)


@pytest.mark.slow
@pytest.mark.parametrize('name', ['wrap_cylinder', 'wrap_sphere', 'spatial'])
def test_spring_trajectories_full(name):
  _check_spring(name, 300)


def test_spatial_tendon_actuator_and_limit():
  """A tendon actuator pulling through a spatial path, held by its range
  limit."""
  mjd, d = roll_with_mujoco('cable', 400)
  np.testing.assert_allclose(d.qpos[0].numpy(), mjd.qpos, atol=5e-4)
  assert float(d.ten_length[0, 0]) > 0.09
  assert d.actuator_moment.shape == (1, 1, 1)


def test_spatial_tendon_pulley_branches():
  """Length = sum of the branches' lengths over their divisors."""
  _, mjd = _mujoco('pulley')
  d = _forward('pulley', mjd)
  np.testing.assert_allclose(d.ten_length[0].numpy(), mjd.ten_length,
                             atol=1e-10)
  np.testing.assert_allclose(d.ten_J[0, 0].numpy(),
                             np.asarray(mjd.ten_J).reshape(1, -1)[0],
                             atol=1e-10)
  check_golden_forward('pulley', ('ten_length', 'ten_J'), d)


@pytest.mark.parametrize('name', names('tendons'))
def test_trajectory_matches_jax(name):
  check_golden_trajectory(name)
