"""Tracking: the port's EKF, UKF and batch estimator follow a trajectory
that the port simulates, from noisy measurements, float64 on the CPU.

The checks of tests/test_estimators.py (the EKF and the UKF on its
two-link arm over 100 steps: within 0.05 rad of the truth, the EKF from
its first update and with its velocity within 0.2) and of
tests/test_direct.py::test_batch_estimator_tracks (a 6-window batch
estimator over 30 noisy pendulum measurements ends within 0.05). The
port alone: no JAX compile (tests/test_torch_estimators.py and
tests/test_torch_direct.py hold the updates to JAX's one at a time).
"""

import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu.physics.model import put_model
from mujoco_mpc_tpu_torch.estimators import base, batch, direct, kalman
from mujoco_mpc_tpu_torch.estimators import unscented
from mujoco_mpc_tpu_torch.physics import forward as fwd
from mujoco_mpc_tpu_torch.physics import model as model_lib
from mujoco_mpc_tpu_torch.physics import sensors
from tests.test_direct import XML as PENDULUM_XML
from tests.test_estimators import XML as ARM_XML
from tests.test_torch_direct import _window, t64
from tools import export_torch_snapshot as export

torch.set_num_threads(1)

F64 = torch.float64


def _model(xml):
  jm = put_model(mujoco.MjModel.from_xml_string(xml), dtype=jnp.float64)
  return model_lib.from_arrays(*export.model_snapshot(jm), device='cpu',
                               dtype=F64)


def _simulate(m, nsteps, rng):
  """The truth, simulated by the port: (qpos, qvel) a step, the noisy
  joint angles and the controls, as tests/test_estimators.py's."""
  d = model_lib.make_data(m).replace(
      qpos=torch.tensor([[0.3, -0.2]], dtype=F64),
      qvel=torch.tensor([[0.1, 0.0]], dtype=F64))
  truth, meas, ctrls = [], [], []
  for t in range(nsteps):
    u = torch.tensor([[0.2 * np.sin(0.02 * t)]], dtype=F64)
    d = d.replace(ctrl=u)
    y = sensors.sensordata(m, fwd.forward(m, d)).numpy()
    truth.append((d.qpos.numpy()[0], d.qvel.numpy()[0]))
    meas.append(y + 0.001 * rng.standard_normal(y.shape))
    ctrls.append(u)
    d = fwd.step(m, d)
  return truth, meas, ctrls


@pytest.mark.parametrize('update,seed', [(kalman.update, 0),
                                         (unscented.update, 1)])
def test_filters_track_truth(update, seed):
  """From a wrong initial state, each filter locks on to the arm's
  trajectory and stays on it for 100 steps (tests/test_estimators.py's
  bounds)."""
  m = _model(ARM_XML)
  truth, meas, ctrls = _simulate(m, 100, np.random.default_rng(seed))
  state = base.init_state(m, covariance_scale=1.0, process_noise=1e-6,
                          sensor_noise=1e-6)
  tmpl = model_lib.make_data(m)
  est = []
  for y, u in zip(meas, ctrls):
    state = update(m, tmpl, state, u, torch.tensor(y))
    est.append(state.qpos.numpy()[0])
  assert np.abs(est[-1] - truth[-1][0]).max() < 0.05
  if update is kalman.update:
    assert np.abs(est[0] - truth[0][0]).max() < 0.05
    assert np.abs(state.qvel.numpy()[0] - truth[-1][1]).max() < 0.2


def test_batch_estimator_tracks():
  """test_direct.py's batch test: a 6-window over 30 noisy measurements
  ends within 0.05 of the truth."""
  m = _model(PENDULUM_XML)
  horizon = 6
  qpos_true, meas, forces, times = _window(m, 30, 0.005,
                                           np.random.default_rng(4))
  p = direct.make_problem(m, model_lib.make_data(m), horizon)
  s = direct.default_settings(p).replace(
      sensor_weight=t64([1e4, 1e2]), force_weight=t64([1e2]),
      prior_weight=t64(1e-3), max_iterations=4)
  state = batch.init_state(p, scale_prior=1e-3)
  state = state.replace(times=t64(times[:horizon]) - horizon * 0.01)
  for t in range(30):
    state, info = batch.update(p, state, s, t64(meas[t]), t64(forces[t]),
                               t64(times[t]), t64(0.01))
  est = float(info['qpos_estimate'][0])
  assert abs(est - float(qpos_true[-2, 0])) < 0.05
