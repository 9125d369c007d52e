"""The port's equality constraints, RK4 and gravity compensation against the
JAX package and MuJoCo, float64 on the CPU.

The models of tests/test_equality.py, PENDULUM of
tests/test_physics_golden.py with integrator RK4 (and with a joint
limit), and the slice's own gravity-compensation and cable-and-weld
models (tools/export_torch_snapshot.py GRAVCOMP_XML, CABLE_WELD_XML),
carried as assets/physics_models.npz; JAX's references in
assets/physics_features_golden.npz (see tests/test_torch_convex_pairs.py).
* connect, weld (torquescale), joint and fixed-tendon couplings: the rows'
  J, pos, aref (with the velocity bias Jdot qvel) and D against JAX's
  _equality_rows and qacc against JAX's forward (rtol 1e-8, atol 1e-10),
  qacc against mj_forward (atol 1e-8, the weld 1e-6, rtol 1e-6) and the
  trajectories against mj_step over 150 steps (the weld 100; qpos 1e-6,
  the weld 1e-5; qvel ten times that), as tests/test_equality.py;
* RK4 over 50 steps against mj_step (1e-7), as
  test_physics_golden.py::test_rk4;
* gravity compensation: qfrc_passive against mj_forward (1e-10) and JAX's
  (rtol 1e-8, atol 1e-10), and 100 steps against mj_step (1e-6);
* torch.func.jacfwd of the step in (qvel, ctrl) through a tendon actuator,
  an engaged tendon limit and a weld against jax.jacfwd of JAX's (rtol
  1e-8, atol 1e-10);
* each model's trajectory at 4 states against JAX's for 20 steps (rtol
  1e-7, atol 1e-9; where rows stay active rtol 1e-6, atol 5e-7, see
  tests/test_torch_convex_pairs.py SOLVER_BOUND);
* a tendon equality on a spatial tendon is refused, as put_model refuses
  it.
"""

import mujoco
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu_torch.physics import constraint
from mujoco_mpc_tpu_torch.physics import forward as fwd
from tests.test_torch_convex_pairs import (check_golden_forward,
                                           check_golden_trajectory,
                                           golden_file, initial_state, names,
                                           port_data, port_model,
                                           roll_with_mujoco, xmls)

torch.set_num_threads(1)

# model: (forward atol against MuJoCo, trajectory steps, qpos atol, the
# controls of its test's trajectory)
EQUALITY = {
    'connect': (1e-8, 150, 1e-6, None),
    'weld': (1e-6, 100, 1e-5, None),
    'joint_coupling': (1e-8, 150, 1e-6, lambda i: [0.4 * np.sin(0.05 * i)]),
    'tendon_coupling': (1e-8, 150, 1e-6, lambda i: [0.5 * np.cos(0.04 * i)]),
}


@pytest.mark.parametrize('name', sorted(EQUALITY))
def test_equality_forward_and_trajectory(name):
  atol_fwd, steps, atol, ctrl_fn = EQUALITY[name]
  m = port_model(name)
  qpos, qvel, ctrl = initial_state(name)
  mjm = mujoco.MjModel.from_xml_string(xmls()[name])
  mjd = mujoco.MjData(mjm)
  mjd.qpos[:], mjd.qvel[:], mjd.ctrl[:] = qpos, qvel, ctrl
  mujoco.mj_forward(mjm, mjd)
  d = check_golden_forward(name, ('qacc', 'qfrc_constraint'))
  np.testing.assert_allclose(d.qacc[0].numpy(), mjd.qacc, atol=atol_fwd,
                             rtol=1e-6)
  rows = constraint._equality_rows(m, d)
  assert rows.equality.all() and rows.active.all()
  check_golden_forward(name, ('j', 'pos', 'aref', 'd'), rows, key='eq')
  mjd, d = roll_with_mujoco(name, steps, ctrl_fn)
  np.testing.assert_allclose(d.qpos[0].numpy(), mjd.qpos, atol=atol)
  np.testing.assert_allclose(d.qvel[0].numpy(), mjd.qvel, atol=atol * 10)


def test_rk4():
  m = port_model('pendulum_rk4')
  assert m.opt.integrator == 1
  mjd, d = roll_with_mujoco('pendulum_rk4', 50)
  np.testing.assert_allclose(d.qpos[0].numpy(), mjd.qpos, atol=1e-7)
  np.testing.assert_allclose(d.qvel[0].numpy(), mjd.qvel, atol=1e-7)


def test_gravcomp_matches_jax_and_mujoco():
  name = 'gravcomp_chain'
  m = port_model(name)
  assert m.any_gravcomp
  rng = np.random.default_rng(5)
  qpos, qvel, _ = initial_state(name)
  qpos = qpos + 0.2 * rng.standard_normal(qpos.shape)
  qpos[3:7] /= np.linalg.norm(qpos[3:7])
  qvel = 0.5 * rng.standard_normal(qvel.shape)
  mjm = mujoco.MjModel.from_xml_string(xmls()[name])
  mjd = mujoco.MjData(mjm)
  mjd.qpos[:], mjd.qvel[:] = qpos, qvel
  mujoco.mj_forward(mjm, mjd)
  d = fwd.forward(m, port_data(name, qpos, qvel, np.zeros(2)))
  np.testing.assert_allclose(d.qfrc_passive[0].numpy(), mjd.qfrc_passive,
                             atol=1e-10)
  check_golden_forward(name, ('qfrc_passive', 'qacc'))
  mjd, d = roll_with_mujoco(name, 100, ctrl_fn=lambda i: [0.3, -0.2])
  np.testing.assert_allclose(d.qpos[0].numpy(), mjd.qpos, atol=1e-6)


def test_jacfwd_through_tendon_limit_and_weld():
  """d (qpos', qvel') / d (qvel, ctrl) of one step of CABLE_WELD_XML at
  its state (the cable's upper limit engaged, the weld's six rows), as
  the derivative planners take it, against jax.jacfwd."""
  name = 'cable_weld'
  m = port_model(name)
  qpos, qvel, ctrl = initial_state(name)
  d0 = port_data(name, qpos, qvel, ctrl)
  d = fwd.forward(m, d0)
  lim = constraint._tendon_limit_rows(m, d)
  assert bool(lim.active.any())
  assert constraint._equality_rows(m, d).j.shape[1] == 6

  def step(v, u):
    out = fwd.step(m, d0.replace(qvel=v[None], ctrl=u[None]))
    return out.qpos[0], out.qvel[0]
  jac = torch.func.jacfwd(step, argnums=(0, 1))(
      torch.from_numpy(qvel), torch.from_numpy(ctrl))
  g = golden_file()
  for a, o in enumerate(('qpos', 'qvel')):
    for b, i in enumerate(('qvel', 'ctrl')):
      np.testing.assert_allclose(jac[a][b].numpy(),
                                 g[f'{name}/jac/{o}_{i}'], rtol=1e-8,
                                 atol=1e-10, err_msg=f'd {o} / d {i}')


def test_tendon_equality_on_a_spatial_tendon_is_refused():
  """As JAX's put_model refuses it (model.py:546-553): the coupling's
  residual reads fixed tendons' constant maps."""
  import json
  from mujoco_mpc_tpu_torch import convert
  from mujoco_mpc_tpu_torch.physics import model as model_lib
  from tests.test_torch_convex_pairs import models_file
  z = models_file()
  static = json.loads(str(z['tendon_coupling/static']))
  static['ten_spatial'] = [[[1.0, [['s', 0], ['s', 0]]]], []]
  with pytest.raises(NotImplementedError, match='spatial tendon 0'):
    model_lib.from_arrays(convert.group(z, 'tendon_coupling/model/'), static,
                          device='cpu', dtype=torch.float64)


@pytest.mark.parametrize('name', names('equality') + names('rk4')
                         + names('gravcomp'))
def test_trajectory_matches_jax(name):
  check_golden_trajectory(name)
