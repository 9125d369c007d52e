"""The port's frictionloss rows against the JAX package and MuJoCo, float64.

The chain and contact models of tests/test_frictionloss.py (a slider and
a limited hinge with frictionloss 0.7 and 0.3; a free box on a plane
with a frictionloss hinge arm), compiled by the JAX package's put_model
and carried into the port as the snapshot tool carries a task's model.
* constraint._friction_rows (one-hot rows, aref = -B v, D at pos 0) and
  forward's qacc against JAX's and against mj_forward, in the stick
  (quadratic), creep and sliding (clamped) zones, beside an engaged
  joint limit and beside pyramidal contacts;
* torch.func.jacfwd of qacc through NewtonSolve's tangent (the quadratic
  zone's rows in H, the clamped zones' force constant) against
  jax.jacfwd of JAX's forward, in both zones.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu.physics import constraint as jconstraint
from mujoco_mpc_tpu.physics import forward as jforward
from mujoco_mpc_tpu.physics.model import make_data as jmake_data
from mujoco_mpc_tpu.physics.model import put_model
from mujoco_mpc_tpu_torch.physics import constraint
from mujoco_mpc_tpu_torch.physics import forward as fwd
from mujoco_mpc_tpu_torch.physics import model as model_lib
from tests.test_frictionloss import CHAIN_XML, CONTACT_XML
from tools import export_torch_snapshot as export

torch.set_num_threads(1)

CASES = {
    'static': (CHAIN_XML, None, (0.0, 0.0), (0.1, 0.0)),
    'creep': (CHAIN_XML, None, (0.001, 0.0), None),
    'sliding': (CHAIN_XML, None, (0.5, -0.2), None),
    'fast': (CHAIN_XML, None, (5.0, 3.0), (1.0, -0.5)),
    'limit': (CHAIN_XML, (0.0, 1.02), (0.3, 0.5), None),
    'contacts': (CONTACT_XML, None, (0.5, 0.1, 0, 0, 0, 0.3, 2.0), None),
}


@pytest.fixture(scope='module')
def models():
  """xml -> (mujoco model, JAX model, the port's model, JAX's forward of
  (qpos, qvel, qfrc_applied) jitted once, its qacc's jacfwd in qvel
  jitted once), float64."""
  out = {}
  for xml in (CHAIN_XML, CONTACT_XML):
    mjm = mujoco.MjModel.from_xml_string(xml)
    jm = put_model(mjm, dtype=jnp.float64)
    arrays, static = export.model_snapshot(jm)
    jd0 = jmake_data(jm, dtype=jnp.float64)

    def run(q, v, f, jm=jm, jd0=jd0):
      jd = jforward.forward(jm, jd0.replace(qpos=q, qvel=v, qfrc_applied=f))
      return jd, jconstraint._friction_rows(jm, jd)

    def qacc(v, jm=jm, jd0=jd0):
      return jforward.forward(jm, jd0.replace(qvel=v)).qacc
    out[xml] = (mjm, jm, model_lib.from_arrays(
        arrays, static, device='cpu', dtype=torch.float64), jax.jit(run),
                jax.jit(jax.jacfwd(qacc)))
  return out


def _state(mjm, qpos, qvel, qfrc):
  mjd = mujoco.MjData(mjm)
  for dst, src in ((mjd.qpos, qpos), (mjd.qvel, qvel),
                   (mjd.qfrc_applied, qfrc)):
    if src is not None:
      dst[:len(src)] = src
  mujoco.mj_forward(mjm, mjd)
  return mjd


@pytest.mark.parametrize('case', list(CASES))
def test_forward_matches_jax_and_mujoco(models, case):
  xml, qpos, qvel, qfrc = CASES[case]
  mjm, _, m, jrun, _ = models[xml]
  mjd = _state(mjm, qpos, qvel, qfrc)
  state = {k: np.asarray(getattr(mjd, k)) for k in ('qpos', 'qvel',
                                                     'qfrc_applied')}
  jd, jrows = jrun(*(jnp.asarray(state[k]) for k in ('qpos', 'qvel',
                                                     'qfrc_applied')))
  d = fwd.forward(m, model_lib.make_data(m).replace(
      **{k: torch.from_numpy(v)[None] for k, v in state.items()}))
  rows = constraint._friction_rows(m, d)
  np.testing.assert_array_equal(rows.dof.numpy(), m.friction_dof)
  for k in ('aref', 'd', 'loss'):
    got = getattr(rows, k)
    np.testing.assert_allclose(got.numpy().reshape(-1),
                               np.asarray(getattr(jrows, k)), rtol=1e-12,
                               atol=1e-12, err_msg=k)
  np.testing.assert_allclose(d.qacc[0].numpy(), np.asarray(jd.qacc),
                             rtol=1e-10, atol=1e-10)
  np.testing.assert_allclose(d.qfrc_constraint[0].numpy(),
                             np.asarray(jd.qfrc_constraint), rtol=1e-10,
                             atol=1e-10)
  scale = max(1.0, float(np.abs(mjd.qacc).max()))
  assert float(np.abs(d.qacc[0].numpy() - mjd.qacc).max()) / scale < 1e-8


@pytest.mark.parametrize('qvel', [(0.001, 0.0), (0.5, -0.2)])
def test_jacfwd_through_friction_rows(models, qvel):
  """d qacc / d qvel at a stick (quadratic) and a sliding (clamped)
  state, as tests/test_frictionloss.py:107 takes JAX's."""
  _, _, m, _, jjac = models[CHAIN_XML]
  want = jjac(jnp.asarray(qvel, dtype=jnp.float64))
  d0 = model_lib.make_data(m)
  got = torch.func.jacfwd(lambda qv: fwd.forward(
      m, d0.replace(qvel=qv[None])).qacc[0])(
          torch.tensor(qvel, dtype=torch.float64))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8,
                             atol=1e-10)
