"""The port's block-banded solves, direct optimizer and batch estimator
against dense oracles and the JAX package, float64 on the CPU.

Mirrors tests/test_banded.py, test_direct.py, test_direct_parameters.py
and test_estimators.py:111-177:
* ops/banded: the block-tridiagonal and block-pentadiagonal solves
  against numpy's dense solve (rtol 1e-5, atol 1e-7, as JAX's test) and
  JAX's (atol 1e-12); a factor that fails reads NaN, as JAX's does;
* direct: the banded Gauss-Newton system against the dense jacfwd
  construction (atol 1e-8, as JAX's test); optimize's cost trace and
  iterate against JAX's (rtol 1e-9, atol 1e-10) on test_direct.py's
  pendulum window, and its smoothing beating the raw measurements;
  optimize_joint's damping recovery against JAX's (rtol 1e-6) and ln 1.6
  (rtol 0.15, as JAX's test);
* batch: marginalize_prior against the dense Schur complement (rtol 1e-5,
  atol 1e-8, as JAX's test) and JAX's; update with and without the
  recursive prior against JAX's from the same BatchState (carried across
  by convert.batch_state_from_arrays; rtol 1e-8). Tracking is in
  tests/test_torch_tracking.py.
JAX's optimize, optimize_joint and the batch update (with the recursive
prior) are jitted once each (no contact model here), with XLA's quick
compile options, and replayed from assets/direct_jax_calls_golden.npz
(tests/torch_recorded.py RecordedJax; record anew with
MJPC_TORCH_RECORD=1 in one process; the slow
test_jax_calls_golden_is_jaxs makes them live).
"""

import os


import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu.estimators import batch as jbatch
from mujoco_mpc_tpu.estimators import direct as jdirect
from mujoco_mpc_tpu.ops import banded as jbanded
from mujoco_mpc_tpu.physics.model import make_data as jmake_data
from mujoco_mpc_tpu.physics.model import put_model
from mujoco_mpc_tpu_torch import convert
from mujoco_mpc_tpu_torch.estimators import batch, direct
from mujoco_mpc_tpu_torch.ops import banded
from mujoco_mpc_tpu_torch.physics import forward as fwd
from mujoco_mpc_tpu_torch.physics import model as model_lib
from mujoco_mpc_tpu_torch.physics import sensors
from tests.test_banded import _dense_from_blocks, _random_block_tridiag
from tests.test_direct import XML as PENDULUM_XML
from tests.test_direct_parameters import _XML as DAMPED_XML
from mujoco_mpc_tpu_torch.tasks.registry import ASSETS
from tests.torch_recorded import RecordedJax
from tools import export_torch_snapshot as export

torch.set_num_threads(1)

JAX_CALLS = 'direct_jax_calls_golden.npz'

F64 = torch.float64
QUICK = {'xla_backend_optimization_level': 0,
         'xla_llvm_disable_expensive_passes': True}
t64 = lambda x: torch.tensor(np.asarray(x), dtype=F64)  # noqa: E731


def _jit(fn, *args):
  return jax.jit(fn).lower(*args).compile(compiler_options=QUICK)


def test_block_tridiag_solve_matches_dense_and_jax():
  T, n = 8, 5
  diag, lower = _random_block_tridiag(T, n)
  b = np.random.RandomState(1).randn(T, n)
  ld, ll = banded.block_tridiag_cholesky(t64(diag), t64(lower))
  x = banded.block_tridiag_solve(ld, ll, t64(b)).numpy()
  want = np.linalg.solve(_dense_from_blocks(diag, lower),
                         b.reshape(-1)).reshape(T, n)
  np.testing.assert_allclose(x, want, rtol=1e-5, atol=1e-7)
  jld, jll = jbanded.block_tridiag_cholesky(jnp.asarray(diag),
                                            jnp.asarray(lower))
  np.testing.assert_allclose(ld.numpy(), np.asarray(jld), atol=1e-12)
  np.testing.assert_allclose(ll.numpy(), np.asarray(jll), atol=1e-12)
  np.testing.assert_allclose(
      x, np.asarray(jbanded.block_tridiag_solve(jld, jll, jnp.asarray(b))),
      atol=1e-12)


def test_block_pentadiag_solve_matches_dense_and_jax():
  T, n = 8, 4
  rng = np.random.RandomState(2)
  diag, lower = _random_block_tridiag(T, n, seed=3)
  diag = diag + 10 * np.eye(n)
  off2 = rng.randn(T - 2, n, n) * 0.2
  b = rng.randn(T, n)
  x = banded.block_pentadiag_solve(t64(diag), t64(lower), t64(off2),
                                   t64(b)).numpy()
  want = np.linalg.solve(_dense_from_blocks(diag, lower, off2),
                         b.reshape(-1)).reshape(T, n)
  np.testing.assert_allclose(x, want, rtol=1e-5, atol=1e-7)
  sd, sl = banded.pentadiag_to_superblocks(t64(diag), t64(lower), t64(off2))
  jsd, jsl = jbanded.pentadiag_to_superblocks(
      jnp.asarray(diag), jnp.asarray(lower), jnp.asarray(off2))
  np.testing.assert_array_equal(sd.numpy(), np.asarray(jsd))
  np.testing.assert_array_equal(sl.numpy(), np.asarray(jsl))
  np.testing.assert_allclose(x, np.asarray(jbanded.block_pentadiag_solve(
      *(jnp.asarray(a) for a in (diag, lower, off2, b)))), atol=1e-12)


def test_failed_factor_reads_nan_as_jaxs():
  """A block that is not positive definite gives NaN (JAX's cholesky);
  the direct optimizer's line search reads it as an infinite cost."""
  diag, lower = _random_block_tridiag(4, 3)
  diag[2] = -np.eye(3)
  ld, _ = banded.block_tridiag_cholesky(t64(diag), t64(lower))
  jld, _ = jbanded.block_tridiag_cholesky(jnp.asarray(diag),
                                          jnp.asarray(lower))
  np.testing.assert_array_equal(np.isnan(ld.numpy()),
                                np.isnan(np.asarray(jld)))
  assert np.isnan(ld.numpy()[2:]).any()
  np.testing.assert_allclose(ld.numpy()[:2], np.asarray(jld)[:2],
                             atol=1e-12)


def _models(xml):
  mjm = mujoco.MjModel.from_xml_string(xml)
  jm = put_model(mjm, dtype=jnp.float64)
  m = model_lib.from_arrays(*export.model_snapshot(jm), device='cpu',
                            dtype=F64)
  return jm, m


def _window(m, horizon, noise, rng):
  """test_direct.py's window, simulated by the port: the pendulum from
  (0.4, -0.3) under u = 0.3 sin(0.3 t); (qpos, noisy jointpos and
  jointvel, forces, times)."""
  d = model_lib.make_data(m).replace(qpos=t64([[0.4]]), qvel=t64([[-0.3]]))
  qpos, meas, forces, times = [], [], [], []
  for t in range(horizon):
    u = 0.3 * np.sin(0.3 * t)
    d = d.replace(ctrl=t64([[u]]))
    qpos.append(d.qpos.numpy()[0])
    meas.append(sensors.sensordata(m, fwd.forward(m, d)).numpy()[0]
                + noise * rng.standard_normal(2))
    forces.append([u])
    times.append(float(d.time[0]))
    d = fwd.step(m, d)
  return tuple(np.asarray(a) for a in (qpos, meas, forces, times))


PENDULUM_WEIGHTS = dict(sensor_weight=[1e4, 1e2], force_weight=[1e2])
BATCH_WEIGHTS = dict(sensor_weight=[1e4, 1e2], force_weight=[1e2],
                     prior_weight=0.1)


def _jax_problem(xml, horizon, weights, iterations):
  """JAX's float64 problem and settings of a model's window."""
  jm = put_model(mujoco.MjModel.from_xml_string(xml), dtype=jnp.float64)
  jp = jdirect.make_problem(jm, jmake_data(jm, dtype=jnp.float64), horizon)
  js = jdirect.default_settings(jp, dtype=jnp.float64).replace(
      **{k: jnp.asarray(v, jnp.float64) for k, v in weights.items()},
      max_iterations=iterations)
  return jm, jp, js


def _jax_optimize(jdata):
  """JAX's optimize of the pendulum's 10-step window."""
  _, jp, js = _jax_problem(PENDULUM_XML, 10, PENDULUM_WEIGHTS, 4)
  return _jit(lambda d: jdirect.optimize(jp, d, js), jdata)(jdata)


def _jax_optimize_joint(jdata):
  """JAX's optimize_joint of the damped model's 12-step window."""
  jm, jp, js = _jax_problem(DAMPED_XML, 12, {}, 12)
  return _jit(lambda d: jdirect.optimize_joint(
      jp, d, js, jdirect.damping_parameter_model(jm.nv), jnp.zeros(1)),
              jdata)(jdata)


def _jax_batch_update(jstate, *new):
  """JAX's batch update with the recursive prior of the pendulum's
  4-window."""
  _, jp, js = _jax_problem(PENDULUM_XML, 4, BATCH_WEIGHTS, 3)
  return _jit(lambda st: jbatch.update(jp, st, js, *new, jnp.asarray(0.01),
                                       recursive_prior=True),
              jstate)(jstate)


@pytest.fixture(scope='module')
def jax_calls():
  rec = RecordedJax(os.path.join(ASSETS, JAX_CALLS), lambda: {
      'optimize': _jax_optimize, 'optimize_joint': _jax_optimize_joint,
      'batch_update': _jax_batch_update})
  yield rec
  if rec.recording:
    rec.save()


@pytest.mark.slow
def test_jax_calls_golden_is_jaxs(jax_calls):
  """The recorded JAX calls are what the JAX package computes now."""
  jax_calls.check_live()


@pytest.fixture(scope='module')
def pendulum():
  """(JAX model, the port's model, JAX's and the port's problems and
  data, settings, the true configurations) for a 10-step window."""
  jm, m = _models(PENDULUM_XML)
  qpos, meas, forces, times = _window(m, 10, 0.01,
                                      np.random.default_rng(3))
  jp = jdirect.make_problem(jm, jmake_data(jm, dtype=jnp.float64), 10)
  p = direct.make_problem(m, model_lib.make_data(m), 10)
  js = jdirect.default_settings(jp, dtype=jnp.float64).replace(
      **{k: jnp.asarray(v, jnp.float64)
         for k, v in PENDULUM_WEIGHTS.items()}, max_iterations=4)
  s = direct.default_settings(p).replace(
      **{k: t64(v) for k, v in PENDULUM_WEIGHTS.items()}, max_iterations=4)
  arrays = dict(qpos_ref=meas[:, :1], sensor_meas=meas, force_meas=forces,
                times=times)
  jdata = jdirect.DirectData(**{k: jnp.asarray(v) for k, v in arrays.items()})
  data = direct.DirectData(**{k: t64(v) for k, v in arrays.items()})
  return jm, m, jp, p, jdata, data, js, s, qpos


def test_banded_normal_equations_match_dense_and_jax(pendulum):
  _, m, _, p, _, data, _, s, _ = pendulum
  z = t64(np.random.RandomState(0).randn(10 * m.nv) * 0.01)
  diag, off1, off2, g = direct._banded_normal_equations(p, data, z, s)
  jac = torch.func.jacfwd(lambda zz: direct.residuals(p, data, zz, s))(z)
  r = direct.residuals(p, data, z, s)
  h = (jac.T @ jac).numpy()
  np.testing.assert_allclose(g.numpy().reshape(-1), (jac.T @ r).numpy(),
                             atol=1e-8)
  nv = m.nv
  blk = lambda i, j: h[i * nv:(i + 1) * nv, j * nv:(j + 1) * nv]  # noqa: E731
  for t in range(10):
    np.testing.assert_allclose(diag[t].numpy(), blk(t, t), atol=1e-8)
  for t in range(9):
    np.testing.assert_allclose(off1[t].numpy(), blk(t + 1, t), atol=1e-8)
  for t in range(8):
    np.testing.assert_allclose(off2[t].numpy(), blk(t + 2, t), atol=1e-8)


def test_optimize_matches_jax_and_smooths(pendulum, jax_calls):
  """Four damped Gauss-Newton iterations: JAX's cost trace and iterate,
  and a window closer to the truth than the measurements."""
  _, _, jp, p, jdata, data, js, s, qpos_true = pendulum
  jz, jinfo = jax_calls('optimize', jdata)
  z, info = direct.optimize(p, data, s)
  np.testing.assert_allclose(info['cost_trace'].numpy(),
                             np.asarray(jinfo['cost_trace']), rtol=1e-9)
  np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-9,
                             atol=1e-10)
  meas = data.sensor_meas.numpy()
  est = info['qpos'].numpy()
  err_before = np.abs(meas[1:-1, 0] - qpos_true[1:-1, 0]).mean()
  err_after = np.abs(est[1:-1, 0] - qpos_true[1:-1, 0]).mean()
  assert err_after < err_before, (err_after, err_before)
  assert float(info['cost_trace'][-1]) < float(info['cost_trace'][0])


def test_optimize_joint_recovers_damping_as_jax(jax_calls):
  """test_direct_parameters.py: a window simulated with damping x 1.6;
  theta (ln of the damping scale) from 0 over 12 iterations."""
  jm, m = _models(DAMPED_XML)
  T = 12
  m_true = m.replace(dof_damping=m.dof_damping * 1.6)
  d = model_lib.make_data(m).replace(qpos=t64([[0.9]]))
  qs, ss = [], []
  for _ in range(T):
    df = fwd.forward(m_true, d)
    qs.append(df.qpos.numpy()[0])
    ss.append(sensors.sensordata(m_true, df).numpy()[0])
    d = fwd.step(m_true, d)
  h = float(m.opt.timestep)
  arrays = dict(qpos_ref=np.stack(qs), sensor_meas=np.stack(ss),
                force_meas=np.zeros((T, m.nv)), times=np.arange(T) * h)
  p = direct.make_problem(m, model_lib.make_data(m), T)
  s = direct.default_settings(p).replace(max_iterations=12)
  z, theta, info = direct.optimize_joint(
      p, direct.DirectData(**{k: t64(v) for k, v in arrays.items()}), s,
      direct.damping_parameter_model(m.nv), torch.zeros(1, dtype=F64))
  assert np.isfinite(float(info['final_cost']))
  np.testing.assert_allclose(float(torch.exp(theta[0])), 1.6, rtol=0.15)

  jdata = jdirect.DirectData(**{k: jnp.asarray(v) for k, v in arrays.items()})
  jz, jtheta, jinfo = jax_calls('optimize_joint', jdata)
  np.testing.assert_allclose(theta.numpy(), np.asarray(jtheta), rtol=1e-6)
  np.testing.assert_allclose(info['cost_trace'].numpy(),
                             np.asarray(jinfo['cost_trace']), rtol=1e-6,
                             atol=1e-14)
  np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-6,
                             atol=1e-10)


def test_site_offset_parameter_model_matches_jax():
  """The site-offset hook moves one site as JAX's does."""
  jm, m = _models(DAMPED_XML)
  theta = np.array([0.01, -0.02, 0.03])
  got = direct.site_offset_parameter_model(0).apply(m, t64(theta))
  want = jdirect.site_offset_parameter_model(0).apply(jm, jnp.asarray(theta))
  np.testing.assert_array_equal(got.site_pos.numpy(),
                                np.asarray(want.site_pos))


def test_marginalize_prior_matches_dense_oracle_and_jax():
  rng = np.random.default_rng(0)
  T, nv = 4, 3
  n = T * nv
  a = rng.standard_normal((n, n))
  h = a @ a.T + n * np.eye(n)
  for i in range(T):
    for j in range(T):
      if abs(i - j) > 2:
        h[i * nv:(i + 1) * nv, j * nv:(j + 1) * nv] = 0.0
  p_diag, p_off1 = batch.marginalize_prior(t64(h), nv, scale_prior=0.5,
                                           damping=0.0)
  hc = h[nv:, nv:] - h[nv:, :nv] @ np.linalg.solve(h[:nv, :nv], h[:nv, nv:])
  for i in range(T - 1):
    np.testing.assert_allclose(p_diag[i].numpy(),
                               hc[i * nv:(i + 1) * nv, i * nv:(i + 1) * nv],
                               rtol=1e-5, atol=1e-8)
  for i in range(T - 2):
    np.testing.assert_allclose(
        p_off1[i].numpy(),
        hc[(i + 1) * nv:(i + 2) * nv, i * nv:(i + 1) * nv], rtol=1e-5,
        atol=1e-8)
  np.testing.assert_allclose(p_diag[T - 1].numpy(), 0.5 * np.eye(nv))
  jd, jo = jbatch.marginalize_prior(jnp.asarray(h), nv, 0.5, damping=0.0)
  np.testing.assert_allclose(p_diag.numpy(), np.asarray(jd), atol=1e-12)
  np.testing.assert_allclose(p_off1.numpy(), np.asarray(jo), atol=1e-12)


def test_batch_updates_match_jax(pendulum, jax_calls):
  """One update of a 4-window, with and without the recursive prior, from
  the same BatchState (a filled window of the pendulum's measurements)."""
  jm, m, _, _, _, data, _, _, _ = pendulum
  T = 4
  jp = jdirect.make_problem(jm, jmake_data(jm, dtype=jnp.float64), T)
  p = direct.make_problem(m, model_lib.make_data(m), T)
  s = direct.default_settings(p).replace(
      **{k: t64(v) for k, v in BATCH_WEIGHTS.items()}, max_iterations=3)
  jstate = jbatch.init_state(jp, dtype=jnp.float64, scale_prior=0.1)
  jstate = jstate.replace(
      qpos_window=jnp.asarray(data.sensor_meas.numpy()[:T, :1]),
      sensor_window=jnp.asarray(data.sensor_meas.numpy()[:T]),
      force_window=jnp.asarray(data.force_meas.numpy()[:T]),
      times=jnp.asarray(data.times.numpy()[:T]), filled=jnp.asarray(T))
  new = [data.sensor_meas[T], data.force_meas[T], data.times[T]]
  jnew = [jnp.asarray(x.numpy()) for x in new]
  # one JAX call: the update without the recursive prior differs from the
  # one with it only in keeping the state's prior
  jst, jinfo = jax_calls('batch_update', jstate, *jnew)
  state = convert.batch_state_from_arrays(
      {f: np.asarray(getattr(jstate, f)) for f in (
          'qpos_window', 'sensor_window', 'force_window', 'times', 'filled',
          'prior_diag', 'prior_off1')}, device='cpu', dtype=F64)
  for rec in (False, True):
    st, info = batch.update(p, state, s, *new, t64(0.01),
                            recursive_prior=rec)
    for f in ('qpos_window', 'times', 'prior_diag', 'prior_off1'):
      want = getattr(jst if rec or not f.startswith('prior') else jstate, f)
      np.testing.assert_allclose(getattr(st, f).numpy(), np.asarray(want),
                                 rtol=1e-8, atol=1e-12, err_msg=f'{f} {rec}')
    assert int(st.filled) == int(jst.filled)
    np.testing.assert_allclose(info['cost_trace'].numpy(),
                               np.asarray(jinfo['cost_trace']), rtol=1e-8)
    if rec:   # the prior absorbed the window's information
      assert np.abs(st.prior_diag.numpy()[0] - 0.1 * np.eye(1)).max() > 1e-3
