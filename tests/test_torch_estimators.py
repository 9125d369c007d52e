"""The port's EKF, UKF and ground-truth estimator against the JAX package,
float64 on the CPU.

* One update at a time from the same EstimatorState (carried across by
  convert.estimator_state_from_arrays): EKF, UKF and ground truth on the
  two-link arm of tests/test_estimators.py (atol 1e-10), and the EKF on a
  free sphere resting on a plane with a hinged arm (jointpos and
  framepos sensors), where the contact's Newton tangent
  (ops/newton.NewtonSolve) runs inside the Jacobians (atol 1e-8: both
  Newton solves stop at tolerance 1e-8). JAX's updates are jitted as one
  function a model, with XLA's quick compile options (its EKF on the
  contact model alone compiles for ~24 s here), and replayed from
  assets/estimators_jax_calls_golden.npz (tests/torch_recorded.py
  RecordedJax; record anew with MJPC_TORCH_RECORD=1 in one process; the
  slow test_jax_calls_golden_is_jaxs makes them live).
* Batch-first: two filters in one call equal each filter alone.
* Quadruped Flat: one EKF and one UKF update held to
  assets/quadruped_flat_estimators_golden.npz, written by the JAX package
  (tools/export_torch_snapshot.py --estimator-golden; atol 1e-8 on the
  state, 1e-10 on the covariance). `test_golden_is_jaxs` (marked slow)
  recomputes it from JAX live. The golden measures sensors 6-9 (20
  columns): JAX's gain solve fails above 24 columns (see the tool).
"""

import os

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu.estimators import base as jbase
from mujoco_mpc_tpu.estimators import kalman as jkalman
from mujoco_mpc_tpu.estimators import unscented as junscented
from mujoco_mpc_tpu.physics.model import make_data as jmake_data
from mujoco_mpc_tpu.physics.model import put_model
from mujoco_mpc_tpu_torch import convert
from mujoco_mpc_tpu_torch.estimators import base, kalman, unscented
from mujoco_mpc_tpu_torch.physics import model as model_lib
from mujoco_mpc_tpu_torch.tasks import registry
from tests.test_estimators import XML as ARM_XML
from tests.torch_recorded import RecordedJax
from tools import export_torch_snapshot as export

torch.set_num_threads(1)

F64 = torch.float64
JAX_CALLS = 'estimators_jax_calls_golden.npz'
QUICK = {'xla_backend_optimization_level': 0,
         'xla_llvm_disable_expensive_passes': True}

# a free sphere pressed 2 mm into a plane, a hinged arm on top
BALL_XML = """
<mujoco>
  <option timestep="0.005" gravity="0 0 -9.81"/>
  <worldbody>
    <geom name="floor" type="plane" size="2 2 0.1"/>
    <body name="ball" pos="0 0 0.098">
      <freejoint/>
      <geom name="ball_g" type="sphere" size="0.1" mass="1"/>
      <site name="c" pos="0 0 0"/>
      <body name="arm" pos="0 0 0.1">
        <joint name="h" type="hinge" axis="0 1 0" damping="0.05"/>
        <geom type="capsule" size="0.02" fromto="0 0 0 0.2 0 0" mass="0.1"
              contype="0" conaffinity="0"/>
      </body>
    </body>
  </worldbody>
  <actuator><motor joint="h" gear="1"/></actuator>
  <sensor>
    <jointpos name="jp" joint="h"/>
    <framepos name="fp" objtype="site" objname="c"/>
  </sensor>
</mujoco>
"""


def _jax_updates(jm, jt, contact):
  """JAX's EKF, UKF and ground-truth updates (the EKF alone on the
  contact model) as one jitted function."""
  def run(s, u, y):
    if contact:
      return (jkalman.update(jm, jt, s, u, y),)
    return (jkalman.update(jm, jt, s, u, y), junscented.update(jm, jt, s, u, y),
            jbase.ground_truth_update(jm, jt, s, u))
  s = jbase.init_state(jm, dtype=jnp.float64)
  return jax.jit(run).lower(s, jnp.zeros(jm.nu),
                            jnp.zeros(jm.nsensordata)).compile(
                                compiler_options=QUICK)


@pytest.fixture(scope='module')
def raw_models():
  """name -> (JAX model, JAX template, the port's model)."""
  out = {}
  for name, xml in (('arm', ARM_XML), ('ball', BALL_XML)):
    jm = put_model(mujoco.MjModel.from_xml_string(xml), dtype=jnp.float64)
    jt = jmake_data(jm, dtype=jnp.float64)
    out[name] = (jm, jt, model_lib.from_arrays(*export.model_snapshot(jm),
                                               device='cpu', dtype=F64))
  return out


@pytest.fixture(scope='module')
def jax_calls(raw_models):
  """JAX's updates of each model (_jax_updates), replayed from
  JAX_CALLS."""
  rec = RecordedJax(os.path.join(registry.ASSETS, JAX_CALLS), lambda: {
      name: _jax_updates(jm, jt, name == 'ball')
      for name, (jm, jt, _) in raw_models.items()})
  yield rec
  if rec.recording:
    rec.save()


@pytest.fixture(scope='module')
def models(raw_models, jax_calls):
  """name -> (JAX model, JAX template, the port's model, JAX's updates)."""
  return {name: v + (lambda s, u, y, name=name: jax_calls(name, s, u, y),)
          for name, v in raw_models.items()}


def _fields(state):
  return {f: np.asarray(getattr(state, f)) for f in export.ESTIMATOR_FIELDS}


def _start(jm, name):
  """A JAX filter state off the model's rest state (numpy, seeded), its
  controls and measurements."""
  rng = np.random.default_rng(5)
  s = jbase.init_state(jm, dtype=jnp.float64, covariance_scale=1e-2,
                       process_noise=1e-6, sensor_noise=1e-6)
  dx = 0.05 * rng.normal(size=jbase.ndx(jm))
  qp, qv, a = jbase.perturb(jm, s.qpos, s.qvel, s.act, jnp.asarray(dx))
  u = 0.2 * rng.normal(size=jm.nu)
  y = 0.01 * rng.normal(size=jm.nsensordata)
  if name == 'ball':     # measurements near the sphere's rest
    y[1:] += np.asarray(jm.qpos0[:3])
  return s.replace(qpos=qp, qvel=qv, act=a), u, y


@pytest.mark.parametrize('name,atol', [('arm', 1e-10), ('ball', 1e-8)])
def test_updates_match_jax(models, name, atol):
  """EKF, UKF and ground truth (the EKF on the contact model), one update
  from the same state."""
  jm, _, m, jax_updates = models[name]
  js, u, y = _start(jm, name)
  want = jax_updates(js, jnp.asarray(u), jnp.asarray(y))
  state = convert.estimator_state_from_arrays(_fields(js), device='cpu',
                                              dtype=F64)
  tmpl = model_lib.make_data(m)
  ut, yt = torch.tensor(u)[None], torch.tensor(y)[None]
  got = (kalman.update(m, tmpl, state, ut, yt),
         unscented.update(m, tmpl, state, ut, yt),
         base.ground_truth_update(m, tmpl, state, ut))
  for g, w in zip(got, want):   # zip: the EKF alone on the contact model
    for f in ('qpos', 'qvel', 'time', 'covariance'):
      np.testing.assert_allclose(getattr(g, f).numpy()[0],
                                 np.asarray(getattr(w, f)), atol=atol,
                                 err_msg=f)


def test_ekf_hands_the_kernels_contiguous_operands(models, monkeypatch):
  """One filter's Jacobians fold its ndx tangent directions into the
  kernels' batch: the folded operands must be contiguous (the kernels
  refuse the stride-0 view that an unmapped operand of batch 1 folds to),
  whatever batch they reach the dispatch at."""
  from mujoco_mpc_tpu_torch.ops import newton, spd_solve
  _, _, m, _ = models['arm']
  seen = []

  def contiguous(dispatch):
    def run(*args, **kw):
      seen.append(args[1].shape[0])
      assert all(t.is_contiguous() for t in args), [
          (tuple(t.shape), t.stride()) for t in args]
      return dispatch(*args, **kw)
    return run
  monkeypatch.setattr(spd_solve, '_solve', contiguous(spd_solve._solve))
  monkeypatch.setattr(newton, '_newton', contiguous(newton._newton))
  state = base.init_state(m, covariance_scale=1e-2)
  kalman.update(m, model_lib.make_data(m), state,
                torch.zeros((1, m.nu), dtype=F64),
                torch.zeros((1, m.nsensordata), dtype=F64))
  assert set(seen) == {1, base.ndx(m)}


def test_filters_are_batch_first(models):
  """Two filters in one call give what each gives alone."""
  jm, _, m, _ = models['ball']
  tmpl = model_lib.make_data(m)
  states, inputs = [], []
  for seed in (1, 2):
    rng = np.random.default_rng(seed)
    s = base.init_state(m, covariance_scale=1e-2)
    dx = torch.tensor(0.02 * rng.normal(size=(1, base.ndx(m))))
    states.append(s.replace(qpos=base.perturb(m, s.qpos, s.qvel, s.act,
                                              dx)[0]))
    inputs.append((torch.tensor(0.2 * rng.normal(size=(1, m.nu))),
                   torch.tensor(0.01 * rng.normal(size=(1, 4)))))
  both = base.EstimatorState(**{
      f: torch.cat([getattr(s, f) for s in states])
      for f in export.ESTIMATOR_FIELDS})
  u2 = torch.cat([i[0] for i in inputs])
  y2 = torch.cat([i[1] for i in inputs])
  for update in (kalman.update, unscented.update):
    pair = update(m, tmpl, both, u2, y2)
    for b in range(2):
      one = update(m, tmpl, states[b], *inputs[b])
      for f in ('qpos', 'qvel', 'covariance'):
        np.testing.assert_allclose(getattr(pair, f).numpy()[b],
                                   getattr(one, f).numpy()[0], atol=1e-12)


GOLDEN = os.path.join(registry.ASSETS, export.ESTIMATOR_GOLDEN)


def _golden():
  with np.load(GOLDEN) as z:
    return {k: z[k] for k in z.files}


def test_quadruped_updates_match_the_golden():
  """One EKF and one UKF update on Quadruped Flat (nv 18, ndx 36, the
  condim-3 foot contacts in the Jacobians) from the golden's state,
  against JAX's."""
  g = _golden()
  spec = registry.get_task('Quadruped Flat', device='cpu', dtype=F64)
  m = spec.model
  state = convert.estimator_state_from_arrays(
      {f: g['state/' + f] for f in export.ESTIMATOR_FIELDS}, device='cpu',
      dtype=F64)
  u, y = torch.tensor(g['ctrl'])[None], torch.tensor(g['sensor'])[None]
  tmpl = model_lib.make_data(m)
  for name, update in (('ekf', kalman.update), ('ukf', unscented.update)):
    new = update(m, tmpl, state, u, y, export.ESTIMATOR_SLICE)
    for f, atol in (('qpos', 1e-8), ('qvel', 1e-8), ('time', 1e-12),
                    ('covariance', 1e-10)):
      np.testing.assert_allclose(getattr(new, f).numpy()[0],
                                 g[f'{name}/{f}'], atol=atol,
                                 err_msg=f'{name} {f}')


@pytest.mark.slow
def test_jax_calls_golden_is_jaxs(jax_calls):
  """The recorded JAX updates are what the JAX package computes now."""
  jax_calls.check_live()


@pytest.mark.slow
def test_golden_is_jaxs():
  """The committed golden is what the JAX package computes now."""
  g = _golden()
  jm = export.jax_quadruped_f64()
  inputs = export.estimator_golden_inputs(jm)
  for k, v in inputs.items():
    np.testing.assert_allclose(v, g[k], atol=1e-12, err_msg=k)
  for k, v in export.jax_estimator_golden(jm, inputs).items():
    np.testing.assert_allclose(v, g[k], atol=1e-12, err_msg=k)
