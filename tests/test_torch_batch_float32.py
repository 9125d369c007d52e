"""The batch estimator in float32 on Quadruped Flat's window, the port
against the JAX package, on the CPU.

The window is chip_smoke.py phase 30's (its recipe and seeds, simulated
on the CPU): 32 configurations of Quadruped Flat from `home` under the
home controls plus 0.1 sin(2 pi t / 0.4), sensor noise of std 0.01
(sensor weight 1e4), the configurations 1e-3 off the truth, 3
Gauss-Newton iterations. Its normal equations hold force rows of ~M /
h^2 (entries up to ~2e12) beside a unit prior, and in float32 the
block-pentadiagonal factor fails: both packages read the NaN candidates
as infinite cost and raise the damping tenfold an iteration, so no
iteration improves on the start. The port's float32 run must give JAX's
cost trace (rtol 1e-5) and window; in float64 the same window's cost
falls by five orders of magnitude, so float32 alone is why. JAX's float32
update (jitted with XLA's quick options, ~40 s to compile here) is
replayed from assets/batch_float32_jax_calls_golden.npz
(tests/torch_recorded.py RecordedJax; record anew with
MJPC_TORCH_RECORD=1 in one process); the slow test_jax_calls_golden_is_
jaxs makes it live.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu.estimators import batch as jbatch
from mujoco_mpc_tpu.estimators import direct as jdirect
from mujoco_mpc_tpu.physics.model import make_data as jmake_data
from mujoco_mpc_tpu.tasks import registry as jregistry
from mujoco_mpc_tpu_torch.estimators import batch, direct
from mujoco_mpc_tpu_torch.physics import forward as fwd
from mujoco_mpc_tpu_torch.physics import sensors
from mujoco_mpc_tpu_torch.physics.model import make_data
from mujoco_mpc_tpu_torch.tasks import registry
from tests.torch_recorded import RecordedJax

torch.set_num_threads(1)

JAX_CALLS = 'batch_float32_jax_calls_golden.npz'

WINDOW = 32
ITERS = 3
NOISE = 0.01
QUICK = {'xla_backend_optimization_level': 0,
         'xla_llvm_disable_expensive_passes': True}


def _model(dtype):
  return registry.get_task('Quadruped Flat', device='cpu', dtype=dtype).model


def _window(dtype):
  """WINDOW + 1 states of the truth, simulated by the port in float32;
  the window (configurations 1e-3 off, noisy measurements, forces, times)
  and the next measurement, in `dtype`."""
  m = _model(torch.float32)
  home = m.key_ctrl[m.keyframe_names.index('home')]
  d = make_data(m).replace(qpos=m.keyframe_qpos('home')[None].clone())
  out = {k: [] for k in ('qpos', 'sensor', 'force', 'time')}
  for t in range(WINDOW + 1):
    u = home + 0.1 * np.sin(2 * np.pi * t * float(m.opt.timestep) / 0.4)
    d = d.replace(ctrl=u[None])
    df = fwd.forward(m, d)
    for k, v in (('qpos', d.qpos), ('sensor', sensors.sensordata(m, df)),
                 ('force', df.qfrc_actuator + df.qfrc_constraint),
                 ('time', d.time)):
      out[k].append(v[0])
    d = fwd.integrate(m, df)
  out = {k: torch.stack(v).to(dtype) for k, v in out.items()}
  out['sensor'] += torch.tensor(NOISE * np.random.default_rng(17).normal(
      size=tuple(out['sensor'].shape)), dtype=dtype)
  dz = torch.tensor(1e-3 * np.random.default_rng(21).normal(
      size=(WINDOW, m.nv)), dtype=dtype)
  qpos = fwd.integrate_pos(_model(dtype), out['qpos'][:WINDOW], dz, 1.0)
  return dict(qpos=qpos, sensor=out['sensor'][:WINDOW],
              force=out['force'][:WINDOW], times=out['time'][:WINDOW],
              next=[out[k][WINDOW] for k in ('sensor', 'force', 'time')])


def _port_update(dtype, win):
  m = _model(dtype)
  p = direct.make_problem(m, make_data(m), WINDOW)
  s = direct.default_settings(p).replace(
      sensor_weight=torch.full((p.sensor_dim,), NOISE ** -2, dtype=dtype),
      max_iterations=ITERS)
  st = batch.init_state(p).replace(
      qpos_window=win['qpos'], sensor_window=win['sensor'],
      force_window=win['force'], times=win['times'])
  return batch.update(p, st, s, *win['next'],
                      torch.tensor(float(m.opt.timestep), dtype=dtype))


def _jax_update(qpos, sensor, force, times, next_sensor, next_force,
                next_time):
  """JAX's float32 batch update of the window (its new qpos window, cost
  trace), jitted with XLA's quick options."""
  jm = jax.tree.map(
      lambda x: x.astype(jnp.float32)
      if jnp.issubdtype(getattr(x, 'dtype', np.int32), jnp.floating) else x,
      jregistry.get_task('Quadruped Flat').model)
  jp = jdirect.make_problem(jm, jmake_data(jm, dtype=jnp.float32), WINDOW)
  js = jdirect.default_settings(jp, dtype=jnp.float32).replace(
      sensor_weight=jnp.full((jp.sensor_dim,), NOISE ** -2, jnp.float32),
      max_iterations=ITERS)
  jst = jbatch.init_state(jp, dtype=jnp.float32).replace(
      qpos_window=qpos, sensor_window=sensor, force_window=force,
      times=times)
  dt = jnp.asarray(float(jm.opt.timestep), jnp.float32)
  jnew, jinfo = jax.jit(lambda st: jbatch.update(
      jp, st, js, next_sensor, next_force, next_time, dt)).lower(
          jst).compile(compiler_options=QUICK)(jst)
  return jnew.qpos_window, jinfo['cost_trace']


@pytest.fixture(scope='module')
def jax_calls():
  rec = RecordedJax(os.path.join(registry.ASSETS, JAX_CALLS),
                    lambda: {'update': _jax_update})
  yield rec
  if rec.recording:
    rec.save()


def _jax_args(win):
  a = lambda x: jnp.asarray(x.numpy())  # noqa: E731
  return ([a(win[k]) for k in ('qpos', 'sensor', 'force', 'times')]
          + [a(x) for x in win['next']])


def test_float32_update_fails_as_jaxs_and_float64_converges(jax_calls):
  win = _window(torch.float32)
  new, info = _port_update(torch.float32, win)
  jnew_qpos, jtrace = jax_calls('update', *_jax_args(win))

  trace = info['cost_trace'].numpy()
  jtrace = np.asarray(jtrace)
  np.testing.assert_allclose(trace, jtrace, rtol=1e-5)
  np.testing.assert_allclose(new.qpos_window.numpy(), np.asarray(jnew_qpos),
                             atol=1e-6)
  # the same failure: no iteration improved on the start
  assert np.all(trace == trace[0]) and np.all(jtrace == jtrace[0])

  _, info64 = _port_update(torch.float64, _window(torch.float64))
  trace64 = info64['cost_trace'].numpy()
  assert np.all(np.isfinite(trace64))
  assert trace64[-1] < 1e-5 * float(trace[0]), (trace64, trace)


@pytest.mark.slow
def test_jax_calls_golden_is_jaxs(jax_calls):
  """The recorded JAX call is what the JAX package computes now."""
  jax_calls.check_live()
