"""Export a JAX task's compiled model and parameters for the PyTorch port.

Writes mujoco_mpc_tpu_torch/assets/<task>.npz (layout: see
mujoco_mpc_tpu_torch/convert.py) from mujoco_mpc_tpu.tasks.registry, which
compiles the task's MJCF with `mujoco`. The port loads these files where
neither JAX nor `mujoco` is installed. Run from the repository root after
changing a task's MJCF or the port's Model fields:

    python tools/export_torch_snapshot.py

tests/test_torch_package.py re-exports in memory and fails when a
committed snapshot is stale.

    python tools/export_torch_snapshot.py --cube-golden

writes assets/cube_solving_golden.npz instead: one Cube Solving step at
two states and a 4-candidate x 3-step plan, computed by the JAX package
in float64 (~7 minutes on a CPU, most of it compiling the JAX step once),
which tests/test_torch_cube.py holds the port to; the file records its
inputs, the JAX version and this command.

    python tools/export_torch_snapshot.py --estimator-golden

writes assets/quadruped_flat_estimators_golden.npz: one EKF and one UKF
update on Quadruped Flat from a perturbed filter state near `home`,
computed by the JAX package in float64 (a few minutes on a CPU, most of
it compiling the two updates), which tests/test_torch_estimators.py
holds the port to. The update measures sensors 6-9 (Posture,
Orientation, Angmom, trunk_position: 20 columns, the USER ones zero), not
all 45 columns: JAX's ops/linalg.chol_solve fails above n 24 with a
matrix right-hand side (its blocked path broadcasts (36, 21) against
(24, 21)), which both of its filters' gain solves are.

    python tools/export_torch_snapshot.py --sensor-models

writes assets/sensor_models.npz: the models of tests/test_torch_sensors.py
(every sensor type the port evaluates beside Quadruped Flat's USER and
FRAMEPOS ones: joint, frame, gyro, accelerometer, magnetometer, subtree,
actuator, clock, force, torque, touch, rangefinder) with 64 states each
made by MuJoCo, so that chip_smoke.py can run those sensors on the card
where `mujoco` is not installed (seconds; tests/test_torch_sensors.py
re-exports in memory and fails when the file is stale).
"""

from __future__ import annotations

import inspect
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
  sys.path.insert(0, ROOT)

from mujoco_mpc_tpu_torch.convert import PARAM_FIELDS  # noqa: E402
from mujoco_mpc_tpu_torch.physics import model as port_model  # noqa: E402
from mujoco_mpc_tpu_torch.tasks import registry as port_registry  # noqa: E402


def _jsonable(x):
  if isinstance(x, (list, tuple)):
    return [_jsonable(v) for v in x]
  if isinstance(x, np.ndarray):
    return _jsonable(x.tolist())
  if isinstance(x, (bool, np.bool_)):
    return bool(x)
  if isinstance(x, (int, np.integer)):
    return int(x)
  if isinstance(x, (float, np.floating)):
    return float(x)
  return x


def model_snapshot(m):
  """(arrays, static) of a JAX Model, as physics/model.py from_arrays
  takes them."""
  arrays = {k: np.asarray(getattr(m, k)) for k in port_model.ARRAY_FIELDS}
  arrays.update({'opt.' + k: np.asarray(getattr(m.opt, k))
                 for k in port_model.OPTION_ARRAYS})
  if m.friction_dof:
    arrays.update({k: np.asarray(getattr(m, k))
                   for k in port_model.FRICTION_ARRAYS})
  for g, hull in (m.geom_mesh or {}).items():
    arrays.update({f'geom_mesh/{int(g)}/{part}': np.asarray(a)
                   for part, a in zip(port_model.HULL_ARRAYS, hull)})
  static = {k: _jsonable(getattr(m, k)) for k in port_model.STATIC_FIELDS}
  static.update({'opt.' + k: int(getattr(m.opt, k))
                 for k in port_model.OPTION_STATIC})
  return arrays, static


def track_arrays(spec):
  """Humanoid Track's clip, which JAX keeps in its residual's closure
  (registry.py :1411-1433): the marker table as the residual holds it
  (float32), the clips' first frames and lengths, and in the CMU branch
  the marker sites."""
  res = inspect.getclosurevars(spec.residual_fn).nonlocals
  window = inspect.getclosurevars(res['_frames']).nonlocals
  out = {'markers': np.asarray(res['markers_j']),
         'starts': np.asarray(window['starts']),
         'lengths': np.asarray(window['lengths'])}
  if res['marker_sites'] is not None:
    out['marker_sites'] = np.asarray(res['marker_sites'])
  return out


def rubik_arrays(spec):
  """Cube Solving's scramble, which JAX keeps in its transition's closure
  (registry.py :1015, :1023-1024): the exact cube states and their face
  angles, float32 as the task holds them."""
  env = inspect.getclosurevars(spec.transition_fn).nonlocals
  return {'states': np.asarray(env['states']),
          'cache': np.asarray(env['cache'])}


# task name -> its arrays beside Model and TaskParams ('task/<name>')
TASK_ARRAYS = {'Humanoid Track': track_arrays, 'Cube Solving': rubik_arrays}


def task_snapshot(spec):
  """(arrays, static) of a JAX TaskSpec (layout: convert.py)."""
  ma, ms = model_snapshot(spec.model)
  arrays = {'model/' + k: v for k, v in ma.items()}
  arrays.update({'params/' + k: np.asarray(getattr(spec.default_params, k))
                 for k in PARAM_FIELDS})
  if spec.name in TASK_ARRAYS:
    arrays.update({'task/' + k: v
                   for k, v in TASK_ARRAYS[spec.name](spec).items()})
  static = {
      'name': spec.name,
      'model': ms,
      'task': {
          'term_names': list(spec.term_names),
          'norm_types': _jsonable(spec.norm_types),
          'term_dims': _jsonable(spec.term_dims),
          'config': {k: _jsonable(v) for k, v in spec.config.items()},
          'weight_ranges': _jsonable(spec.weight_ranges),
          'residual_param_names': list(spec.residual_param_names),
          'residual_param_ranges': _jsonable(spec.residual_param_ranges),
      },
  }
  return arrays, json.loads(json.dumps(static, sort_keys=True))


# ---------------------------------------------------------------------------
# Cube Solving's golden: a JAX Cube Solving step compiles for minutes, so
# tests/test_torch_cube.py holds the port's slice to this file.
# ---------------------------------------------------------------------------

CUBE_GOLDEN = 'cube_solving_golden.npz'
GOLDEN_CANDIDATES, GOLDEN_STEPS, GOLDEN_KNOTS = 4, 3, 10
GOLDEN_COMMAND = 'python tools/export_torch_snapshot.py --cube-golden'


def cube_contact_state(home):
  """Cube Solving's qpos with the cube lowered 3 cm, 4 mm into the palm
  (`home` holds its lowest point 7 mm above), its six faces turned
  0.1-0.3 rad off their detents and its 20 ring cubelets rattled by ~0.05
  rad, so that cubelets interpenetrate (numpy, seeded)."""
  rng = np.random.default_rng(7)
  q = np.array(home, dtype=np.float64)
  q[2] -= 0.03
  q[7:13] += rng.choice([-1.0, 1.0], 6) * rng.uniform(0.1, 0.3, 6)
  ring = q[13:93].reshape(20, 4) + 0.025 * rng.normal(size=(20, 4))
  q[13:93] = (ring / np.linalg.norm(ring, axis=1, keepdims=True)).ravel()
  return q


def cube_golden_inputs(home, nv, nu):
  """The golden's inputs (numpy, seeded): two states for the step
  (`home` and cube_contact_state, random velocities and controls), and
  the plan's nominal knots and candidate noise."""
  rng = np.random.default_rng(11)
  return {
      'step/qpos': np.stack([home, cube_contact_state(home)]),
      'step/qvel': rng.normal(scale=0.1, size=(2, nv)),
      'step/ctrl': rng.normal(scale=0.3, size=(2, nu)),
      'plan/values': rng.uniform(-0.5, 0.5, (GOLDEN_KNOTS, nu)),
      'plan/eps': rng.normal(size=(GOLDEN_CANDIDATES, GOLDEN_KNOTS, nu)),
      'plan/use2': rng.uniform(size=GOLDEN_CANDIDATES) < 0.2,
  }


def cube_step(spec, inputs):
  """The port's Cube Solving step (a float64 CPU spec) at the golden's
  states: qacc, qfrc_constraint, the residual and the next qpos, qvel."""
  import torch
  from mujoco_mpc_tpu_torch.physics import forward as fwd
  from mujoco_mpc_tpu_torch.physics.model import make_data
  m = spec.model
  q, v, u = (torch.from_numpy(np.asarray(inputs['step/' + k]))
             for k in ('qpos', 'qvel', 'ctrl'))
  d = fwd.forward(m, make_data(m, q.shape[0]).replace(qpos=q, qvel=v,
                                                       ctrl=u))
  d2 = fwd.integrate(m, d)
  return {'qacc': d.qacc.numpy(), 'qfrc_constraint':
          d.qfrc_constraint.numpy(), 'residual': spec.residual_fn(
              m, d, spec.default_params.residual_params).numpy(),
          'next_qpos': d2.qpos.numpy(), 'next_qvel': d2.qvel.numpy()}


def cube_plan(spec, inputs, candidates=False):
  """The port's Predictive Sampling plan (a float64 CPU spec) from `home`
  with the golden's knots and noise: its returns and winner; with
  `candidates`, also each candidate's actions (K + 1, T, nu) and the
  nominal's knot times, from the port's spline."""
  import torch
  from mujoco_mpc_tpu_torch.ops import spline
  from mujoco_mpc_tpu_torch.physics.model import make_data
  from mujoco_mpc_tpu_torch.planners import sampling
  m = spec.model
  interp = int(spline.Interp.ZERO)
  d0 = make_data(m).replace(qpos=m.keyframe_qpos('home')[None])
  cfg = sampling.default_config(spec)
  pol = sampling.SamplingPolicy(
      torch.linspace(0.0, 1.0, GOLDEN_KNOTS, dtype=torch.float64),
      torch.from_numpy(np.asarray(inputs['plan/values'])))
  eps = torch.from_numpy(np.asarray(inputs['plan/eps']))
  use2 = torch.from_numpy(np.asarray(inputs['plan/use2']))
  _, info = sampling.optimize(spec, pol, d0, spec.default_params, cfg,
                              (eps, use2), GOLDEN_STEPS, interp)
  out = {'returns': info['returns'].numpy(),
         'winner': np.asarray(int(info['winner']))}
  if candidates:
    nominal = sampling.resample_nominal(spec, pol, d0.time[0], GOLDEN_STEPS,
                                        cfg, interp)
    out['cands'] = sampling.candidates_from_noise(spec, nominal, eps, use2,
                                                  cfg).numpy()
    out['times'] = nominal.times.numpy()
    out['timestep'] = float(cfg.timestep)
  return out


def jax_cube_golden(inputs):
  """The golden's outputs from the JAX package in float64: its step
  (forward, residual, Euler) jitted once with XLA's quick compile and
  called a sample at a time, at the step's states, and over the plan's
  candidates (the nominal first; knots -> actions by JAX's spline) for
  GOLDEN_STEPS steps, summed to returns by JAX's rollout."""
  import jax
  import jax.numpy as jnp
  import torch
  from mujoco_mpc_tpu.physics import forward as jfwd
  from mujoco_mpc_tpu.physics.model import make_data as jmake_data
  from mujoco_mpc_tpu.planners import rollout as jrollout
  from mujoco_mpc_tpu.planners import sampling as jsampling
  from mujoco_mpc_tpu.tasks import registry
  from mujoco_mpc_tpu_torch.ops import spline
  jax.config.update('jax_enable_x64', True)
  jspec = registry.get_task('Cube Solving')
  f64 = lambda t: jax.tree.map(  # noqa: E731
      lambda x: x.astype(jnp.float64)
      if jnp.issubdtype(getattr(x, 'dtype', np.int32), jnp.floating) else x,
      t)
  jm, jp = f64(jspec.model), f64(jspec.default_params)
  jd0 = jmake_data(jm, dtype=jnp.float64)

  def one(q, v, u):
    d = jfwd.forward(jm, jd0.replace(qpos=q, qvel=v, ctrl=u))
    res = jspec.residual_fn(jm, d, jp.residual_params)
    d2 = jfwd.integrate(jm, d)
    return (d.qacc, d.qfrc_constraint, res, jspec.cost(res, jp), d2.qpos,
            d2.qvel)

  q0, v0, u0 = (jnp.asarray(inputs['step/' + k][0])
                for k in ('qpos', 'qvel', 'ctrl'))
  step = jax.jit(one).lower(q0, v0, u0).compile(compiler_options={
      'xla_backend_optimization_level': 0,
      'xla_llvm_disable_expensive_passes': True})

  def run(q, v, u):
    outs = [step(*(jnp.asarray(x[i]) for x in (q, v, u)))
            for i in range(len(q))]
    return [np.stack([np.asarray(o[k]) for o in outs]) for k in range(6)]

  out = {}
  qacc, qfrc, res, _, qpos, qvel = run(
      *(inputs['step/' + k] for k in ('qpos', 'qvel', 'ctrl')))
  out.update({'step/qacc': qacc, 'step/qfrc_constraint': qfrc,
              'step/residual': res, 'step/next_qpos': qpos,
              'step/next_qvel': qvel})
  port = port_registry.get_task('Cube Solving', device='cpu',
                                dtype=torch.float64)
  plan = cube_plan(port, inputs, candidates=True)
  acts = np.asarray(jax.vmap(lambda vals: jsampling.candidate_actions(
      jnp.asarray(plan['times']), vals, GOLDEN_STEPS, plan['timestep'],
      int(spline.Interp.ZERO)))(jnp.asarray(plan['cands'])))
  k = acts.shape[0]
  q = np.tile(np.asarray(jm.keyframe_qpos('home')), (k, 1))
  v = np.zeros((k, jm.nv))
  costs = []
  for t in range(GOLDEN_STEPS):
    *_, cost, q, v = run(q, v, acts[:, t])
    costs.append(cost)
  returns = np.asarray(jrollout.total_return(jnp.stack(costs, -1)))
  out.update({'plan/returns': returns,
              'plan/winner': np.asarray(int(np.argmin(returns)))})
  return out


def write_cube_golden(path):
  """Write Cube Solving's golden (inputs, JAX outputs, provenance)."""
  import jax
  from mujoco_mpc_tpu.tasks import registry
  m = registry.get_task('Cube Solving').model
  inputs = cube_golden_inputs(np.asarray(m.keyframe_qpos('home'),
                                         np.float64), m.nv, m.nu)
  out = jax_cube_golden(inputs)
  np.savez(path, **inputs, **out,
           provenance=np.asarray(json.dumps({
               'jax': jax.__version__, 'dtype': 'float64',
               'command': GOLDEN_COMMAND,
               'inputs': 'cube_golden_inputs: numpy default_rng(11); '
                         'cube_contact_state: default_rng(7)'})))


# ---------------------------------------------------------------------------
# Quadruped Flat's estimator golden: one EKF and one UKF update, held by
# tests/test_torch_estimators.py.
# ---------------------------------------------------------------------------

ESTIMATOR_GOLDEN = 'quadruped_flat_estimators_golden.npz'
ESTIMATOR_COMMAND = 'python tools/export_torch_snapshot.py --estimator-golden'
ESTIMATOR_FIELDS = ('qpos', 'qvel', 'act', 'time', 'covariance',
                    'noise_process', 'noise_sensor')
# (first sensor, count): the widest run of sensors up to trunk_position
# whose columns (20) JAX's gain solve takes (see the module docstring)
ESTIMATOR_SLICE = (6, 4)


def estimator_golden_inputs(jm):
  """The golden's inputs (numpy, seeded): the truth (`home`, small random
  velocities and controls), its ESTIMATOR_SLICE sensordata columns with
  noise of the filter's sensor variance, and a filter state 1e-2 off the
  truth in every tangent direction, JAX's init_state noise and
  covariance."""
  import jax
  import jax.numpy as jnp
  from mujoco_mpc_tpu.estimators import base
  from mujoco_mpc_tpu.physics import forward as jfwd
  from mujoco_mpc_tpu.physics import sensors as jsensors
  from mujoco_mpc_tpu.physics.model import make_data as jmake_data
  rng = np.random.default_rng(13)
  home = jnp.asarray(jm.keyframe_qpos('home'))
  qvel = rng.normal(scale=0.05, size=jm.nv)
  lo, hi = np.asarray(jm.actuator_ctrlrange).T
  ctrl = 0.5 * (lo + hi) + 0.1 * (hi - lo) * rng.uniform(-1, 1, jm.nu)
  d = jfwd.forward(jm, jmake_data(jm, dtype=jnp.float64).replace(
      qpos=home, qvel=jnp.asarray(qvel), ctrl=jnp.asarray(ctrl)))
  adr0, dim = base._sensor_range(jm, ESTIMATOR_SLICE)
  sensor = np.asarray(jax.jit(lambda d: jsensors.sensordata(jm, d))(d))
  sensor = sensor[adr0:adr0 + dim] + 1e-2 * rng.normal(size=dim)
  dx = 1e-2 * rng.normal(size=base.ndx(jm))
  qp, qv, act = base.perturb(jm, home, jnp.asarray(qvel),
                             jnp.zeros(jm.na), jnp.asarray(dx))
  state = base.init_state(jm, dtype=jnp.float64,
                          sensor_slice=ESTIMATOR_SLICE).replace(
                              qpos=qp, qvel=qv, act=act)
  out = {'state/' + k: np.asarray(getattr(state, k))
         for k in ESTIMATOR_FIELDS}
  out.update({'truth/qpos': np.asarray(home), 'truth/qvel': qvel,
              'ctrl': ctrl, 'sensor': sensor})
  return out


def jax_estimator_golden(jm, inputs):
  """JAX's EKF and UKF updates (float64, XLA's quick compile options)
  from the golden's state, controls and measurements."""
  import jax
  import jax.numpy as jnp
  from mujoco_mpc_tpu.estimators import base, kalman, unscented
  from mujoco_mpc_tpu.physics.model import make_data as jmake_data
  template = jmake_data(jm, dtype=jnp.float64)
  state = base.EstimatorState(**{k: jnp.asarray(inputs['state/' + k])
                                 for k in ESTIMATOR_FIELDS})
  ctrl, sensor = jnp.asarray(inputs['ctrl']), jnp.asarray(inputs['sensor'])
  out = {}
  for name, update in (('ekf', kalman.update), ('ukf', unscented.update)):
    fn = jax.jit(lambda s, u, y, update=update: update(
        jm, template, s, u, y, ESTIMATOR_SLICE))
    new = fn.lower(state, ctrl, sensor).compile(compiler_options={
        'xla_backend_optimization_level': 0,
        'xla_llvm_disable_expensive_passes': True})(state, ctrl, sensor)
    out.update({f'{name}/{k}': np.asarray(getattr(new, k))
                for k in ('qpos', 'qvel', 'time', 'covariance')})
  return out


def jax_quadruped_f64():
  """JAX's Quadruped Flat model in float64."""
  import jax
  import jax.numpy as jnp
  from mujoco_mpc_tpu.tasks import registry
  jax.config.update('jax_enable_x64', True)
  return jax.tree.map(
      lambda x: x.astype(jnp.float64)
      if jnp.issubdtype(getattr(x, 'dtype', np.int32), jnp.floating) else x,
      registry.get_task('Quadruped Flat').model)


def write_estimator_golden(path):
  """Write Quadruped Flat's estimator golden (inputs, JAX outputs,
  provenance)."""
  import jax
  jm = jax_quadruped_f64()
  inputs = estimator_golden_inputs(jm)
  out = jax_estimator_golden(jm, inputs)
  np.savez(path, **inputs, **out, provenance=np.asarray(json.dumps({
      'jax': jax.__version__, 'dtype': 'float64',
      'command': ESTIMATOR_COMMAND,
      'sensor_slice': list(ESTIMATOR_SLICE),
      'inputs': 'estimator_golden_inputs: numpy default_rng(13)'})))


SENSOR_MODELS = 'sensor_models.npz'
SENSOR_MODEL_STATES = 64


def sensor_model_xmls():
  """{name: MJCF} of the sensor models, from the sensor tests."""
  from tests.test_sensors import XML
  from tests.test_torch_sensors import (FORCE_PLANE_XML, MORE_XML,
                                       RANGE_PORT_XML)
  return {'sensors': XML, 'more': MORE_XML, 'force': FORCE_PLANE_XML,
          'range': RANGE_PORT_XML}


def sensor_model_states(name, mjm, rng):
  """SENSOR_MODEL_STATES states (qpos, qvel, ctrl, time) of a sensor
  model: random as the sensor tests draw them, the box of 'force' every
  8th step of its fall onto the plate and rest there (MuJoCo's steps)."""
  import mujoco
  n = SENSOR_MODEL_STATES
  mjd = mujoco.MjData(mjm)
  out = []
  for t in range(8 * n if name == 'force' else n):
    if name == 'force':
      mujoco.mj_step(mjm, mjd)
      if t % 8:
        continue
    elif name == 'range':
      mjd.qpos[0] = rng.uniform(-np.pi, np.pi)
    else:
      q = rng.standard_normal(mjm.nq) * 0.4
      if name == 'more':           # the ball joint's unit quaternion
        q[:4] /= np.linalg.norm(q[:4])
      mjd.qpos[:] = q
      mjd.qvel[:] = rng.standard_normal(mjm.nv) * 0.5
      mjd.ctrl[:] = rng.standard_normal(mjm.nu) * 0.3
      mjd.time = rng.uniform(0, 2)
    out.append((mjd.qpos.copy(), mjd.qvel.copy(), mjd.ctrl.copy(),
                mjd.time))
  return {k: np.stack([s[i] for s in out])
          for i, k in enumerate(('qpos', 'qvel', 'ctrl', 'time'))}


def sensor_model_arrays():
  """The arrays of assets/sensor_models.npz: per model `<name>/static`
  (JSON), `<name>/model/<field>` (its put_model snapshot) and
  `<name>/<qpos, qvel, ctrl, time>` (its states)."""
  import mujoco
  from mujoco_mpc_tpu.physics.model import put_model
  rng = np.random.default_rng(23)
  out = {}
  for name, xml in sensor_model_xmls().items():
    mjm = mujoco.MjModel.from_xml_string(xml)
    arrays, static = model_snapshot(put_model(mjm))
    out[f'{name}/static'] = np.asarray(json.dumps(static, sort_keys=True))
    out.update({f'{name}/model/{k}': v for k, v in arrays.items()})
    out.update({f'{name}/{k}': v
                for k, v in sensor_model_states(name, mjm, rng).items()})
  return out


def write(path: str, arrays: dict, static: dict) -> None:
  np.savez(path, static=np.asarray(json.dumps(static, sort_keys=True)),
           **arrays)


def main():
  goldens = {'--cube-golden': (CUBE_GOLDEN, write_cube_golden),
             '--estimator-golden': (ESTIMATOR_GOLDEN,
                                    write_estimator_golden),
             '--sensor-models': (SENSOR_MODELS, lambda path: np.savez(
                 path, **sensor_model_arrays()))}
  flag = next((a for a in sys.argv[1:] if a in goldens), None)
  if flag:
    fname, writer = goldens[flag]
    path = os.path.join(port_registry.ASSETS, fname)
    writer(path)
    print(f'wrote {os.path.relpath(path, ROOT)} '
          f'({os.path.getsize(path)} bytes)')
    return
  from mujoco_mpc_tpu.tasks import registry
  for name, (fname, _) in port_registry.TASKS.items():
    path = os.path.join(port_registry.ASSETS, fname)
    write(path, *task_snapshot(registry.get_task(name)))
    print(f'wrote {os.path.relpath(path, ROOT)} '
          f'({os.path.getsize(path)} bytes)')


if __name__ == '__main__':
  main()
