"""Export a JAX task's compiled model and parameters for the PyTorch port.

Writes mujoco_mpc_tpu_torch/assets/<task>.npz (layout: see
mujoco_mpc_tpu_torch/convert.py) from mujoco_mpc_tpu.tasks.registry, which
compiles the task's MJCF with `mujoco`. The port loads these files where
neither JAX nor `mujoco` is installed. Run from the repository root after
changing a task's MJCF or the port's Model fields:

    python tools/export_torch_snapshot.py ['Task Name' ...]

(every task, or the tasks named; np.savez stamps the time into each
file, so rewrite only the snapshots that changed).
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

    python tools/export_torch_snapshot.py --manipulation-golden

writes assets/manipulation_golden.npz: for FreeFingers, Panda, Panda
Bring, Bimanual Handover and Bimanual Reorient, four states made with
MuJoCo's kinematics (the box on the floor, fingertips pressed on it, one
sphere's centre inside it), and the JAX package's condim-3 contact points,
qacc, qfrc_constraint, residual and next state there, its transition in
both branches with what it drew, and a 16-candidate x 6-step plan's
returns, float64 (~3.5 minutes on a CPU: five JAX step compiles), which
tests/test_torch_manipulation.py holds the port to.

    python tools/export_torch_snapshot.py --box-pairs-golden
    python tools/export_torch_snapshot.py --last-tasks-golden

write assets/box_pairs_golden.npz (Walker, Bimanual Insert, Allegro Cube,
Humanoid Interact) and assets/last_tasks_golden.npz (Acrobot, Quadrotor,
OP3 Stand, Quadruped Hill: their steps, Quadrotor's site transmissions,
goal path and derivatives, Hill's mode switches on its height field, and
a 16 x 6 plan each; ~2 minutes), held by tests/test_torch_box_pairs.py
and tests/test_torch_last_tasks.py.

    python tools/export_torch_snapshot.py --physics-models
    python tools/export_torch_snapshot.py --physics-golden

write assets/physics_models.npz (the MJCF scenes of the physics slice:
the cylinder and ellipsoid pairs, tendons, equality constraints, RK4 and
gravity compensation, each model's snapshot and its test's initial
state; seconds; the physics tests re-export it in memory and fail when it
is stale) and, from it, assets/physics_features_golden.npz (JAX's float64
trajectories of every model: 4 perturbed states, 20 steps of random
controls; ~2 minutes), which tests/test_torch_convex_pairs.py,
tests/test_torch_tendons.py and tests/test_torch_equality.py hold the
port to on the CPU and chip_smoke.py on the card.

The tests of the Humanoid Track, Quadruped Flat and Shadow Reorient
slices replay their JAX step from assets/*_step_golden.npz instead
(tests/torch_recorded.py says how those files are recorded).
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
  for g, field in (m.geom_hfield or {}).items():
    arrays.update({f'geom_hfield/{int(g)}/{part}': np.asarray(a)
                   for part, a in zip(port_model.HFIELD_ARRAYS, field)})
  static = {k: _jsonable(getattr(m, k)) for k in port_model.STATIC_FIELDS}
  static.update({'opt.' + k: int(getattr(m.opt, k))
                 for k in port_model.OPTION_STATIC})
  # the tendon and equality fields only where the model has them, so that
  # the snapshots of models without them stay as they were
  for n, fields, statics in ((m.ntendon, port_model.TENDON_ARRAYS,
                              port_model.TENDON_STATIC),
                             (m.neq, port_model.EQ_ARRAYS,
                              port_model.EQ_STATIC)):
    if n:
      arrays.update({k: np.asarray(getattr(m, k)) for k in fields})
      static.update({k: _jsonable(getattr(m, k)) for k in statics})
  # carried only where a site transmission has a reference site (-1, none,
  # is the port's value elsewhere)
  if any(r >= 0 for r in m.actuator_refid):
    static['actuator_refid'] = _jsonable(m.actuator_refid)
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


def manipulation_arrays(spec):
  """The site, body and mocap ids a manipulation task's residual and
  transition keep in their closures (registry.py :790-911, :1131-1261),
  under the names they have there: each int, or list of ints, of them."""
  out = {}
  for fn in (spec.residual_fn, spec.transition_fn):
    if fn is None:
      continue
    for k, v in inspect.getclosurevars(fn).nonlocals.items():
      vals = v if isinstance(v, list) else [v]
      if all(isinstance(x, (int, np.integer)) for x in vals):
        out[k] = np.asarray(v, np.int64)
  return out


MANIPULATION = ('FreeFingers', 'Panda', 'Panda Bring', 'Bimanual Handover',
                'Bimanual Reorient')
# the tasks of the box-box, capsule-box and capsule-capsule pairs
BOX_PAIR_TASKS = ('Walker', 'Bimanual Insert', 'Allegro Cube',
                  'Humanoid Interact')

def quadrotor_arrays(spec):
  """Quadrotor's hover thrust, which JAX keeps in its residual's closure
  (registry.py :233-235; summed in float64 from MuJoCo's masses)."""
  env = inspect.getclosurevars(spec.residual_fn).nonlocals
  return {'hover': np.asarray(env['hover'], np.float64)}


# task name -> its arrays beside Model and TaskParams ('task/<name>')
TASK_ARRAYS = {'Humanoid Track': track_arrays, 'Cube Solving': rubik_arrays,
               'Quadrotor': quadrotor_arrays,
               **{name: manipulation_arrays
                  for name in MANIPULATION + ('Bimanual Insert',)}}


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


def port_step(spec, qpos, qvel, ctrl, mocap_pos=None, mocap_quat=None):
  """The port's step (a float64 CPU spec) from states (qpos, qvel, ctrl)
  (B, ...): qacc, qfrc_constraint, the residual and the next qpos, qvel.
  Mocap poses (B, nmocap, ...) default to the model's."""
  import torch
  from mujoco_mpc_tpu_torch.physics import forward as fwd
  from mujoco_mpc_tpu_torch.physics.model import make_data
  m = spec.model
  t = lambda x: torch.from_numpy(np.asarray(x))  # noqa: E731
  d = make_data(m, len(qpos)).replace(qpos=t(qpos), qvel=t(qvel),
                                      ctrl=t(ctrl))
  if mocap_pos is not None:
    d = d.replace(mocap_pos=t(mocap_pos), mocap_quat=t(mocap_quat))
  d = fwd.forward(m, d)
  d2 = fwd.integrate(m, d)
  return {'qacc': d.qacc.numpy(), 'qfrc_constraint':
          d.qfrc_constraint.numpy(), 'residual': spec.residual_fn(
              m, d, spec.default_params.residual_params).numpy(),
          'next_qpos': d2.qpos.numpy(), 'next_qvel': d2.qvel.numpy()}


def cube_step(spec, inputs):
  """The port's Cube Solving step at the golden's states."""
  return port_step(spec, *(inputs['step/' + k]
                           for k in ('qpos', 'qvel', 'ctrl')))


def port_plan(spec, d0, inputs, steps, candidates=False):
  """The port's Predictive Sampling plan (a float64 CPU spec) from d0
  with the knots inputs['plan/values'] (evenly spread over [0, 1]) and
  the noise inputs['plan/eps'], ['plan/use2']: its returns and winner;
  with `candidates`, also each candidate's actions (K + 1, T, nu) and the
  nominal's knot times, from the port's spline."""
  import torch
  from mujoco_mpc_tpu_torch.ops import spline
  from mujoco_mpc_tpu_torch.planners import sampling
  interp = int(spline.Interp.ZERO)
  values = torch.from_numpy(np.asarray(inputs['plan/values']))
  cfg = sampling.default_config(spec)
  pol = sampling.SamplingPolicy(
      torch.linspace(0.0, 1.0, values.shape[0], dtype=torch.float64), values)
  eps = torch.from_numpy(np.asarray(inputs['plan/eps']))
  use2 = torch.from_numpy(np.asarray(inputs['plan/use2']))
  _, info = sampling.optimize(spec, pol, d0, spec.default_params, cfg,
                              (eps, use2), steps, interp)
  out = {'returns': info['returns'].numpy(),
         'winner': np.asarray(int(info['winner']))}
  if candidates:
    nominal = sampling.resample_nominal(spec, pol, d0.time[0], steps, cfg,
                                        interp)
    out['cands'] = sampling.candidates_from_noise(spec, nominal, eps, use2,
                                                  cfg).numpy()
    out['times'] = nominal.times.numpy()
    out['timestep'] = float(cfg.timestep)
  return out


def cube_plan(spec, inputs, candidates=False):
  """The port's Cube Solving plan from `home` with the golden's knots and
  noise (port_plan, GOLDEN_STEPS steps)."""
  from mujoco_mpc_tpu_torch.physics.model import make_data
  m = spec.model
  d0 = make_data(m).replace(qpos=m.keyframe_qpos('home')[None])
  return port_plan(spec, d0, inputs, GOLDEN_STEPS, candidates)


def _f64(tree):
  import jax
  import jax.numpy as jnp
  return jax.tree.map(
      lambda x: x.astype(jnp.float64)
      if jnp.issubdtype(getattr(x, 'dtype', np.int32), jnp.floating) else x,
      tree)


def jax_step(jspec, jm, jp, points=False):
  """JAX's step of the task (forward, residual, cost, Euler), jitted once
  with XLA's quick compile on the model jm and params jp (float64), as a
  function of one state (qpos, qvel, ctrl, mocap_pos, mocap_quat) and
  called a sample at a time over stacked states: (qacc, qfrc_constraint,
  residual, cost, next qpos, next qvel) stacked, and with `points` the
  condim-3 group's contact points (dist, pos, normal) after them."""
  import jax
  import jax.numpy as jnp
  from mujoco_mpc_tpu.physics import constraint as jconstraint
  from mujoco_mpc_tpu.physics import forward as jfwd
  from mujoco_mpc_tpu.physics.model import make_data as jmake_data
  jd0 = jmake_data(jm, dtype=jnp.float64)

  def one(q, v, u, mp, mq):
    d = jfwd.forward(jm, jd0.replace(qpos=q, qvel=v, ctrl=u, mocap_pos=mp,
                                     mocap_quat=mq))
    res = jspec.residual_fn(jm, d, jp.residual_params)
    d2 = jfwd.integrate(jm, d)
    out = (d.qacc, d.qfrc_constraint, res, jspec.cost(res, jp), d2.qpos,
           d2.qvel)
    if points:
      g = jconstraint._Stacked(jconstraint._contact_groups(jm, d)[0][3])
      out += (g.dist, g.pos3, g.normal)
    return out

  compiled = []

  def run(q, v, u, mp=None, mq=None):
    n = len(q)
    mp = np.broadcast_to(np.asarray(jd0.mocap_pos), (n,) + jd0.mocap_pos.shape
                         ) if mp is None else mp
    mq = np.broadcast_to(np.asarray(jd0.mocap_quat),
                         (n,) + jd0.mocap_quat.shape) if mq is None else mq
    args = [[jnp.asarray(x[i]) for x in (q, v, u, mp, mq)] for i in range(n)]
    if not compiled:
      compiled.append(jax.jit(one).lower(*args[0]).compile(compiler_options={
          'xla_backend_optimization_level': 0,
          'xla_llvm_disable_expensive_passes': True}))
    outs = [compiled[0](*a) for a in args]
    return [np.stack([np.asarray(o[k]) for o in outs])
            for k in range(len(outs[0]))]

  return run


def jax_plan(run, plan, q0, v0, steps):
  """JAX's returns of a port plan's candidates (`plan` with candidates:
  knots -> actions by JAX's spline, the nominal first) rolled out from
  (q0, v0) for `steps` steps by the step `run` (jax_step), summed by
  JAX's rollout: (returns, winner)."""
  import jax
  import jax.numpy as jnp
  from mujoco_mpc_tpu.planners import rollout as jrollout
  from mujoco_mpc_tpu.planners import sampling as jsampling
  from mujoco_mpc_tpu_torch.ops import spline
  acts = np.asarray(jax.vmap(lambda vals: jsampling.candidate_actions(
      jnp.asarray(plan['times']), vals, steps, plan['timestep'],
      int(spline.Interp.ZERO)))(jnp.asarray(plan['cands'])))
  k = acts.shape[0]
  q, v = np.tile(q0, (k, 1)), np.tile(v0, (k, 1))
  costs = []
  for t in range(steps):
    *_, cost, q, v = run(q, v, acts[:, t])[:6]
    costs.append(cost)
  returns = np.asarray(jrollout.total_return(jnp.stack(costs, -1)))
  return returns, np.asarray(int(np.argmin(returns)))


def jax_cube_golden(inputs):
  """The golden's outputs from the JAX package in float64: its step
  (jax_step) at the step's states and over the plan's candidates for
  GOLDEN_STEPS steps (jax_plan)."""
  import jax
  import torch
  from mujoco_mpc_tpu.tasks import registry
  jax.config.update('jax_enable_x64', True)
  jspec = registry.get_task('Cube Solving')
  jm, jp = _f64(jspec.model), _f64(jspec.default_params)
  run = jax_step(jspec, jm, jp)
  out = {}
  qacc, qfrc, res, _, qpos, qvel = run(
      *(inputs['step/' + k] for k in ('qpos', 'qvel', 'ctrl')))
  out.update({'step/qacc': qacc, 'step/qfrc_constraint': qfrc,
              'step/residual': res, 'step/next_qpos': qpos,
              'step/next_qvel': qvel})
  port = port_registry.get_task('Cube Solving', device='cpu',
                                dtype=torch.float64)
  plan = cube_plan(port, inputs, candidates=True)
  returns, winner = jax_plan(run, plan, np.asarray(jm.keyframe_qpos('home')),
                             np.zeros(jm.nv), GOLDEN_STEPS)
  out.update({'plan/returns': returns, 'plan/winner': winner})
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
  return _f64(registry.get_task('Quadruped Flat').model)


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


# ---------------------------------------------------------------------------
# The manipulation tasks' golden, held by tests/test_torch_manipulation.py:
# five JAX step compiles would not fit the CPU tests' time.
# ---------------------------------------------------------------------------

MANIPULATION_GOLDEN = 'manipulation_golden.npz'
MANIPULATION_COMMAND = ('python tools/export_torch_snapshot.py '
                        '--manipulation-golden')
MANIPULATION_CANDIDATES, MANIPULATION_STEPS = 16, 6   # the plan, nominal in


def manipulation_mjcf(name):
  """The MJCF of a manipulation task as the JAX registry builds it
  (registry.py :790-911, :1149-1261): fingers.xml, panda.xml, Panda
  Bring's sensor swap, models/bimanual.bimanual_xml."""
  from mujoco_mpc_tpu.models import bimanual
  from mujoco_mpc_tpu.tasks import registry
  if name.startswith('Bimanual '):
    kind = name.split()[1].upper()
    return bimanual.bimanual_xml(name, getattr(bimanual, kind + '_OBJECTS'),
                                 getattr(bimanual, kind + '_SENSORS'))
  fname = 'fingers.xml' if name == 'FreeFingers' else 'panda.xml'
  with open(os.path.join(ROOT, 'mujoco_mpc_tpu', 'models', fname)) as f:
    xml = f.read()
  if name == 'Panda Bring':
    start = xml.index('  <sensor>')
    end = xml.index('</sensor>') + len('</sensor>')
    xml = (xml[:start] + registry._PANDA_BRING_SENSORS + xml[end:]).replace(
        '<mujoco model="Panda">', '<mujoco model="Panda Bring">')
  return xml


def manipulation_states(mjm, rng):
  """The golden's four states (qpos, qvel, ctrl), numpy: 0, qpos0 with
  the object's box resting 1 mm into the floor; 1 and 2, the arm joints
  drawn in their ranges and the object (the free joint, the first) placed
  against a fingertip sphere of a sphere-box pair, the sphere 0.5-3 mm
  into a side or the top face of the box, near its middle, the box turned
  about z only and held off the floor (at most 2 mm into it, at most 0.5
  m up); 3, the same with the sphere's centre 1-4 mm inside the box (the
  deep branch). Velocities normal with scale 0.1, controls uniform in
  their ranges."""
  import mujoco
  mjd = mujoco.MjData(mjm)
  obj = mjm.jnt_bodyid[0]
  box = next(g for g in range(mjm.ngeom) if mjm.geom_bodyid[g] == obj
             and mjm.geom_type[g] == mujoco.mjtGeom.mjGEOM_BOX)
  tips = [g for g in range(mjm.ngeom)
          if mjm.geom_type[g] == mujoco.mjtGeom.mjGEOM_SPHERE
          and (mjm.geom_contype[g] & mjm.geom_conaffinity[box]
               or mjm.geom_conaffinity[g] & mjm.geom_contype[box])]
  h = mjm.geom_size[box]
  lo, hi = mjm.jnt_range[1:, 0], mjm.jnt_range[1:, 1]
  adr = mjm.jnt_qposadr[1:]
  qpos = []
  for i in range(4):
    q = mjm.qpos0.copy()
    if i == 0:
      q[2] = h[2] - 0.001
      qpos.append(q)
      continue
    while True:
      q[adr] = lo + (hi - lo) * rng.uniform(size=len(adr))
      mjd.qpos[:] = q
      mujoco.mj_kinematics(mjm, mjd)
      tip = tips[rng.integers(len(tips))]
      r = mjm.geom_size[tip, 0]
      yaw = rng.uniform(-np.pi, np.pi)
      rot = np.array([[np.cos(yaw), -np.sin(yaw), 0.0],
                      [np.sin(yaw), np.cos(yaw), 0.0], [0.0, 0.0, 1.0]])
      k = rng.integers(3)
      sign = 1.0 if k == 2 else rng.choice([-1.0, 1.0])
      local = rng.uniform(-0.5, 0.5, 3) * h        # the sphere in the box
      local[k] = sign * (h[k] - rng.uniform(0.001, 0.004) if i == 3
                         else h[k] + r - rng.uniform(0.0005, 0.003))
      centre = mjd.geom_xpos[tip] - rot @ local
      if -0.002 <= centre[2] - h[2] <= 0.5:
        break
    q[:3] = centre
    q[3:7] = [np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)]
    qpos.append(q)
  clo, chi = mjm.actuator_ctrlrange.T
  return (np.stack(qpos), rng.normal(scale=0.1, size=(4, mjm.nv)),
          clo + (chi - clo) * rng.uniform(size=(4, mjm.nu)))


def manipulation_draw(name, key):
  """What the task's transition draws from `key` (registry.py :808, :853,
  :902, :1178-1183, :1249), float64."""
  import jax
  import jax.numpy as jnp
  half = {'FreeFingers': 0.15, 'Panda': 0.45, 'Panda Bring': 0.45}
  if name in half:
    return np.asarray(jax.random.uniform(
        key, (2,), minval=-half[name], maxval=half[name], dtype=jnp.float64))
  if name == 'Bimanual Handover':
    kx, ky = jax.random.split(key)
    return np.asarray([jax.random.uniform(kx, (), minval=-0.25, maxval=0.25),
                       jax.random.uniform(ky, (), minval=-0.3, maxval=0.3)],
                      np.float64)
  return np.asarray(jax.random.normal(key, (4,), dtype=jnp.float64))


def manipulation_mocap(name, jm, site_pos, obj_quat, reached):
  """Mocap poses (mocap_pos, mocap_quat) of the transition's branches:
  `reached` puts the goal 5 mm from the object site (Reorient: its
  orientation 0.1 rad about z from the object's); otherwise the model's
  goal (Reorient: 1 rad about z from the object)."""
  pos = np.array(jm.body_pos, np.float64)[
      np.flatnonzero(np.asarray(jm.body_mocapid) >= 0)]
  quat = np.tile([1.0, 0.0, 0.0, 0.0], (len(pos), 1))
  if name == 'Bimanual Reorient':
    half = 0.05 if reached else 0.5
    quat[0] = [obj_quat[0] * np.cos(half) - obj_quat[3] * np.sin(half),
               obj_quat[1] * np.cos(half) + obj_quat[2] * np.sin(half),
               obj_quat[2] * np.cos(half) - obj_quat[1] * np.sin(half),
               obj_quat[3] * np.cos(half) + obj_quat[0] * np.sin(half)]
  elif reached:
    pos[0] = site_pos + [0.003, 0.004, 0.0]
  return pos, quat


def jax_manipulation_golden(name, inputs):
  """One task's golden outputs from the JAX package in float64, from its
  inputs (the states, the plan's knots and noise, the transition's key
  seed and both branches' mocap poses; other entries are ignored):
  at each state the condim-3 contact points, qacc, qfrc_constraint, the
  residual and the next qpos, qvel (jax_step); the transition's output in
  both branches with what it drew; the plan's returns and winner from
  state 1 (jax_plan over the port's candidates)."""
  import jax
  import jax.numpy as jnp
  import torch
  from mujoco_mpc_tpu.physics import kinematics as jkin
  from mujoco_mpc_tpu.physics.model import make_data as jmake_data
  from mujoco_mpc_tpu.tasks import registry
  from mujoco_mpc_tpu_torch.physics.model import make_data
  jax.config.update('jax_enable_x64', True)
  jspec = registry.get_task(name)
  jm, jp = _f64(jspec.model), _f64(jspec.default_params)
  run = jax_step(jspec, jm, jp, points=True)
  q, v, u = (inputs[k] for k in ('qpos', 'qvel', 'ctrl'))
  qacc, qfrc, res, _, nq, nv, dist, pos, normal = run(q, v, u)
  out = {'qacc': qacc, 'qfrc_constraint': qfrc, 'residual': res,
         'next_qpos': nq, 'next_qvel': nv, 'dist': dist, 'pos': pos,
         'normal': normal}
  key = jax.random.key(int(inputs['transition/seed']))
  out['transition/draw'] = manipulation_draw(name, key)
  for branch in ('reached', 'not'):
    mp, mq = (inputs[f'transition/{branch}/mocap_{k}'] for k in ('pos',
                                                                 'quat'))
    jd = jkin.kinematics(jm, jmake_data(jm, dtype=jnp.float64).replace(
        qpos=jnp.asarray(q[0]), qvel=jnp.asarray(v[0]),
        mocap_pos=jnp.asarray(mp), mocap_quat=jnp.asarray(mq)))
    jd2, _ = jspec.transition_fn(jm, jd, jp, key)
    out[f'transition/{branch}/next_mocap_pos'] = np.asarray(jd2.mocap_pos)
    out[f'transition/{branch}/next_mocap_quat'] = np.asarray(jd2.mocap_quat)
  port = port_registry.get_task(name, device='cpu', dtype=torch.float64)
  d0 = make_data(port.model).replace(qpos=torch.from_numpy(q[1:2]),
                                     qvel=torch.from_numpy(v[1:2]))
  plan = port_plan(port, d0, inputs, MANIPULATION_STEPS, candidates=True)
  out['plan/returns'], out['plan/winner'] = jax_plan(run, plan, q[1], v[1],
                                                     MANIPULATION_STEPS)
  return {f'{name}/{k}': val for k, val in out.items()}


def manipulation_inputs(name, seed):
  """One task's golden inputs (numpy, default_rng(seed)): the states of
  manipulation_states, the transition's key seed and both branches' mocap
  poses (from state 0 after MuJoCo's kinematics), and the plan's knots
  (uniform in the middle of the control range) and noise."""
  import mujoco
  from mujoco_mpc_tpu.tasks import registry
  mjm = mujoco.MjModel.from_xml_string(manipulation_mjcf(name))
  jm = registry.get_task(name).model
  rng = np.random.default_rng(seed)
  q, v, u = manipulation_states(mjm, rng)
  mjd = mujoco.MjData(mjm)
  mjd.qpos[:] = q[0]
  mujoco.mj_kinematics(mjm, mjd)
  site = mujoco.mj_name2id(mjm, mujoco.mjtObj.mjOBJ_SITE, 'object_site')
  out = {'qpos': q, 'qvel': v, 'ctrl': u, 'transition/seed': np.asarray(seed)}
  for branch in ('reached', 'not'):
    mp, mq = manipulation_mocap(name, jm, mjd.site_xpos[site], q[0, 3:7],
                                branch == 'reached')
    out[f'transition/{branch}/mocap_pos'] = mp
    out[f'transition/{branch}/mocap_quat'] = mq
  clo, chi = mjm.actuator_ctrlrange.T
  knots = int(registry.get_task(name).config['sampling_spline_points'])
  out['plan/values'] = clo + (chi - clo) * rng.uniform(0.3, 0.7, (knots,
                                                                   mjm.nu))
  out['plan/eps'] = rng.normal(size=(MANIPULATION_CANDIDATES - 1, knots,
                                     mjm.nu))
  out['plan/use2'] = rng.uniform(size=MANIPULATION_CANDIDATES - 1) < 0.2
  return {f'{name}/{k}': val for k, val in out.items()}


def task_inputs(golden, name):
  """One task's entries of a golden, without the task's prefix."""
  return {k[len(name) + 1:]: v for k, v in golden.items()
          if k.startswith(name + '/')}


def write_manipulation_golden(path):
  """Write the manipulation tasks' golden (inputs, JAX outputs,
  provenance)."""
  import jax
  arrays = {}
  for seed, name in enumerate(MANIPULATION):
    inputs = manipulation_inputs(name, 31 + seed)
    arrays.update(inputs)
    arrays.update(jax_manipulation_golden(name, task_inputs(inputs, name)))
  np.savez(path, **arrays, provenance=np.asarray(json.dumps({
      'jax': jax.__version__, 'dtype': 'float64',
      'command': MANIPULATION_COMMAND,
      'inputs': 'manipulation_inputs: numpy default_rng(31 + the task\'s '
                'index in MANIPULATION)'})))


# ---------------------------------------------------------------------------
# The box-pair tasks' golden, held by tests/test_torch_box_pairs.py: Walker
# (capsule-capsule), Bimanual Insert (box-box), Allegro Cube (box-box,
# capsule-box) and Humanoid Interact (capsule-box, box-box).
# ---------------------------------------------------------------------------

BOX_PAIRS_GOLDEN = 'box_pairs_golden.npz'
BOX_PAIRS_COMMAND = ('python tools/export_torch_snapshot.py '
                     '--box-pairs-golden')
# Humanoid Interact's keyframe pairs in the golden's second residual: pair i
# (body1, body2, offsets l1 then l2); 3.5 rounds half to even (to 4)
INTERACT_ACTIVE = ((3.5, 1.0, (0.1, 0.0, -0.05), (0.0, 0.05, 0.03)),
                   (12.0, 0.0, (0.0, 0.0, 0.0), (-0.4, 0.1, 0.45)),
                   (-0.4, 7.0, (0.02, -0.03, 0.0), (0.0, 0.0, 0.1)))


def _lowest(mjm, mjd, g):
  """The lowest world z of geom g (sphere, capsule or box)."""
  import mujoco
  z, mat, size = mjd.geom_xpos[g, 2], mjd.geom_xmat[g].reshape(3, 3), \
      mjm.geom_size[g]
  t = mjm.geom_type[g]
  if t == mujoco.mjtGeom.mjGEOM_SPHERE:
    return z - size[0]
  if t == mujoco.mjtGeom.mjGEOM_CAPSULE:
    return z - size[1] * abs(mat[2, 2]) - size[0]
  return z - float(np.sum(size * np.abs(mat[2])))


def _contacts(mjm, mjd, q):
  """MuJoCo's contacts at qpos q: {(geom1, geom2): depth <= 0 dist}."""
  import mujoco
  mjd.qpos[:] = q
  mujoco.mj_forward(mjm, mjd)
  out = {}
  for c in mjd.contact[:mjd.ncon]:
    k = (int(c.geom1), int(c.geom2))
    out[k] = min(out.get(k, 0.0), float(c.dist))
  return out


def _yaw_quat(yaw):
  return np.array([np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)])


def _random_quat(rng):
  q = rng.normal(size=4)
  return q / np.linalg.norm(q)


def _quat_mat(q):
  import mujoco
  mat = np.zeros(9)
  mujoco.mju_quat2Mat(mat, q)
  return mat.reshape(3, 3)


def _joints_in_range(mjm, q, rng, first, lo_frac=0.0, hi_frac=1.0):
  """q with the limited hinge joints from `first` on drawn in [lo_frac,
  hi_frac] of their ranges."""
  for j in range(first, mjm.njnt):
    if mjm.jnt_limited[j]:
      lo, hi = mjm.jnt_range[j]
      u = rng.uniform(lo_frac, hi_frac)
      q[mjm.jnt_qposadr[j]] = lo + (hi - lo) * u
  return q


def _geoms(mjm, name_part):
  import mujoco
  return [g for g in range(mjm.ngeom)
          if name_part in (mujoco.mj_id2name(mjm, mujoco.mjtObj.mjOBJ_GEOM, g)
                           or '')]


def _lower_to(mjm, mjd, q, zadr, geoms, target):
  """q with the root's z coordinate (qpos[zadr]) moved so that the lowest
  of `geoms` sits at `target`."""
  import mujoco
  mjd.qpos[:] = q
  mujoco.mj_kinematics(mjm, mjd)
  q = q.copy()
  q[zadr] += target - min(_lowest(mjm, mjd, g) for g in geoms)
  return q


def _pair_types(mjm, contacts, t1, t2, lo=-np.inf, hi=0.0):
  return [k for k, dist in contacts.items()
          if (mjm.geom_type[k[0]], mjm.geom_type[k[1]]) == (t1, t2)
          and lo <= dist < hi]


def _shallow(contacts, limit=-0.005):
  """Whether no contact is deeper than `limit`."""
  return all(dist >= limit for dist in contacts.values())


def walker_states(mjm, mjd, rng):
  """0: qpos0 (the legs parallel side by side, 8 of the 15 capsule pairs
  parallel) with the feet 1 mm into the floor; 1, 2: the joints drawn in
  their ranges, the torso pitched by up to 0.4 rad, the lowest capsule
  0.5-3 mm into the floor; 3: a leg folded onto the torso (hip in the top
  third of its range, knee in the bottom third) until a capsule-capsule
  pair penetrates by 0.5 mm or more, the lowest capsule on the floor.
  1-3 are drawn again where a capsule pair touches within 0.1 mm: the
  thighs, and the feet, side by side at 0.1 m, touch at dist 0 where they
  cross, and there float64 rounding alone decides whether the row is
  active."""
  import mujoco
  caps = [g for g in range(mjm.ngeom)
          if mjm.geom_type[g] == mujoco.mjtGeom.mjGEOM_CAPSULE]
  cap = mujoco.mjtGeom.mjGEOM_CAPSULE
  out = [_lower_to(mjm, mjd, mjm.qpos0.copy(), 1, caps, -0.001)]
  while len(out) < 4:
    q = mjm.qpos0.copy()
    fold = len(out) == 3
    q = _joints_in_range(mjm, q, rng, 3)
    if fold:
      for j, (lo_f, hi_f) in ((3, (0.7, 1.0)), (4, (0.0, 0.3))):
        lo, hi = mjm.jnt_range[j]
        q[mjm.jnt_qposadr[j]] = lo + (hi - lo) * rng.uniform(lo_f, hi_f)
    q[2] = rng.uniform(-0.4, 0.4)
    q = _lower_to(mjm, mjd, q, 1, caps, -rng.uniform(0.0005, 0.003))
    con = _contacts(mjm, mjd, q)
    if _pair_types(mjm, con, cap, cap, lo=-1e-4) or (
        fold and not _pair_types(mjm, con, cap, cap, hi=-0.0005)):
      continue
    out.append(q)
  return np.stack(out)


def insert_states(mjm, mjd, rng):
  """0: qpos0 (the peg upright, 42 mm into the table, away from the
  socket); 1: the peg upright in the socket pressed 0.5-3 mm into the
  inner face of wall sock_a (aligned boxes: the face tie), 1 mm into the
  table; 2: the same turned 20-40 degrees about z (a vertical peg edge
  into the wall); 3: the peg in a random orientation over the top edge of
  a wall, drawn until the box-box edge axis wins in a pair that
  penetrates 0.5-5 mm and no contact is deeper than 5 mm (MuJoCo's
  contacts). The arm joints drawn in their ranges in 1-3."""
  from mujoco_mpc_tpu_torch.physics import collision
  import torch
  import mujoco
  peg = _geoms(mjm, 'peg_geom')[0]
  walls = _geoms(mjm, 'sock_')
  h = mjm.geom_size[peg]
  box = mujoco.mjtGeom.mjGEOM_BOX
  out = [mjm.qpos0.copy()]
  for yawed in (False, True):
    q = _joints_in_range(mjm, mjm.qpos0.copy(), rng, 1)
    yaw = rng.uniform(np.pi / 9, 2 * np.pi / 9) if yawed else 0.0
    reach = h[0] * (abs(np.cos(yaw)) + abs(np.sin(yaw)))
    q[:3] = [0.035 - reach + rng.uniform(0.0005, 0.003),
             rng.uniform(-0.004, 0.004), h[2] - 0.001]
    q[3:7] = _yaw_quat(yaw)
    out.append(q)
  t = lambda x: torch.from_numpy(np.asarray(x, np.float64))  # noqa: E731
  while True:
    q = _joints_in_range(mjm, mjm.qpos0.copy(), rng, 1)
    q[3:7] = _random_quat(rng)
    q[:3] = [rng.uniform(0.02, 0.07), rng.uniform(-0.05, 0.05),
             rng.uniform(0.09, 0.16)]
    con = _contacts(mjm, mjd, q)
    hits = [k for k in _pair_types(mjm, con, box, box, -0.005, -0.0005)
            if k[1] == peg and k[0] in walls]
    if not hits or any(k[0] == 0 for k in con) or not _shallow(con):
      continue
    for g1, _ in hits:
      pts = collision._box_box_sat(
          t(mjd.geom_xpos[g1]), t(mjd.geom_xmat[g1].reshape(3, 3)),
          t(mjm.geom_size[g1]), t(mjd.geom_xpos[peg]),
          t(mjd.geom_xmat[peg].reshape(3, 3)), t(h))
      if float(pts[4].dist) < 0:
        out.append(q)
        return np.stack(out)


def allegro_states(mjm, mjd, rng):
  """0: qpos0 with the cube 1 mm into the palm (aligned boxes: the face
  tie); 1: the cube in a random orientation over the palm, its lowest
  corner 0.5-3 mm into it; 2: the finger joints drawn in their ranges and
  the cube turned about z, placed with a finger capsule 0.5-3 mm into one
  of its faces; 3: the same with the capsule across one of the cube's
  edges (the segment's closest point off both faces), 0.5-3 mm in; 2 and
  3 drawn again until no contact is deeper than 5 mm."""
  import mujoco
  cube = _geoms(mjm, 'cube_geom')[0]
  palm = _geoms(mjm, 'palm_geom')[0]
  h = mjm.geom_size[cube, 0]
  mjd.qpos[:] = mjm.qpos0
  mujoco.mj_kinematics(mjm, mjd)
  palm_top = mjd.geom_xpos[palm, 2] + mjm.geom_size[palm, 2]
  q0 = mjm.qpos0.copy()
  q0[2] = palm_top + h - 0.001
  q1 = mjm.qpos0.copy()
  q1[3:7] = _random_quat(rng)
  q1[:2] = rng.uniform(-0.01, 0.01, 2)
  q1 = _lower_to(mjm, mjd, q1, 2, [cube], palm_top
                 - rng.uniform(0.0005, 0.003))
  out = [q0, q1]
  caps = [g for g in range(mjm.ngeom)
          if mjm.geom_type[g] == mujoco.mjtGeom.mjGEOM_CAPSULE]
  while len(out) < 4:
    edge = len(out) == 3
    q = _joints_in_range(mjm, mjm.qpos0.copy(), rng, 1)
    mjd.qpos[:] = q
    mujoco.mj_kinematics(mjm, mjd)
    g = caps[rng.integers(len(caps))]
    r, half = mjm.geom_size[g, :2]
    axis = mjd.geom_xmat[g].reshape(3, 3)[:, 2]
    p = mjd.geom_xpos[g] + rng.uniform(-0.5, 0.5) * half * axis
    yaw = rng.uniform(-np.pi, np.pi)
    rot = _quat_mat(_yaw_quat(yaw))
    k, j = rng.choice(3, 2, replace=False)
    local = rng.uniform(-0.5, 0.5, 3) * h     # p in the cube's frame
    pen = rng.uniform(0.0005, 0.003)
    sk, sj = rng.choice([-1.0, 1.0], 2)
    if edge:
      off = h + (r - np.sqrt(2.0) * pen) / np.sqrt(2.0)
      local[k], local[j] = sk * off, sj * off
    else:
      local[k] = sk * (h + r - pen)
    q[:3] = p - rot @ local
    q[3:7] = _yaw_quat(yaw)
    if _shallow(_contacts(mjm, mjd, q)):
      out.append(q)
  return np.stack(out)


def interact_states(mjm, mjd, rng):
  """0: qpos0 lowered until the feet are 1 mm into the floor; 1: seated,
  the joints drawn in their ranges until, with the pelvis capsule 0.5-3 mm
  into the top of the seat box, no contact is deeper than 5 mm; 2:
  standing on the seat, the lowest foot box 0.5-3 mm into its top; 3: the
  joints drawn in their ranges, turned about z and placed over the seat's
  edge until a shin capsule penetrates the seat 0.5-5 mm and no contact is
  deeper than 5 mm (MuJoCo's contacts)."""
  import mujoco
  seat = _geoms(mjm, 'seat')[0]
  feet = _geoms(mjm, '_foot_geom')
  pelvis = _geoms(mjm, 'pelvis_geom')[0]
  shins = _geoms(mjm, '_shin_geom')
  mjd.qpos[:] = mjm.qpos0
  mujoco.mj_kinematics(mjm, mjd)
  seat_top = mjd.geom_xpos[seat, 2] + mjm.geom_size[seat, 2]
  seat_xy = mjd.geom_xpos[seat, :2].copy()
  out = [_lower_to(mjm, mjd, mjm.qpos0.copy(), 2, feet, -0.001)]
  while len(out) < 2:
    q = _joints_in_range(mjm, mjm.qpos0.copy(), rng, 1)
    mjd.qpos[:] = q
    mujoco.mj_kinematics(mjm, mjd)
    q[:2] += seat_xy - mjd.geom_xpos[pelvis, :2]
    q = _lower_to(mjm, mjd, q, 2, [pelvis],
                  seat_top - rng.uniform(0.0005, 0.003))
    if _shallow(_contacts(mjm, mjd, q)):
      out.append(q)
  q = mjm.qpos0.copy()
  q[:2] = seat_xy + rng.uniform(-0.03, 0.03, 2)
  out.append(_lower_to(mjm, mjd, q, 2, feet,
                       seat_top - rng.uniform(0.0005, 0.003)))
  cap, box = mujoco.mjtGeom.mjGEOM_CAPSULE, mujoco.mjtGeom.mjGEOM_BOX
  while True:
    q = _joints_in_range(mjm, mjm.qpos0.copy(), rng, 1)
    q[3:7] = _yaw_quat(rng.uniform(-np.pi, np.pi))
    q[:2] = seat_xy + rng.uniform(-0.5, 0.5, 2)
    shin = shins[rng.integers(len(shins))]
    q = _lower_to(mjm, mjd, q, 2, [shin],
                  seat_top - rng.uniform(0.0005, 0.005))
    con = _contacts(mjm, mjd, q)
    if _shallow(con) and any(k == (shin, seat) for k in _pair_types(
        mjm, con, cap, box, -0.005, -0.0005)):
      out.append(q)
      return np.stack(out)


BOX_PAIR_STATES = {'Walker': walker_states, 'Bimanual Insert': insert_states,
                   'Allegro Cube': allegro_states,
                   'Humanoid Interact': interact_states}


def interact_active_params(rp, names):
  """Humanoid Interact's residual parameters with INTERACT_ACTIVE's
  keyframe pairs set (the others left inactive)."""
  rp = np.array(rp, np.float64)
  idx = {n: i for i, n in enumerate(names)}
  for i, (b1, b2, l1, l2) in enumerate(INTERACT_ACTIVE):
    rp[idx[f'kf{i}_body1']], rp[idx[f'kf{i}_body2']] = b1, b2
    for k, vals in (('l1', l1), ('l2', l2)):
      for x, val in zip('xyz', vals):
        rp[idx[f'kf{i}_{k}{x}']] = val
  return rp


def box_pair_inputs(name, seed):
  """One task's golden inputs (numpy, default_rng(seed)): the four states
  of BOX_PAIR_STATES, velocities normal with scale 0.1 and controls
  uniform in their ranges; the plan's knots (the middle of the control
  range) and noise; Allegro Cube's transition key seed and both branches'
  states (the goal at the cube's orientation; the goal 1 rad about z off
  and the cube dropped below -0.12); Humanoid Interact's residual
  parameters with active keyframe pairs and both transition branches'
  (select_mode 2 over _cur_mode 0; both 1)."""
  import mujoco
  from mujoco_mpc_tpu.tasks import registry
  jspec = registry.get_task(name)
  mjm = jspec.mj_model
  mjd = mujoco.MjData(mjm)
  rng = np.random.default_rng(seed)
  q = BOX_PAIR_STATES[name](mjm, mjd, rng)
  clo, chi = mjm.actuator_ctrlrange.T
  out = {'qpos': q, 'qvel': rng.normal(scale=0.1, size=(4, mjm.nv)),
         'ctrl': clo + (chi - clo) * rng.uniform(size=(4, mjm.nu))}
  knots = int(jspec.config['sampling_spline_points'])
  out['plan/values'] = clo + (chi - clo) * rng.uniform(0.3, 0.7,
                                                        (knots, mjm.nu))
  out['plan/eps'] = rng.normal(size=(MANIPULATION_CANDIDATES - 1, knots,
                                     mjm.nu))
  out['plan/use2'] = rng.uniform(size=MANIPULATION_CANDIDATES - 1) < 0.2
  rp = np.asarray(jspec.default_params.residual_params, np.float64)
  if name == 'Allegro Cube':
    out['transition/seed'] = np.asarray(seed)
    cube_quat = q[0, 3:7]
    half = 0.5
    off = np.array([cube_quat[0] * np.cos(half) - cube_quat[3] * np.sin(half),
                    cube_quat[1] * np.cos(half) + cube_quat[2] * np.sin(half),
                    cube_quat[2] * np.cos(half) - cube_quat[1] * np.sin(half),
                    cube_quat[3] * np.cos(half) + cube_quat[0] * np.sin(half)])
    dropped = q[0].copy()
    dropped[2] = -0.2
    out['transition/reached/qpos'] = q[0]
    out['transition/reached/mocap_quat'] = cube_quat[None]
    out['transition/not/qpos'] = dropped
    out['transition/not/mocap_quat'] = off[None]
  if name == 'Humanoid Interact':
    names = list(jspec.residual_param_names)
    out['residual_params_active'] = interact_active_params(rp, names)
    sel, cur = names.index('select_mode'), names.index('_cur_mode')
    for branch, (mode, prev) in (('reached', (2.0, 0.0)),
                                 ('not', (1.0, 1.0))):
      p = rp.copy()
      p[sel], p[cur] = mode, prev
      out[f'transition/{branch}/residual_params'] = p
  return {f'{name}/{k}': val for k, val in out.items()}


def jax_box_pair_golden(name, inputs):
  """One task's golden outputs from the JAX package in float64, from its
  inputs: at each state the condim-3 contact points, qacc,
  qfrc_constraint, the residual and the next qpos, qvel (jax_step;
  Humanoid Interact's residual also at its active keyframe parameters);
  the transition in both branches (Allegro Cube: the next state and goal
  with what it drew; Humanoid Interact: the weights and parameters); the
  plan's returns and winner from state 1."""
  import jax
  import jax.numpy as jnp
  import torch
  from mujoco_mpc_tpu.physics import kinematics as jkin
  from mujoco_mpc_tpu.physics.model import make_data as jmake_data
  from mujoco_mpc_tpu.tasks import registry
  from mujoco_mpc_tpu_torch.physics.model import make_data
  jax.config.update('jax_enable_x64', True)
  jspec = registry.get_task(name)
  jm, jp = _f64(jspec.model), _f64(jspec.default_params)
  run = jax_step(jspec, jm, jp, points=True)
  q, v, u = (inputs[k] for k in ('qpos', 'qvel', 'ctrl'))
  qacc, qfrc, res, _, nq, nv, dist, pos, normal = run(q, v, u)
  out = {'qacc': qacc, 'qfrc_constraint': qfrc, 'residual': res,
         'next_qpos': nq, 'next_qvel': nv, 'dist': dist, 'pos': pos,
         'normal': normal}
  jd0 = jmake_data(jm, dtype=jnp.float64)
  if 'residual_params_active' in inputs:
    from mujoco_mpc_tpu.physics import forward as jfwd
    rpa = jnp.asarray(inputs['residual_params_active'])
    fn = jax.jit(lambda qq, vv, uu: jspec.residual_fn(
        jm, jfwd.forward(jm, jd0.replace(qpos=qq, qvel=vv, ctrl=uu)), rpa))
    out['residual_active'] = np.stack([np.asarray(fn(*(jnp.asarray(x[i])
                                                       for x in (q, v, u))))
                                       for i in range(len(q))])
  if name == 'Allegro Cube':
    key = jax.random.key(int(inputs['transition/seed']))
    out['transition/draw'] = np.asarray(jax.random.normal(key, (4,),
                                                          dtype=jnp.float64))
    for branch in ('reached', 'not'):
      jd = jkin.kinematics(jm, jd0.replace(
          qpos=jnp.asarray(inputs[f'transition/{branch}/qpos']),
          qvel=jnp.asarray(v[0]),
          mocap_quat=jnp.asarray(inputs[f'transition/{branch}/mocap_quat'])))
      jd2, _ = jspec.transition_fn(jm, jd, jp, key)
      for k in ('qpos', 'qvel', 'mocap_quat'):
        out[f'transition/{branch}/next_{k}'] = np.asarray(getattr(jd2, k))
  if name == 'Humanoid Interact':
    for branch in ('reached', 'not'):
      p = jp.replace(residual_params=jnp.asarray(
          inputs[f'transition/{branch}/residual_params']))
      _, p2 = jspec.transition_fn(jm, jd0, p, jax.random.key(0))
      out[f'transition/{branch}/next_weights'] = np.asarray(p2.weights)
      out[f'transition/{branch}/next_residual_params'] = np.asarray(
          p2.residual_params)
  port = port_registry.get_task(name, device='cpu', dtype=torch.float64)
  d0 = make_data(port.model).replace(qpos=torch.from_numpy(q[1:2]),
                                     qvel=torch.from_numpy(v[1:2]))
  plan = port_plan(port, d0, inputs, MANIPULATION_STEPS, candidates=True)
  out['plan/returns'], out['plan/winner'] = jax_plan(run, plan, q[1], v[1],
                                                     MANIPULATION_STEPS)
  return {f'{name}/{k}': val for k, val in out.items()}


def write_box_pairs_golden(path):
  """Write the box-pair tasks' golden (inputs, JAX outputs, provenance)."""
  import jax
  arrays = {}
  for seed, name in enumerate(BOX_PAIR_TASKS):
    inputs = box_pair_inputs(name, 41 + seed)
    arrays.update(inputs)
    arrays.update(jax_box_pair_golden(name, task_inputs(inputs, name)))
  np.savez(path, **arrays, provenance=np.asarray(json.dumps({
      'jax': jax.__version__, 'dtype': 'float64',
      'command': BOX_PAIRS_COMMAND,
      'inputs': 'box_pair_inputs: numpy default_rng(41 + the task\'s '
                'index in BOX_PAIR_TASKS)'})))


# ---------------------------------------------------------------------------
# The last four tasks' golden, held by tests/test_torch_last_tasks.py:
# Acrobot (no contacts), Quadrotor (site transmissions, a moving mocap
# goal), OP3 Stand (plane pairs, limit rows) and Quadruped Hill (height-
# field pairs beside the floor plane).
# ---------------------------------------------------------------------------

LAST_TASKS = ('Acrobot', 'Quadrotor', 'OP3 Stand', 'Quadruped Hill')
LAST_TASKS_GOLDEN = 'last_tasks_golden.npz'
LAST_TASKS_COMMAND = ('python tools/export_torch_snapshot.py '
                      '--last-tasks-golden')
# Quadrotor's derivative pass: this many steps of the nominal
LAST_DERIV_STEPS = 4
# Quadruped Hill's transition branches: (mode, walk turn); the goal far
# away (no draw), the state out on the hills
HILL_BRANCHES = {'quadruped': (0, 0.0), 'walk': (2, 0.4), 'flip': (4, 0.0)}
# where Hill's states 2 and 3 stand on the rough terrain (x, y)
HILL_SPOTS = ((2.5, -1.5), (-2.0, 2.25))


def terrain_z(grid, size, x, y):
  """The height (numpy) of a height field at the origin under world (x,
  y): its triangle's plane, as JAX's _hfield_surface (cell split along
  (0, 0)-(1, 1))."""
  nrow, ncol = grid.shape
  dx, dy = 2.0 * size[0] / (ncol - 1), 2.0 * size[1] / (nrow - 1)
  fx, fy = (x + size[0]) / dx, (y + size[1]) / dy
  i = int(np.clip(np.floor(fx), 0, ncol - 2))
  j = int(np.clip(np.floor(fy), 0, nrow - 2))
  u, v = np.clip(fx - i, 0.0, 1.0), np.clip(fy - j, 0.0, 1.0)
  z = grid[j:j + 2, i:i + 2] * size[2]
  if u >= v:
    return z[0, 0] + (z[0, 1] - z[0, 0]) * u + (z[1, 1] - z[0, 1]) * v
  return z[0, 0] + (z[1, 1] - z[1, 0]) * u + (z[1, 0] - z[0, 0]) * v


def _hill_feet_on_terrain(mjm, mjd, q, depth):
  """q with the trunk's z moved so that the lowest foot sphere sits
  `depth` below the terrain under its centre."""
  import mujoco
  g = next(iter(_geoms(mjm, 'terrain')))
  hid = int(mjm.geom_dataid[g])
  grid = mjm.hfield_data[:mjm.hfield_nrow[hid] * mjm.hfield_ncol[hid]].reshape(
      mjm.hfield_nrow[hid], mjm.hfield_ncol[hid])
  size = mjm.hfield_size[hid]
  mjd.qpos[:] = q
  mujoco.mj_kinematics(mjm, mjd)
  gap = min(_lowest(mjm, mjd, f) - terrain_z(grid, size, *mjd.geom_xpos[f, :2])
            for f in _geoms(mjm, '_foot'))
  q = q.copy()
  q[2] -= gap + depth
  return q


def last_task_states(name, mjm, mjd, rng, pairs):
  """The golden's four states (qpos) of a task: Acrobot's angles uniform
  on the circle; Quadrotor at `home`, then moved by up to ~0.3 m and
  turned at random; OP3 Stand at `home` lowered 1 mm into the floor, then
  its joints drawn in their ranges, its lowest colliding geom (the second of `pairs`, the
  collision pairs) 0.5-3 mm into the floor; Quadruped Hill at
  `home` (its feet on the floor and on the flattened terrain at once),
  its joints spread by 0.2 rad and its feet 0.5-3 mm into the floor at
  the centre, and at HILL_SPOTS on the rough terrain, turned about z,
  its lowest foot 0.5-3 mm into the terrain."""
  if name == 'Acrobot':
    return rng.uniform(-np.pi, np.pi, (4, mjm.nq))
  home = mjm.key_qpos[0].copy() if mjm.nkey else mjm.qpos0.copy()
  out = [home]
  if name == 'Quadrotor':
    for _ in range(3):
      q = home.copy()
      q[:3] += rng.normal(scale=0.3, size=3)
      q[3:7] = _random_quat(rng)
      out.append(q)
  elif name == 'OP3 Stand':
    body = sorted({g for _, g in pairs})
    out = [_lower_to(mjm, mjd, home, 2, body, -0.001)]
    for _ in range(3):
      q = _joints_in_range(mjm, home.copy(), rng, 1)
      out.append(_lower_to(mjm, mjd, q, 2, body,
                           -rng.uniform(0.0005, 0.003)))
  elif name == 'Quadruped Hill':
    feet = _geoms(mjm, '_foot')
    q = home.copy()
    q[7:] += rng.normal(scale=0.2, size=12)
    out.append(_lower_to(mjm, mjd, q, 2, feet, -rng.uniform(0.0005, 0.003)))
    for x, y in HILL_SPOTS:
      q = home.copy()
      q[:2] = (x, y)
      q[3:7] = _yaw_quat(rng.uniform(-np.pi, np.pi))
      q[7:] += rng.normal(scale=0.1, size=12)
      out.append(_hill_feet_on_terrain(mjm, mjd, q,
                                       rng.uniform(0.0005, 0.003)))
  return np.stack(out)


def last_task_inputs(name, seed):
  """One task's golden inputs (numpy, default_rng(seed)): the four states
  of last_task_states, velocities normal (scale 0.1; Acrobot's 1.0) and
  controls uniform in their ranges; Quadrotor's goal mocap positions per
  state (the model's at state 0, moved by up to ~0.3 m) and its
  transition's times; Quadruped Hill's transition branches (the state 3
  on the hills, HILL_BRANCHES' modes with the gait switch on, the goal
  far away, _last_t 0.3 at time 1.7); the plan's knots (the middle of the
  control range) and noise."""
  import mujoco
  from mujoco_mpc_tpu.tasks import registry
  jspec = registry.get_task(name)
  mjm = jspec.mj_model
  mjd = mujoco.MjData(mjm)
  rng = np.random.default_rng(seed)
  q = last_task_states(name, mjm, mjd, rng, jspec.model.collision_pairs)
  clo, chi = mjm.actuator_ctrlrange.T
  out = {'qpos': q,
         'qvel': rng.normal(scale=1.0 if name == 'Acrobot' else 0.1,
                            size=(4, mjm.nv)),
         'ctrl': clo + (chi - clo) * rng.uniform(size=(4, mjm.nu))}
  mp = np.broadcast_to(mjd.mocap_pos, (4,) + mjd.mocap_pos.shape).copy()
  if name == 'Quadrotor':
    mp[1:] += rng.normal(scale=0.3, size=mp[1:].shape)
    out['transition/time'] = np.array([0.0, 0.37, 2.5, 11.9])
  out['mocap_pos'] = mp
  if name == 'Quadruped Hill':
    names = list(jspec.residual_param_names)
    rp = np.asarray(jspec.default_params.residual_params, np.float64)
    for branch, (mode, turn) in HILL_BRANCHES.items():
      p = rp.copy()
      p[names.index('select_Mode')] = mode
      p[names.index('select_Gait switch')] = 1.0
      p[names.index('Walk turn')] = turn
      p[names.index('_last_t')] = 0.3
      out[f'transition/{branch}/residual_params'] = p
    goal = mp[3].copy()
    goal[0, :2] = (-3.0, -3.0)
    out['transition/mocap_pos'] = goal
    out['transition/time'] = np.asarray(1.7)
  knots = int(jspec.config['sampling_spline_points'])
  out['plan/values'] = clo + (chi - clo) * rng.uniform(0.3, 0.7,
                                                        (knots, mjm.nu))
  out['plan/eps'] = rng.normal(size=(MANIPULATION_CANDIDATES - 1, knots,
                                     mjm.nu))
  out['plan/use2'] = rng.uniform(size=MANIPULATION_CANDIDATES - 1) < 0.2
  return {f'{name}/{k}': val for k, val in out.items()}


def jax_last_task_golden(name, inputs):
  """One task's golden outputs from the JAX package in float64, from its
  inputs: at each state (and its goal) qacc, qfrc_constraint, the
  residual, the next qpos and qvel (jax_step), OP3's and Hill's condim-3
  contact points; Quadrotor's actuator length, moment and qfrc_actuator,
  its transition's goal at each time, and its exact derivatives
  (derivatives.compute over a LAST_DERIV_STEPS-step nominal from state 1);
  Hill's transition in each branch (parameters, weights, goal) after
  JAX's kinematics and com velocities; the plan's returns and winner from
  state 1."""
  import jax
  import jax.numpy as jnp
  import torch
  from mujoco_mpc_tpu.physics import forward as jfwd
  from mujoco_mpc_tpu.physics import kinematics as jkin
  from mujoco_mpc_tpu.physics.model import make_data as jmake_data
  from mujoco_mpc_tpu.planners import derivatives as jder
  from mujoco_mpc_tpu.tasks import registry
  from mujoco_mpc_tpu_torch.physics.model import make_data
  jax.config.update('jax_enable_x64', True)
  jspec = registry.get_task(name)
  jm, jp = _f64(jspec.model), _f64(jspec.default_params)
  points = bool(jm.collision_pairs)
  run = jax_step(jspec, jm, jp, points=points)
  q, v, u, mp = (inputs[k] for k in ('qpos', 'qvel', 'ctrl', 'mocap_pos'))
  mq = np.broadcast_to(np.asarray(jm.body_quat)[[
      b for b in range(jm.nbody) if jm.body_mocapid[b] >= 0]],
                       mp.shape[:1] + (jm.nmocap, 4))
  res = run(q, v, u, mp, np.ascontiguousarray(mq))
  keys = ('qacc', 'qfrc_constraint', 'residual', 'cost', 'next_qpos',
          'next_qvel') + (('dist', 'pos', 'normal') if points else ())
  out = {k: x for k, x in zip(keys, res) if k != 'cost'}
  jd0 = jmake_data(jm, dtype=jnp.float64)
  if name == 'Quadrotor':
    act = jax.jit(lambda qq, vv, uu, pp: (lambda d: (
        d.actuator_length, d.actuator_moment, d.qfrc_actuator))(
            jfwd.forward(jm, jd0.replace(qpos=qq, qvel=vv, ctrl=uu,
                                         mocap_pos=pp))))
    got = [act(*(jnp.asarray(x[i]) for x in (q, v, u, mp)))
           for i in range(len(q))]
    for k, key in enumerate(('actuator_length', 'actuator_moment',
                             'qfrc_actuator')):
      out[key] = np.stack([np.asarray(g[k]) for g in got])
    out['transition/mocap_pos'] = np.stack([np.asarray(jspec.transition_fn(
        jm, jd0.replace(time=jnp.asarray(t)), jp, jax.random.key(0))[0]
        .mocap_pos) for t in inputs['transition/time']])
    acts = np.random.default_rng(3).uniform(
        np.asarray(jm.actuator_ctrlrange)[:, 0],
        np.asarray(jm.actuator_ctrlrange)[:, 1], (LAST_DERIV_STEPS, jm.nu))
    out['derivatives/actions'] = acts
    d1 = jd0.replace(qpos=jnp.asarray(q[1]), qvel=jnp.asarray(v[1]))
    traj = jder.nominal_trajectory(jspec, d1, jnp.asarray(acts), jp)
    der = jax.jit(lambda tr: jder.compute(jspec, d1, tr, jp))(traj)
    for k in ('a', 'b', 'cx', 'cu', 'cxx', 'cxu', 'cuu'):
      out['derivatives/' + k] = np.asarray(getattr(der, k))
  if name == 'Quadruped Hill':
    kin = jax.jit(lambda d: jkin.com_vel(jm, jkin.com_pos(
        jm, jkin.kinematics(jm, d))))
    jd = kin(jd0.replace(
        time=jnp.asarray(inputs['transition/time']), qpos=jnp.asarray(q[3]),
        qvel=jnp.asarray(v[3]),
        mocap_pos=jnp.asarray(inputs['transition/mocap_pos'])))
    for branch in HILL_BRANCHES:
      p = jp.replace(residual_params=jnp.asarray(
          inputs[f'transition/{branch}/residual_params']))
      jd2, p2 = jspec.transition_fn(jm, jd, p, jax.random.key(0))
      out[f'transition/{branch}/next_residual_params'] = np.asarray(
          p2.residual_params)
      out[f'transition/{branch}/next_weights'] = np.asarray(p2.weights)
      out[f'transition/{branch}/next_mocap_pos'] = np.asarray(jd2.mocap_pos)
  port = port_registry.get_task(name, device='cpu', dtype=torch.float64)
  d0 = make_data(port.model).replace(qpos=torch.from_numpy(q[1:2]),
                                     qvel=torch.from_numpy(v[1:2]))
  plan = port_plan(port, d0, inputs, MANIPULATION_STEPS, candidates=True)
  out['plan/returns'], out['plan/winner'] = jax_plan(run, plan, q[1], v[1],
                                                     MANIPULATION_STEPS)
  return {f'{name}/{k}': val for k, val in out.items()}


def write_last_tasks_golden(path):
  """Write the last four tasks' golden (inputs, JAX outputs,
  provenance)."""
  import jax
  arrays = {}
  for seed, name in enumerate(LAST_TASKS):
    inputs = last_task_inputs(name, 51 + seed)
    arrays.update(inputs)
    arrays.update(jax_last_task_golden(name, task_inputs(inputs, name)))
  np.savez(path, **arrays, provenance=np.asarray(json.dumps({
      'jax': jax.__version__, 'dtype': 'float64',
      'command': LAST_TASKS_COMMAND,
      'inputs': 'last_task_inputs: numpy default_rng(51 + the task\'s '
                'index in LAST_TASKS)'})))


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


PHYSICS_MODELS = 'physics_models.npz'
PHYSICS_GOLDEN = 'physics_features_golden.npz'
PHYSICS_GOLDEN_COMMAND = ('python tools/export_torch_snapshot.py '
                          '--physics-golden')
# the golden's trajectories: this many samples a model, this many steps
PHYSICS_GOLDEN_BATCH = 4
PHYSICS_GOLDEN_STEPS = 20

# The gravity-compensation model of the physics slice (the JAX package's
# tests have none): a floating base fully compensated, a limited hinge
# link at gravcomp 0.5 (its limit row keeps B2 on the path) and an
# uncompensated tip link.
GRAVCOMP_XML = """
<mujoco>
  <option timestep="0.005" gravity="0 0 -9.81"/>
  <worldbody>
    <body name="base" pos="0 0 1" gravcomp="1">
      <freejoint/>
      <geom type="box" size="0.1 0.1 0.05" mass="1" contype="0"
            conaffinity="0"/>
      <body name="l1" pos="0.1 0 0" gravcomp="0.5">
        <joint name="h1" type="hinge" axis="0 1 0" damping="0.05"
               limited="true" range="-0.5 0.5"/>
        <geom type="capsule" size="0.03" fromto="0 0 0 0.3 0 0" mass="0.4"
              contype="0" conaffinity="0"/>
        <body name="l2" pos="0.3 0 0">
          <joint name="h2" type="hinge" axis="0 0 1" damping="0.05"/>
          <geom type="capsule" size="0.03" fromto="0 0 0 0.2 0 0"
                mass="0.2" contype="0" conaffinity="0"/>
        </body>
      </body>
    </body>
  </worldbody>
  <actuator>
    <motor joint="h1" gear="1" ctrlrange="-1 1" ctrllimited="true"/>
    <motor joint="h2" gear="1" ctrlrange="-1 1" ctrllimited="true"/>
  </actuator>
</mujoco>
"""


# A tendon actuator pulling a spatial cable held at its range, and a box
# welded to the lifted body: the model of the physics slice's jacfwd test
# (torch.func.jacfwd of the port's step against jax.jacfwd of JAX's). The
# lift starts 5 cm low, so the cable's upper limit is engaged.
CABLE_WELD_XML = """
<mujoco>
  <option timestep="0.002" gravity="0 0 -9.81"/>
  <worldbody>
    <site name="top" pos="0 0 1.5"/>
    <body name="lift" pos="0 0 1">
      <joint name="lift" type="slide" axis="0 0 1" damping="2.0"/>
      <geom type="box" size="0.05 0.05 0.05" mass="0.5"/>
      <site name="hook" pos="0 0 0.05"/>
    </body>
    <body name="load" pos="0.2 0 1">
      <freejoint/>
      <geom type="box" size="0.04 0.04 0.04" mass="0.2" contype="0"
            conaffinity="0"/>
    </body>
  </worldbody>
  <tendon>
    <spatial name="cable" limited="true" range="0.1 0.48">
      <site site="top"/><site site="hook"/>
    </spatial>
  </tendon>
  <equality><weld body1="lift" body2="load"/></equality>
  <actuator>
    <motor tendon="cable" gear="-8" ctrlrange="0 1" ctrllimited="true"/>
  </actuator>
</mujoco>
"""

# Every geom type on its own free body over a floor: the physics slice's
# narrowphase test takes every pair of it at random poses.
ALL_PAIRS_XML = """
<mujoco>
  <asset>
    <mesh name="tet" vertex="0.05 0 0  -0.03 0.04 0  -0.03 -0.04 0
                             0 0 0.07"/>
  </asset>
  <worldbody>
    <geom name="floor" type="plane" size="2 2 0.1"/>
    <body><freejoint/><geom name="sphere" type="sphere" size="0.05"/></body>
    <body><freejoint/><geom name="capsule" type="capsule" size="0.04 0.08"/>
    </body>
    <body><freejoint/><geom name="ellipsoid" type="ellipsoid"
                            size="0.08 0.05 0.04"/></body>
    <body><freejoint/><geom name="cylinder" type="cylinder"
                            size="0.05 0.07"/></body>
    <body><freejoint/><geom name="cylinder2" type="cylinder"
                            size="0.04 0.1"/></body>
    <body><freejoint/><geom name="box" type="box" size="0.06 0.05 0.04"/>
    </body>
    <body><freejoint/><geom name="mesh" type="mesh" mesh="tet"/></body>
  </worldbody>
</mujoco>
"""
ALL_PAIRS_POSES = 64


def inline_xml(fn):
  """The MJCF string a test function assigns to its local `xml`."""
  import ast
  import textwrap
  tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
  for node in ast.walk(tree):
    if (isinstance(node, ast.Assign) and len(node.targets) == 1
        and getattr(node.targets[0], 'id', None) == 'xml'):
      return ast.literal_eval(node.value)
  raise ValueError(f'{fn.__name__} assigns no xml')


def physics_families():
  """{family: {model: (MJCF, its test's initial state {'qpos', 'qvel',
  'ctrl'} where it sets one)}}: the scenes of tests/test_convex_pairs.py
  and tests/test_contacts.py::test_plane_cylinder_exact, the tendon
  models of tests/test_tendons.py, the equality models of
  tests/test_equality.py, PENDULUM of tests/test_physics_golden.py with
  integrator RK4 (and with a joint limit, so that B2 runs four times a
  step), GRAVCOMP_XML and CABLE_WELD_XML."""
  import tests.test_contacts as tc
  import tests.test_convex_pairs as cp
  import tests.test_equality as te
  import tests.test_physics_golden as tg
  import tests.test_tendons as tt
  rk4 = tg.PENDULUM.replace('timestep="0.01"',
                            'timestep="0.01" integrator="RK4"')
  _, mjd, _, _ = tg._setup(rk4)      # test_rk4's state
  rk4_state = dict(qpos=mjd.qpos.copy(), qvel=mjd.qvel.copy(),
                   ctrl=mjd.ctrl.copy())
  weld_qvel = np.zeros(12)
  weld_qvel[0], weld_qvel[4], weld_qvel[9] = 0.3, 0.5, 0.2
  return {
      'convex': {
          'plane_ellipsoid': (inline_xml(cp.test_plane_ellipsoid_settles),
                              {}),
          'sphere_cylinder': (inline_xml(
              cp.test_sphere_cylinder_qacc_and_settle), {}),
          'sphere_cylinder_disc': (inline_xml(
              cp.test_sphere_cylinder_end_disc), {}),
          'capsule_box_edge': (inline_xml(cp.test_capsule_across_box_edge),
                               {}),
          'capsule_flat_box': (inline_xml(cp.test_capsule_flat_on_box), {}),
          'cylinder_box': (inline_xml(cp.test_cylinder_rests_on_box), {}),
          'cylinder_stack': (inline_xml(cp.test_cylinder_on_cylinder_stack),
                             {}),
          'sphere_ellipsoid': (inline_xml(cp.test_sphere_on_ellipsoid), {}),
          'plane_cylinder': (inline_xml(tc.test_plane_cylinder_exact), {})},
      'tendons': {
          'coupled': (tt.COUPLED, dict(qpos=[0.3, -0.2], qvel=[0.5, 0.8],
                                       ctrl=[1.0])),
          'split': (tt.TENDON_ACT, dict(ctrl=[0.7])),
          'wrap_cylinder': (tt.WRAP_CYL, dict(qpos=[0.9])),
          'wrap_sphere': (tt.WRAP_SPHERE, dict(qpos=[0.9])),
          'spatial': (tt.SPATIAL, dict(qpos=[0.5, -0.3])),
          'cable': (inline_xml(tt.test_spatial_tendon_actuator_and_limit),
                    dict(ctrl=[0.6])),
          'pulley': (inline_xml(tt.test_spatial_tendon_pulley_branches), {})},
      'equality': {
          'connect': (te.CONNECT, dict(qpos=[0.2, -0.1], qvel=[0.3, -0.4])),
          'weld': (te.WELD, dict(qvel=weld_qvel)),
          'joint_coupling': (te.JOINT_COUPLING, dict(qpos=[0.1, 0.3],
                                                     qvel=[0.2, 0.0])),
          'tendon_coupling': (te.TENDON_COUPLING, dict(qpos=[0.05, -0.02])),
          'cable_weld': (CABLE_WELD_XML, dict(qpos=[-0.05, 0.2, 0, 1, 1, 0,
                                                    0, 0], ctrl=[0.5]))},
      'rk4': {
          'pendulum_rk4': (rk4, rk4_state),
          'pendulum_limit_rk4': (rk4.replace(
              'type="hinge" axis="0 1 0"',
              'type="hinge" axis="0 1 0" limited="true" range="-0.3 0.3"'),
              {})},
      'gravcomp': {'gravcomp_chain': (GRAVCOMP_XML, {})}}


def physics_model_arrays():
  """The arrays of assets/physics_models.npz: per model `<name>/static`
  (JSON), `<name>/model/<field>` (its float64 put_model snapshot: the
  values JAX's float64 golden runs on), `<name>/family`
  and its test's initial state `<name>/qpos`, `/qvel`, `/ctrl` (the
  model's qpos0 and zeros where the test sets none)."""
  import jax
  import jax.numpy as jnp
  import mujoco
  from mujoco_mpc_tpu.physics.model import put_model
  jax.config.update('jax_enable_x64', True)
  out = {}
  for family, models in physics_families().items():
    for name, (xml, state) in models.items():
      mjm = mujoco.MjModel.from_xml_string(xml)
      arrays, static = model_snapshot(put_model(mjm, dtype=jnp.float64))
      out[f'{name}/static'] = np.asarray(json.dumps(static, sort_keys=True))
      out[f'{name}/family'] = np.asarray(family)
      out.update({f'{name}/model/{k}': v for k, v in arrays.items()})
      init = dict(qpos=np.array(mjm.qpos0), qvel=np.zeros(mjm.nv),
                  ctrl=np.zeros(mjm.nu))
      init.update({k: np.asarray(v, np.float64) for k, v in state.items()})
      out.update({f'{name}/{k}': v for k, v in init.items()})
  return out


def perturbed_states(z, name, bsz, rng):
  """bsz states of a physics model (its snapshot arrays z): its initial
  state, then that state moved by 0.01 in qpos (unit quaternions kept)
  and 0.1 in qvel; controls (bsz,) drawn by the caller."""
  static = json.loads(str(z[f'{name}/static']))
  qpos = np.repeat(z[f'{name}/qpos'][None], bsz, 0)
  qvel = np.repeat(z[f'{name}/qvel'][None], bsz, 0)
  qpos[1:] += 0.01 * rng.standard_normal(qpos[1:].shape)
  qvel[1:] += 0.1 * rng.standard_normal(qvel[1:].shape)
  for t, adr in zip(static['jnt_type'], static['jnt_qposadr']):
    quat = {0: adr + 3, 1: adr}.get(t)
    if quat is not None:
      q = qpos[:, quat:quat + 4]
      qpos[:, quat:quat + 4] = q / np.linalg.norm(q, axis=1, keepdims=True)
  return qpos, qvel


def physics_controls(z, name, shape, rng):
  """Controls (shape + (nu,)) uniform in the actuators' ctrlrange where
  limited, in [-1, 1] elsewhere."""
  static = json.loads(str(z[f'{name}/static']))
  rng_ = np.array(z[f'{name}/model/actuator_ctrlrange']).reshape(-1, 2)
  lim = np.asarray(static['actuator_ctrllimited'], bool)
  lo = np.where(lim, rng_[:, 0], -1.0)
  hi = np.where(lim, rng_[:, 1], 1.0)
  return lo + (hi - lo) * rng.random(tuple(shape) + (len(lo),))


def physics_golden_inputs(z):
  """{<name>/in_qpos (B, nq), in_qvel (B, nv), ctrl (T, B, nu)} of every
  physics model: PHYSICS_GOLDEN_BATCH perturbed states and
  PHYSICS_GOLDEN_STEPS steps of controls, numpy default_rng(61 + the
  model's index)."""
  names = sorted({k.split('/')[0] for k in z.files})
  out = {}
  for i, name in enumerate(names):
    rng = np.random.default_rng(61 + i)
    qpos, qvel = perturbed_states(z, name, PHYSICS_GOLDEN_BATCH, rng)
    out[f'{name}/in_qpos'] = qpos
    out[f'{name}/in_qvel'] = qvel
    out[f'{name}/ctrl'] = physics_controls(
        z, name, (PHYSICS_GOLDEN_STEPS, PHYSICS_GOLDEN_BATCH), rng)
  return out


def jax_physics_trajectory(xml, qpos, qvel, ctrl):
  """JAX's float64 trajectory of a model from states (B, ...) under
  controls (T, B, nu): (qpos (T, B, nq), qvel (T, B, nv)) after each
  step, the step jitted and vmapped once."""
  import jax
  import jax.numpy as jnp
  import mujoco
  from mujoco_mpc_tpu.physics import forward as jfwd
  from mujoco_mpc_tpu.physics.model import make_data, put_model
  jm = put_model(mujoco.MjModel.from_xml_string(xml), dtype=jnp.float64)
  jd0 = make_data(jm, dtype=jnp.float64)

  @jax.jit
  @jax.vmap
  def step(q, v, u):
    d = jfwd.step(jm, jd0.replace(qpos=q, qvel=v, ctrl=u))
    return d.qpos, d.qvel
  q, v = jnp.asarray(qpos), jnp.asarray(qvel)
  qs, vs = [], []
  for u in ctrl:
    q, v = step(q, v, jnp.asarray(u))
    qs.append(np.asarray(q))
    vs.append(np.asarray(v))
  return np.stack(qs), np.stack(vs)


PHYSICS_FWD_FIELDS = ('qacc', 'qfrc_constraint', 'qfrc_passive',
                      'qfrc_actuator', 'actuator_length', 'ten_length',
                      'ten_velocity', 'ten_J')


def jax_physics_forward(xml, qpos, qvel, ctrl):
  """JAX's float64 forward of one model at states (B, ...): PHYSICS_FWD_
  FIELDS, the sensors, and the equality and tendon-limit rows (j, pos,
  aref, d), as numpy (B, ...), under 'fwd/<field>', 'eq/<field>' and
  'tlim/<field>'."""
  import jax
  import jax.numpy as jnp
  import mujoco
  from mujoco_mpc_tpu.physics import constraint as jconstraint
  from mujoco_mpc_tpu.physics import forward as jfwd
  from mujoco_mpc_tpu.physics import sensors as jsensors
  from mujoco_mpc_tpu.physics.model import make_data, put_model
  jm = put_model(mujoco.MjModel.from_xml_string(xml), dtype=jnp.float64)
  jd0 = make_data(jm, dtype=jnp.float64)

  @jax.jit
  @jax.vmap
  def run(q, v, u):
    d = jfwd.forward(jm, jd0.replace(qpos=q, qvel=v, ctrl=u))
    out = {f'fwd/{k}': getattr(d, k) for k in PHYSICS_FWD_FIELDS}
    if jm.nsensordata:
      out['fwd/sensordata'] = jsensors.sensordata(jm, d)
    for key, fn in (('eq', jconstraint._equality_rows),
                    ('tlim', jconstraint._tendon_limit_rows)):
      rows = fn(jm, d)
      if rows is not None:
        out.update({f'{key}/{k}': getattr(rows, k)
                    for k in ('j', 'pos', 'aref', 'd')})
    return out
  return {k: np.asarray(v) for k, v in run(
      jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(ctrl)).items()}


def wrap_sweep_states(z, name):
  """tests/test_tendons.py's hinge sweep (9 angles in [-1.2, 1.2]) of a
  wrap model, and a random state of the two-link string
  (default_rng(3), as test_spatial_tendon_length_and_moment draws it)."""
  if name == 'spatial':
    rng = np.random.default_rng(3)
    return (0.3 * rng.standard_normal((1, 2)),
            0.5 * rng.standard_normal((1, 2)))
  q = np.linspace(-1.2, 1.2, 9)[:, None]
  return q, np.zeros_like(q)


def jax_cable_weld_jacobian(xml, qpos, qvel, ctrl):
  """jax.jacfwd of JAX's float64 step at one state of CABLE_WELD_XML: the
  next (qpos, qvel) in (qvel, ctrl), as 'jac/<out>_<in>' arrays."""
  import jax
  import jax.numpy as jnp
  import mujoco
  from mujoco_mpc_tpu.physics import forward as jfwd
  from mujoco_mpc_tpu.physics.model import make_data, put_model
  jm = put_model(mujoco.MjModel.from_xml_string(xml), dtype=jnp.float64)
  jd0 = make_data(jm, dtype=jnp.float64).replace(qpos=jnp.asarray(qpos))

  def step(v, u):
    d = jfwd.step(jm, jd0.replace(qvel=v, ctrl=u))
    return d.qpos, d.qvel
  jac = jax.jit(jax.jacfwd(step, argnums=(0, 1)))(jnp.asarray(qvel),
                                                 jnp.asarray(ctrl))
  return {f'jac/{o}_{i}': np.asarray(jac[a][b])
          for a, o in enumerate(('qpos', 'qvel'))
          for b, i in enumerate(('qvel', 'ctrl'))}


def all_pairs_poses(ngeom):
  """ALL_PAIRS_POSES random geom poses (xpos (B, ngeom, 3), xmat (B, ngeom,
  3, 3)), default_rng(67): the geoms within 0.08 of the origin, the floor
  at the origin, the poses rotated at random."""
  import mujoco
  rng = np.random.default_rng(67)
  xpos = 0.08 * rng.standard_normal((ALL_PAIRS_POSES, ngeom, 3))
  xpos[:, 0] = 0.0
  quat = rng.standard_normal((ALL_PAIRS_POSES, ngeom, 4))
  quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
  quat[:, 0] = (1.0, 0.0, 0.0, 0.0)
  xmat = np.zeros((ALL_PAIRS_POSES, ngeom, 9))
  for b in range(ALL_PAIRS_POSES):
    for g in range(ngeom):
      mujoco.mju_quat2Mat(xmat[b, g], quat[b, g])
  return xpos, xmat.reshape(ALL_PAIRS_POSES, ngeom, 3, 3)


def jax_all_pairs_points():
  """JAX's narrowphase on every collision pair of ALL_PAIRS_XML at
  all_pairs_poses: 'pairs/<g1>_<g2>/<dist, pos, normal>' (B, points, ...)
  and the poses 'pairs/xpos', 'pairs/xmat'."""
  import jax
  import jax.numpy as jnp
  import mujoco
  from mujoco_mpc_tpu.physics import collision as jcollision
  from mujoco_mpc_tpu.physics.model import make_data, put_model
  jm = put_model(mujoco.MjModel.from_xml_string(ALL_PAIRS_XML),
                 dtype=jnp.float64)
  jd0 = make_data(jm, dtype=jnp.float64)
  xpos, xmat = all_pairs_poses(jm.ngeom)
  out = {'pairs/xpos': xpos, 'pairs/xmat': xmat}
  for g1, g2 in jm.collision_pairs:
    pts = jax.jit(jax.vmap(lambda p, r, g1=g1, g2=g2: [
        tuple(cp[:3]) for cp in jcollision.narrowphase(
            jm, jd0.replace(geom_xpos=p, geom_xmat=r), g1, g2)]))(
                jnp.asarray(xpos), jnp.asarray(xmat))
    for k, name in enumerate(('dist', 'pos', 'normal')):
      out[f'pairs/{g1}_{g2}/{name}'] = np.stack(
          [np.asarray(cp[k]) for cp in pts], 1)
  return out


def physics_golden_arrays():
  """The arrays of assets/physics_features_golden.npz: the inputs of
  physics_golden_inputs and JAX's trajectories from them, <name>/qpos
  and <name>/qvel; JAX's forward at each model's test state
  (<name>/fwd/..., <name>/eq/..., <name>/tlim/...), at the wrap sweeps
  (<name>/sweep/...), jax.jacfwd of the step at CABLE_WELD_XML's state
  (cable_weld/jac/...) and the narrowphase of every pair of
  ALL_PAIRS_XML (pairs/...)."""
  import jax
  jax.config.update('jax_enable_x64', True)
  fams = {n: x for models in physics_families().values()
          for n, (x, _) in models.items()}
  path = os.path.join(port_registry.ASSETS, PHYSICS_MODELS)
  with np.load(path) as z:
    inputs = physics_golden_inputs(z)
    state = {n: [z[f'{n}/{k}'][None] for k in ('qpos', 'qvel', 'ctrl')]
             for n in fams}
    sweeps = {n: wrap_sweep_states(z, n)
              for n in ('wrap_cylinder', 'wrap_sphere', 'spatial')}
  out = dict(inputs)
  for name, xml in fams.items():
    q, v = jax_physics_trajectory(xml, inputs[f'{name}/in_qpos'],
                                  inputs[f'{name}/in_qvel'],
                                  inputs[f'{name}/ctrl'])
    out[f'{name}/qpos'], out[f'{name}/qvel'] = q, v
    out.update({f'{name}/{k}': a for k, a in jax_physics_forward(
        xml, *state[name]).items()})
  for name, (q, v) in sweeps.items():
    ctrl = np.zeros((q.shape[0], 0))
    out[f'{name}/sweep/qpos'], out[f'{name}/sweep/qvel'] = q, v
    out.update({f'{name}/sweep/{k}': a for k, a in jax_physics_forward(
        fams[name], q, v, ctrl).items()})
  q, v, u = (x[0] for x in state['cable_weld'])
  out.update({f'cable_weld/{k}': a for k, a in jax_cable_weld_jacobian(
      fams['cable_weld'], q, v, u).items()})
  out.update(jax_all_pairs_points())
  out['provenance'] = np.asarray(json.dumps({
      'jax': jax.__version__, 'dtype': 'float64',
      'command': PHYSICS_GOLDEN_COMMAND,
      'inputs': 'physics_golden_inputs: numpy default_rng(61 + the '
                "model's index in sorted order)"}))
  return out


def write(path: str, arrays: dict, static: dict) -> None:
  np.savez(path, static=np.asarray(json.dumps(static, sort_keys=True)),
           **arrays)


def main():
  goldens = {'--cube-golden': (CUBE_GOLDEN, write_cube_golden),
             '--estimator-golden': (ESTIMATOR_GOLDEN,
                                    write_estimator_golden),
             '--sensor-models': (SENSOR_MODELS, lambda path: np.savez(
                 path, **sensor_model_arrays())),
             '--manipulation-golden': (MANIPULATION_GOLDEN,
                                       write_manipulation_golden),
             '--box-pairs-golden': (BOX_PAIRS_GOLDEN,
                                    write_box_pairs_golden),
             '--last-tasks-golden': (LAST_TASKS_GOLDEN,
                                     write_last_tasks_golden),
             '--physics-models': (PHYSICS_MODELS, lambda path: np.savez(
                 path, **physics_model_arrays())),
             '--physics-golden': (PHYSICS_GOLDEN, lambda path: np.savez(
                 path, **physics_golden_arrays()))}
  flag = next((a for a in sys.argv[1:] if a in goldens), None)
  if flag:
    fname, writer = goldens[flag]
    path = os.path.join(port_registry.ASSETS, fname)
    writer(path)
    print(f'wrote {os.path.relpath(path, ROOT)} '
          f'({os.path.getsize(path)} bytes)')
    return
  from mujoco_mpc_tpu.tasks import registry
  names = [a for a in sys.argv[1:] if not a.startswith('--')]
  for name, (fname, _) in port_registry.TASKS.items():
    if names and name not in names:
      continue
    path = os.path.join(port_registry.ASSETS, fname)
    write(path, *task_snapshot(registry.get_task(name)))
    print(f'wrote {os.path.relpath(path, ROOT)} '
          f'({os.path.getsize(path)} bytes)')


if __name__ == '__main__':
  main()
