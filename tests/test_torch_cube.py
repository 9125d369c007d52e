"""The Cube Solving slice of the port against the JAX package, float64.

Cube Solving (models/rubik.py in the generated hand; nv 87, nu 15) has
507 collision pairs: 310 cubelet mesh-mesh pairs of condim 1 in one
cluster, whose candidates are selected per sample (the broadphase's 64
nearest pairs, then the 128 deepest of their 512 points), and 197
condim-3 pairs whose 457 points are capped to their 64 deepest (256
dense facet rows); 66 dofs carry frictionloss rows. A jitted JAX step
compiles for minutes, so JAX's colliders, rows and residual run on the
port's Data fields (kinematics, com and cdof from the port's forward) as
one jitted vmap, its transition eagerly, and the slice as a whole is held
to
assets/cube_solving_golden.npz, written once from the JAX package by
tools/export_torch_snapshot.py (its inputs, its JAX version and its
command are in the file); test_golden_is_jaxs recomputes it live (slow).

* the broadphase and mesh_mesh_batched at two states (`home`, and the
  cube pressed into the palm with its faces mid-turn and its ring
  cubelets rattled, so that cubelets interpenetrate), compared as sets
  where equal depths may order differently;
* the dynamically selected mesh-mesh rows (128) and the capped condim-3
  rows (256) at the same states;
* the residual, and the transition's branches: a move achieved (the
  goal index steps down, the cube snaps onto the exact state), the last
  move (solved: the mode turns off), neither, and a dropped cube;
* one Cube Solving step at B 2 and a 4-candidate x 3-step plan against
  the golden file.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu.physics import collision as jcollision
from mujoco_mpc_tpu.physics import constraint as jconstraint
from mujoco_mpc_tpu.physics.model import make_data as jmake_data
from mujoco_mpc_tpu.tasks import registry as jregistry
from mujoco_mpc_tpu_torch.physics import collision
from mujoco_mpc_tpu_torch.physics import constraint
from mujoco_mpc_tpu_torch.physics import forward as fwd
from mujoco_mpc_tpu_torch.physics.model import make_data
from mujoco_mpc_tpu_torch.tasks import registry
from tools import export_torch_snapshot as export

torch.set_num_threads(1)

# XLA's quick compile for the JAX rows (its default optimisation passes
# took longer than the calls they speed up)
QUICK_COMPILE = {'xla_backend_optimization_level': 0,
                 'xla_llvm_disable_expensive_passes': True}

# the port's forward fields the JAX rows and colliders read
FIELDS = ('qpos', 'qvel', 'ctrl', 'xpos', 'xquat', 'xmat', 'geom_xpos',
          'geom_xmat', 'site_xpos', 'subtree_com', 'cdof', 'cvel', 'qM',
          'actuator_force')


def _f64(tree):
  return jax.tree.map(
      lambda x: x.astype(jnp.float64)
      if jnp.issubdtype(getattr(x, 'dtype', np.int32), jnp.floating) else x,
      tree)


@pytest.fixture(scope='module')
def tasks():
  """(JAX spec, its model and params in f64, the port's spec in f64)."""
  jspec = jregistry.get_task('Cube Solving')
  spec = registry.get_task('Cube Solving', device='cpu', dtype=torch.float64)
  return jspec, _f64(jspec.model), _f64(jspec.default_params), spec


@pytest.fixture(scope='module')
def states(tasks):
  """The port's forward Data at `home` and at export.cube_contact_state,
  and JAX's (mesh_mesh_batched, _dyn_contact_rows, contact_point_groups'
  capped rows, residual) on the same fields, one jitted vmap over both
  (XLA's quick compile; the narrowphase traced once: both row functions
  get the one _contact_groups result)."""
  jspec, jm, jparams, spec = tasks
  m = spec.model
  qpos = np.stack([m.keyframe_qpos('home').numpy(),
                   export.cube_contact_state(m.keyframe_qpos('home').numpy())])
  d = fwd.forward(m, make_data(m, 2).replace(qpos=torch.from_numpy(qpos)))
  jd0 = jmake_data(jm, dtype=jnp.float64)
  cl = collision.contact_clusters(spec.model)[0][0]

  def rows(*fields):
    jd = jd0.replace(**dict(zip(FIELDS, fields)))
    groups = jconstraint._contact_groups(jm, jd)
    traced = jconstraint._contact_groups
    jconstraint._contact_groups = lambda *_: groups
    try:
      out = (jcollision.mesh_mesh_batched(jm, jd, cl),
             jconstraint._dyn_contact_rows(jm, jd),
             jconstraint.contact_point_groups(jm, jd)[1],
             jspec.residual_fn(jm, jd, jparams.residual_params))
    finally:
      jconstraint._contact_groups = traced
    return out

  fields = [jnp.asarray(getattr(d, f).numpy()) for f in FIELDS]
  want = jax.jit(jax.vmap(rows), compiler_options=QUICK_COMPILE)(*fields)
  return d, jax.tree.map(np.asarray, want)


def _rowsort(*cols):
  """An order of the rows of (B, n, ...) arrays, per sample, by their
  values: lexicographic over the columns, so that two lists of the same
  rows compare equal whatever order equal keys took."""
  keys = np.concatenate([np.asarray(c).reshape(c.shape[0], c.shape[1], -1)
                         for c in cols], -1)
  return np.stack([np.lexsort(np.round(k, 9).T[::-1]) for k in keys])


def _take(x, order):
  x = np.asarray(x)
  return np.stack([xi[o] for xi, o in zip(x, order)])


def test_mesh_mesh_batched(tasks, states):
  """The broadphase's 64 pairs of 310 and their 8 candidates each: the
  same pairs, and per pair and direction the same depths and normals.
  `home` aligns the cubelets exactly, so several vertices of a hull can
  tie for its k-th deepest place, and the two packages' rounding picks
  one of them each: a point at its group's deepest-but-cut depth is
  compared by depth and normal only, every other point by position too."""
  _, _, _, spec = tasks
  d, (want, _, _, _) = states
  got = [t.numpy() for t in collision.mesh_mesh_batched(
      spec.model, d, spec.model.contact_dyn[0].cluster)]
  assert got[0].shape == (2, 512)
  np.testing.assert_array_equal(np.sort(got[3], 1), np.sort(want[3], 1))
  # group: (pair, direction); points of a group sorted by depth, position
  half = np.arange(512)[None] // 256 + np.zeros((2, 1), int)
  og = _rowsort((got[3] * 2 + half)[..., None], got[0], got[1])
  ow = _rowsort((want[3] * 2 + half)[..., None], want[0], want[1])
  g = [_take(x, og) for x in got[:3]]
  w = [_take(x, ow) for x in want[:3]]
  np.testing.assert_allclose(g[0], w[0], rtol=1e-9, atol=1e-10)
  np.testing.assert_allclose(g[2], w[2], rtol=1e-9, atol=1e-10)
  cut = np.repeat(w[0].reshape(2, -1, 4).max(-1), 4, 1)   # (B, 128)
  sure = np.abs(w[0] - cut) > 1e-9
  np.testing.assert_allclose(g[1][sure], w[1][sure], rtol=1e-9, atol=1e-10)


def _rows_close(got, want, n):
  """Dense Rows of the port (B, n, ...) against JAX's (vmapped), as sets
  of rows."""
  assert got.j.shape[1] == n
  w = {k: getattr(want, k) for k in ('j', 'pos', 'aref', 'd', 'active')}
  og = _rowsort(got.pos.numpy()[..., None], got.aref.numpy()[..., None],
                got.j.numpy())
  ow = _rowsort(w['pos'][..., None], w['aref'][..., None], w['j'])
  for k in ('j', 'pos', 'aref', 'd', 'active'):
    np.testing.assert_allclose(_take(getattr(got, k).numpy(), og),
                               _take(w[k], ow), rtol=1e-9, atol=1e-10,
                               err_msg=k)


def test_dyn_contact_rows(tasks, states):
  """The 128 deepest mesh-mesh candidates as condim-1 rows."""
  _, _, _, spec = tasks
  d, (_, want, _, _) = states
  got = constraint._dyn_contact_rows(spec.model, d)
  _rows_close(got, want, 128)
  assert int(got.active[1].sum()) > 0


def test_capped_point_rows(tasks, states):
  """The 64 deepest of the 457 condim-3 points as 256 facet rows."""
  _, _, _, spec = tasks
  d, (_, _, want, _) = states
  points, got = constraint.contact_point_groups(spec.model, d)
  assert points == []
  _rows_close(got, want, 256)
  assert int(got.active[1].sum()) > 0


def test_residual(tasks, states):
  _, _, _, spec = tasks
  d, (_, _, _, want) = states
  got = spec.residual_fn(spec.model, d, spec.default_params.residual_params)
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-10)


def _transition_case(spec, case):
  """(qpos, residual params) of a transition branch from the scramble's
  exact states: 'achieved' (the first goal met), 'solved' (the last one),
  'neither' (the faces 0.5 off the goal) and 'dropped' (off the goal and
  below the floor)."""
  m = spec.model
  names = spec.residual_param_names
  rp = spec.default_params.residual_params.numpy().copy()
  qpos = m.keyframe_qpos('home').numpy().copy()
  task = export.rubik_arrays(jregistry.get_task('Cube Solving'))
  gi = int(round(rp[names.index('_goal_index')]))
  if case == 'solved':
    gi = 0
    rp[names.index('_goal_index')] = 0.0
  qpos[7:93] = task['states'][gi, 7:]
  if case in ('neither', 'dropped'):
    qpos[7:13] += 0.5
  if case == 'dropped':
    qpos[2] = -0.2
  return qpos, rp


@pytest.mark.parametrize('case', ['achieved', 'solved', 'neither',
                                  'dropped'])
def test_transition(tasks, case):
  jspec, jm, jparams, spec = tasks
  m = spec.model
  qpos, rp = _transition_case(spec, case)
  qvel = np.random.default_rng(1).normal(scale=0.1, size=m.nv)
  d = fwd.forward(m, make_data(m).replace(qpos=torch.from_numpy(qpos)[None],
                                          qvel=torch.from_numpy(qvel)[None]))
  p = spec.default_params.replace(residual_params=torch.from_numpy(rp))
  d2, p2 = spec.transition_fn(m, d, p, None)
  jd = jmake_data(jm, dtype=jnp.float64).replace(
      **{f: jnp.asarray(getattr(d, f)[0].numpy()) for f in FIELDS})
  jd2, jp2 = jspec.transition_fn(
      jm, jd, jparams.replace(residual_params=jnp.asarray(rp)), None)
  np.testing.assert_allclose(d2.qpos[0].numpy(), np.asarray(jd2.qpos),
                             rtol=1e-9, atol=1e-10)
  np.testing.assert_allclose(d2.qvel[0].numpy(), np.asarray(jd2.qvel),
                             rtol=1e-9, atol=1e-10)
  np.testing.assert_allclose(p2.residual_params.numpy(),
                             np.asarray(jp2.residual_params), rtol=1e-9,
                             atol=1e-10)
  moved = not np.array_equal(p2.residual_params.numpy(), rp)
  assert moved == (case in ('achieved', 'solved'))


@pytest.fixture(scope='module')
def golden():
  path = os.path.join(registry.ASSETS, export.CUBE_GOLDEN)
  with np.load(path) as z:
    return {k: z[k] for k in z.files}


def test_step_matches_the_golden(tasks, golden):
  """One step at B 2 from the golden's states: qacc, qfrc_constraint,
  the residual, and the next qpos and qvel."""
  _, _, _, spec = tasks
  got = export.cube_step(spec, golden)
  np.testing.assert_allclose(got['qacc'], golden['step/qacc'], rtol=1e-7,
                             atol=1e-5)
  np.testing.assert_allclose(got['qfrc_constraint'],
                             golden['step/qfrc_constraint'], rtol=1e-7,
                             atol=1e-5)
  np.testing.assert_allclose(got['residual'], golden['step/residual'],
                             rtol=1e-9, atol=1e-10)
  for k in ('next_qpos', 'next_qvel'):
    np.testing.assert_allclose(got[k], golden['step/' + k], rtol=1e-8,
                               atol=1e-8, err_msg=k)


def test_plan_matches_the_golden(tasks, golden):
  """A 4-candidate x 3-step Predictive Sampling plan from `home` with the
  golden's noise: the same returns and winner."""
  _, _, _, spec = tasks
  got = export.cube_plan(spec, golden)
  np.testing.assert_allclose(got['returns'], golden['plan/returns'],
                             rtol=1e-8)
  assert int(got['winner']) == int(golden['plan/winner'])


@pytest.mark.slow
def test_golden_is_jaxs(golden):
  """The golden file is what the JAX package computes now: its step and
  plan recomputed live from the file's inputs (~7 minutes on a CPU:
  JAX's step compiles once, for minutes)."""
  inputs = {k: golden[k] for k in ('step/qpos', 'step/qvel', 'step/ctrl',
                                   'plan/values', 'plan/eps', 'plan/use2')}
  want = export.jax_cube_golden(inputs)
  for k, v in want.items():
    np.testing.assert_allclose(v, golden[k], rtol=1e-10, atol=1e-12,
                               err_msg=k)
