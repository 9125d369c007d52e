"""The cylinder and ellipsoid pairs of the port against the JAX package and
MuJoCo, float64 on the CPU, and the physics slice's shared fixtures.

The models are the scenes of tests/test_convex_pairs.py and
tests/test_contacts.py::test_plane_cylinder_exact, carried as
assets/physics_models.npz (tools/export_torch_snapshot.py
--physics-models); JAX's references are assets/physics_features_golden.npz
(--physics-golden), which test_golden_is_jaxs (slow) recomputes live.

* _plane_cylinder, _plane_ellipsoid, _sphere_cylinder and
  _cylinder_axis_contact against JAX's under one jitted vmap each, on 256
  configurations each from a numpy seed (every point's dist, pos and
  normal; atol 1e-10), the ties among them: an upright cylinder on a plane
  (the radial direction from the frame's x), a lying one (the second rim
  points), a sphere on the axis above an end disc, crossed and parallel
  cylinders (the floored denominator, axis-aligned and dyadic).
* narrowphase on every pair of export.ALL_PAIRS_XML (a plane, a sphere, a
  capsule, an ellipsoid, two cylinders, a box and a mesh) at 64 random
  poses against JAX's (atol 1e-10), with points_per_pair its length.
* each scene's trajectory at 4 states against JAX's for 20 steps of
  random controls (rtol 1e-7, atol 1e-9; where rows stay active, the
  solvers' stopping rule bounds the agreement: SOLVER_BOUND, rtol 1e-6,
  atol 5e-7), and against mj_step at the JAX
  test's tolerance (the sphere on the lying cylinder also its qacc
  against mj_forward, 1e-4): over a prefix of the JAX test's steps here
  (SCENES' third entry; along the whole trajectory every step of the
  port is within the tolerance of MuJoCo's), and over the JAX test's own
  count with its resting heights in test_scene_settles_as_in_mujoco_full
  (slow).
* the models' file matches a fresh export.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu.physics import collision as jcollision
from mujoco_mpc_tpu_torch import convert
from mujoco_mpc_tpu_torch.physics import collision
from mujoco_mpc_tpu_torch.physics import forward as fwd
from mujoco_mpc_tpu_torch.physics import model as model_lib
from mujoco_mpc_tpu_torch.tasks import registry
from tools import export_torch_snapshot as export

torch.set_num_threads(1)

N = 256
GOLDEN_RTOL, GOLDEN_ATOL = 1e-7, 1e-9
# Models whose rows stay active through the golden's 20 steps (a resting
# lying cylinder's four rim points, a weld, a joint coupling, a joint
# limit): there JAX's Newton and the port's stop at different iterates
# within their tolerance, |step| <= 1e-8 (1 + |qacc|), so their states
# part by up to 1.61e-7 over 20 steps.
SOLVER_BOUND = {'plane_cylinder', 'weld', 'joint_coupling', 'cable_weld',
                'gravcomp_chain'}
SOLVER_RTOL, SOLVER_ATOL = 1e-6, 5e-7


# ---------------------------------------------------------------------------
# Shared by the physics slice's test files
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def models_file():
  with np.load(os.path.join(registry.ASSETS, export.PHYSICS_MODELS),
               allow_pickle=False) as z:
    return {k: z[k] for k in z.files}


@functools.lru_cache(maxsize=None)
def golden_file():
  with np.load(os.path.join(registry.ASSETS, export.PHYSICS_GOLDEN),
               allow_pickle=False) as z:
    return {k: z[k] for k in z.files}


@functools.lru_cache(maxsize=None)
def xmls():
  return {n: x for models in export.physics_families().values()
          for n, (x, _) in models.items()}


def family(name):
  return [n for n, f in models_file().items()
          if n.endswith('/family') and str(f) == name]


def names(fam):
  """The models of a family, in the file's order."""
  return [k.split('/')[0] for k in family(fam)]


@functools.lru_cache(maxsize=None)
def port_model(name):
  """The port's float64 CPU model of a physics model, from the file."""
  z = models_file()
  return model_lib.from_arrays(
      convert.group(z, f'{name}/model/'), json.loads(str(z[f'{name}/static'])),
      device='cpu', dtype=torch.float64)


def initial_state(name):
  """The model's test state (qpos, qvel, ctrl), numpy."""
  z = models_file()
  return tuple(np.array(z[f'{name}/{k}']) for k in ('qpos', 'qvel', 'ctrl'))


def port_data(name, qpos, qvel, ctrl):
  """Data of the port's model at states (B, ...) or one state (...)."""
  m = port_model(name)
  arr = [torch.from_numpy(np.array(x, np.float64)) for x in (qpos, qvel,
                                                             ctrl)]
  arr = [x if x.dim() == 2 else x[None] for x in arr]
  return model_lib.make_data(m, arr[0].shape[0]).replace(
      qpos=arr[0], qvel=arr[1], ctrl=arr[2])


def check_golden_trajectory(name):
  """The port's trajectory from the golden's 4 states under its controls
  against JAX's, every step (rtol 1e-7, atol 1e-9; SOLVER_BOUND models
  rtol 1e-6, atol 5e-7)."""
  rtol, atol = ((SOLVER_RTOL, SOLVER_ATOL) if name in SOLVER_BOUND
                else (GOLDEN_RTOL, GOLDEN_ATOL))
  g = golden_file()
  m = port_model(name)
  ctrl = g[f'{name}/ctrl']
  d = port_data(name, g[f'{name}/in_qpos'], g[f'{name}/in_qvel'], ctrl[0])
  with torch.inference_mode():
    for t in range(ctrl.shape[0]):
      d = fwd.step(m, d.replace(ctrl=torch.from_numpy(ctrl[t])))
      for k in ('qpos', 'qvel'):
        np.testing.assert_allclose(
            getattr(d, k).numpy(), g[f'{name}/{k}'][t], rtol=rtol,
            atol=atol, err_msg=f'{name} {k} at step {t + 1}')
      assert torch.isfinite(d.qpos).all()


def roll_with_mujoco(name, steps, ctrl_fn=None, state=None):
  """`steps` steps of the port and of mj_step from the model's test state
  (or `state`), controls ctrl_fn(i) where given: (MjData, Data)."""
  qpos, qvel, ctrl = state or initial_state(name)
  mjm = mujoco.MjModel.from_xml_string(xmls()[name])
  mjd = mujoco.MjData(mjm)
  mjd.qpos[:], mjd.qvel[:], mjd.ctrl[:] = qpos, qvel, ctrl
  m = port_model(name)
  d = port_data(name, qpos, qvel, ctrl)
  with torch.inference_mode():
    for i in range(steps):
      if ctrl_fn is not None:
        u = np.asarray(ctrl_fn(i), np.float64)
        mjd.ctrl[:] = u
        d = d.replace(ctrl=torch.from_numpy(u)[None])
      mujoco.mj_step(mjm, mjd)
      d = fwd.step(m, d)
  return mjd, d


def check_golden_forward(name, fields, d=None, key='fwd', rtol=1e-8,
                         atol=1e-10):
  """The port's forward at the model's test state (or post-forward Data
  d) against JAX's, the golden's `key` group (single-call tolerances)."""
  g = golden_file()
  if d is None:
    d = fwd.forward(port_model(name), port_data(name, *initial_state(name)))
  for k in fields:
    np.testing.assert_allclose(getattr(d, k).numpy(),
                               g[f'{name}/{key}/{k}'], rtol=rtol, atol=atol,
                               err_msg=f'{name} {k}')
  return d


# ---------------------------------------------------------------------------
# The colliders against JAX's
# ---------------------------------------------------------------------------


def _jax(fn, *args):
  """fn under one jitted vmap on numpy args: its points' (dist, pos,
  normal) as numpy."""
  jax.config.update('jax_enable_x64', True)
  out = jax.jit(jax.vmap(lambda *a: [tuple(p[:3]) for p in fn(*a)]))(
      *(jnp.asarray(x) for x in args))
  return [[np.asarray(x) for x in p] for p in out]


def _same(got, want, what):
  assert len(got) == len(want), what
  for k, (g, w) in enumerate(zip(got, want)):
    for name, a, b in zip(('dist', 'pos', 'normal'), g[:3], w):
      np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-10,
                                 err_msg=f'{what} point {k} {name}')


def _t(x):
  return torch.from_numpy(np.asarray(x, np.float64))


def _rotations(rng, n):
  q = rng.normal(size=(n, 4))
  q /= np.linalg.norm(q, axis=1, keepdims=True)
  out = np.zeros((n, 9))
  for i in range(n):
    mujoco.mju_quat2Mat(out[i], q[i])
  return out.reshape(n, 3, 3)


# frames with the z axis along +-x, +-y, +-z (dyadic, exact)
_AXES = np.array([np.eye(3), np.eye(3)[[1, 2, 0]].T, np.eye(3)[[2, 0, 1]].T,
                  np.diag([1.0, -1.0, -1.0]), np.eye(3)[[0, 2, 1]].T
                  * np.array([1.0, 1.0, -1.0])])


def _frames(rng, n):
  """n frames: a quarter random, the rest axis-aligned (dyadic)."""
  out = _AXES[rng.integers(0, len(_AXES), n)]
  k = n // 4
  out[:k] = _rotations(rng, k)
  return out


def test_plane_cylinder_matches_jax():
  """Upright (axis along the normal: the frame's x), lying (|axis . n| <
  0.05: the second rim points) and tilted cylinders, above and below the
  plane."""
  rng = np.random.default_rng(71)
  pn = np.tile([0.0, 0.0, 1.0], (N, 1))
  pn[: N // 4] = rng.normal(size=(N // 4, 3))
  pn /= np.linalg.norm(pn, axis=1, keepdims=True)
  pp = rng.normal(scale=0.1, size=(N, 3))
  c = rng.normal(scale=0.2, size=(N, 3))
  mat = _frames(rng, N)
  size = np.tile([0.125, 0.25, 0.0], (N, 1))
  got = collision._plane_cylinder(*(_t(x) for x in (pp, pn, c, mat)),
                                  _t(size[0]))
  _same(got, _jax(jcollision._plane_cylinder, pp, pn, c, mat, size),
        'plane-cylinder')
  flat = np.abs(np.sum(pn * mat[..., 2], -1)) < 0.05
  assert flat.any() and (~flat).any()
  assert (got[2].dist.numpy()[~flat] == 1e6).all()


def test_plane_ellipsoid_matches_jax():
  rng = np.random.default_rng(72)
  pn = rng.normal(size=(N, 3))
  pn /= np.linalg.norm(pn, axis=1, keepdims=True)
  pn[: N // 2] = (0.0, 0.0, 1.0)
  pp = rng.normal(scale=0.1, size=(N, 3))
  c = rng.normal(scale=0.2, size=(N, 3))
  mat = _frames(rng, N)
  size = np.tile([0.25, 0.125, 0.0625], (N, 1))
  got = collision._plane_ellipsoid(*(_t(x) for x in (pp, pn, c, mat)),
                                   _t(size[0]))
  _same(got, _jax(jcollision._plane_ellipsoid, pp, pn, c, mat, size),
        'plane-ellipsoid')


def test_sphere_cylinder_matches_jax():
  """Sphere centres outside (side, disc, rim), inside (the side or the
  disc nearer) and on the axis (the radial fallback), some on the disc's
  plane or the side's surface exactly."""
  rng = np.random.default_rng(73)
  cc = rng.normal(scale=0.1, size=(N, 3))
  cmat = _frames(rng, N)
  rad_c, half = 0.25, 0.5
  local = rng.uniform(-0.75, 0.75, size=(N, 3))
  local[::8, :2] = 0.0                                  # on the axis
  local[1::8, 2] = half                                 # on the disc plane
  local[2::8, :2] = (rad_c, 0.0)                        # on the side
  local[3::8] *= 0.25                                   # inside
  c = cc + np.einsum('bij,bj->bi', cmat, local)
  r = np.full(N, 0.125)
  csize = np.tile([rad_c, half, 0.0], (N, 1))
  got = collision._sphere_cylinder(_t(c), _t(r[0]), _t(cc), _t(cmat),
                                   _t(csize[0]))
  _same(got, _jax(jcollision._sphere_cylinder, c, r, cc, cmat, csize),
        'sphere-cylinder')


def test_cylinder_axis_contact_matches_jax():
  """Crossed (the side-side region), parallel and collinear axes (the
  denominator floored at 1e-12: axis-aligned, since in a rotated frame the
  floor turns XLA's fused multiply-adds into different points), ends
  beyond the 99 % interior, and separated and overlapping cylinders."""
  rng = np.random.default_rng(74)
  p1 = rng.normal(scale=0.1, size=(N, 3))
  m1 = _frames(rng, N)
  m2 = _frames(rng, N)
  par = np.arange(N // 4, N, 4)         # parallel axes, axis-aligned:
  m2[par] = m1[par]                     # exact, as the denominator floors
  off = rng.normal(scale=0.2, size=(N, 3))
  # crossed: axis 2 along axis 1's frame y, the offset along its x, apart
  # or overlapping
  gap = np.where(np.arange(1, N, 4) % 8 == 1, 0.25, 0.15)
  off[1::4] = np.einsum('bij,bj->bi', m1[1::4],
                        gap[:, None] * np.array([1.0, 0.0, 0.0]))
  m2[1::4] = np.einsum('bij,jk->bik', m1[1::4], _AXES[2])
  p2 = p1 + off
  s1 = np.tile([0.125, 0.5, 0.0], (N, 1))
  s2 = np.tile([0.0625, 0.25, 0.0], (N, 1))
  got = collision._cylinder_axis_contact(_t(p1), _t(m1), _t(s1[0]), _t(p2),
                                         _t(m2), _t(s2[0]))
  _same(got, _jax(jcollision._cylinder_axis_contact, p1, m1, s1, p2, m2,
                  s2), 'cylinder axis')
  valid = got[0].dist.numpy() < 1e9
  assert valid[1::4].all() and (got[0].dist.numpy()[1::4] < 0).any()


@pytest.fixture(scope='module')
def all_pairs():
  mjm = mujoco.MjModel.from_xml_string(export.ALL_PAIRS_XML)
  from mujoco_mpc_tpu.physics.model import put_model
  jm = put_model(mjm, dtype=jnp.float64)
  m = model_lib.from_arrays(*export.model_snapshot(jm), device='cpu',
                            dtype=torch.float64)
  return jm, m


def test_narrowphase_matches_jax(all_pairs):
  """Every pair of ALL_PAIRS_XML at 64 random poses: each point's dist,
  pos and normal (atol 1e-10), points_per_pair points a pair, and
  contact_table takes them all."""
  jm, m = all_pairs
  g = golden_file()
  d = model_lib.make_data(m, export.ALL_PAIRS_POSES).replace(
      geom_xpos=_t(g['pairs/xpos']), geom_xmat=_t(g['pairs/xmat']))
  kinds = set()
  for g1, g2 in jm.collision_pairs:
    got = collision.narrowphase(m, d, g1, g2)
    want = [[g[f'pairs/{g1}_{g2}/{k}'][:, i] for k in ('dist', 'pos',
                                                         'normal')]
            for i in range(g[f'pairs/{g1}_{g2}/dist'].shape[1])]
    assert len(got) == collision.points_per_pair(m, g1, g2)
    _same(got, want, f'pair {g1}-{g2}')
    kinds.add((model_lib.GeomType(m.geom_type[g1]).name,
               model_lib.GeomType(m.geom_type[g2]).name))
  for pair in (('SPHERE', 'ELLIPSOID'), ('CAPSULE', 'CYLINDER'),
               ('ELLIPSOID', 'BOX'), ('CYLINDER', 'CYLINDER'),
               ('CYLINDER', 'MESH'), ('PLANE', 'ELLIPSOID')):
    assert pair in kinds, pair
  assert sum(len(grp.margin) for grp in m.contact) == sum(
      collision.points_per_pair(m, *p) for p in m.collision_pairs)


# ---------------------------------------------------------------------------
# The scenes
# ---------------------------------------------------------------------------

# scene: (the JAX test's steps, tolerance on qpos[2] against MuJoCo, the
# steps run here, a bound the JAX test also asserts: (lo, hi) on qpos[2])
SCENES = {
    'plane_ellipsoid': (800, 3e-3, 120, (0.055, None)),
    'sphere_cylinder': (300, 5e-3, 80, None),
    'sphere_cylinder_disc': (600, 5e-3, 100, None),
    'capsule_box_edge': (500, 1e-2, 80, (0.25, None)),
    'capsule_flat_box': (400, 3e-3, 80, None),
    'cylinder_box': (500, 5e-3, 80, None),
    'cylinder_stack': (600, 2e-2, 80, (0.3, None)),
    'sphere_ellipsoid': (250, 2e-2, 60, (0.45, None)),
    'plane_cylinder': (100, 6e-3, 100, None),
}


def _check_scene(name, steps):
  full, atol, _, bound = SCENES[name]
  mjd, d = roll_with_mujoco(name, steps)
  q = d.qpos[0].numpy()
  assert np.isfinite(q).all()
  if name == 'plane_cylinder':      # test_contacts.py: all of qpos
    np.testing.assert_allclose(q, mjd.qpos, atol=atol)
  elif name == 'sphere_cylinder':   # its x, y and z
    np.testing.assert_allclose(q[:3], mjd.qpos[:3], atol=atol)
  else:
    np.testing.assert_allclose(q[2], mjd.qpos[2], atol=atol)
  if bound is not None:
    assert q[2] > bound[0] and mjd.qpos[2] > bound[0], (q[2], mjd.qpos[2])
  if steps == full:                 # the resting heights the JAX test names
    rest = {'plane_ellipsoid': None, 'sphere_cylinder_disc': 0.48,
            'capsule_flat_box': 0.24, 'cylinder_box': 0.3}.get(name)
    if rest is not None:
      assert abs(q[2] - rest) < (8e-3 if name == 'cylinder_box' else atol)


@pytest.mark.parametrize('name', sorted(SCENES))
def test_scene_matches_mujoco(name):
  """The scene from its test's state over SCENES' third entry of steps
  against mj_step, at the JAX test's tolerance and bound."""
  _check_scene(name, SCENES[name][2])


@pytest.mark.slow
@pytest.mark.parametrize('name', sorted(SCENES))
def test_scene_settles_as_in_mujoco_full(name):
  """The JAX test's own step count, tolerance and resting height."""
  _check_scene(name, SCENES[name][0])


def test_sphere_cylinder_qacc_matches_mujoco_and_jax():
  """The ball resting on the lying cylinder: qacc against mj_forward
  (rtol and atol 1e-4, the JAX test's) and JAX's forward (1e-8)."""
  name = 'sphere_cylinder'
  mjm = mujoco.MjModel.from_xml_string(xmls()[name])
  mjd = mujoco.MjData(mjm)
  mujoco.mj_forward(mjm, mjd)
  d = check_golden_forward(name, ('qacc', 'qfrc_constraint'))
  np.testing.assert_allclose(d.qacc[0].numpy(), mjd.qacc, rtol=1e-4,
                             atol=1e-4)


@pytest.mark.parametrize('name', names('convex'))
def test_trajectory_matches_jax(name):
  check_golden_trajectory(name)


def test_physics_models_are_current():
  """assets/physics_models.npz matches a fresh export."""
  fresh = export.physics_model_arrays()
  hint = ': stale; run python tools/export_torch_snapshot.py --physics-models'
  z = models_file()
  assert sorted(z) == sorted(fresh), hint
  for k, v in fresh.items():
    np.testing.assert_array_equal(z[k], v, err_msg=k + hint)


@pytest.mark.slow
def test_golden_is_jaxs():
  """assets/physics_features_golden.npz recomputed from JAX live (rtol
  1e-10, atol 1e-12)."""
  fresh = export.physics_golden_arrays()
  g = golden_file()
  assert sorted(g) == sorted(fresh)
  for k, v in fresh.items():
    if k == 'provenance':
      continue
    np.testing.assert_allclose(g[k], v, rtol=1e-10, atol=1e-12, err_msg=k)
