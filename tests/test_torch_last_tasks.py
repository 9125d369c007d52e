"""The last four tasks of the port against the JAX package and MuJoCo,
float64 on the CPU: Acrobot (nv 2, no contacts), Quadrotor (nv 6, four
rotors on site transmissions, a moving mocap goal), OP3 Stand (nv 18, the
humanoid residual on op3.xml, plane pairs) and Quadruped Hill (nv 18, the
quadruped over a height field beside the floor plane), and the physics
they bring: site transmissions, height-field contacts, the ground height
over a height field, and the sphere-capsule pair.

No JAX step is compiled here: each task's step, transition, Quadrotor's
transmission and derivatives and a plan are held to
assets/last_tasks_golden.npz, written once from the JAX package in
float64 by `python tools/export_torch_snapshot.py --last-tasks-golden`
(its inputs, JAX version and command are in the file);
test_golden_is_jaxs recomputes it live (slow). Tolerances are those of
tests/test_torch_manipulation.py:

* _hfield_point and _hfield_collide against JAX's under one jitted vmap
  each (replayed from assets/last_tasks_jax_calls_golden.npz,
  tests/torch_recorded.py RecordedJax: record anew with
  MJPC_TORCH_RECORD=1 in one process; the slow
  test_jax_calls_golden_is_jaxs makes them live), 256 configurations
  each for a sphere, a capsule, a box, a
  cylinder and an ellipsoid from a
  numpy seed over Quadruped Hill's terrain (atol 1e-10; positions beyond
  the extent, ~5e9 m out, to 1e-14 relative): points on cell
  edges, on grid vertices and on a cell's diagonal (dyadic, where the two
  triangles meet), on the flattened centre (a flat box's corners tie),
  beyond the extent (depth 1e10) and inside its one-cell margin, and a
  tilted, moved field; the sphere-capsule pair against JAX's
  narrowphase, 256 configurations.
* the four scenes of tests/test_hfield.py at that file's tolerances: a
  sphere at rest on a flat field and a ball rolling down a slope against
  mj_step, a capsule resting on a field, ground_height on a slope.
* Quadruped Hill's ground_height (flat at `home`, raised on the hills,
  against JAX's), and Hill standing 100 steps from `home`
  (tests/test_locomotion_tasks.py's bounds).
* both site-transmission branches against mj_forward (the refsite finger
  of tests/test_actuators.py, and Quadrotor's rotors: atol 1e-12), and
  Quadrotor's actuator length, moment and qfrc_actuator against the
  golden (1e-10); Quadrotor's exact derivatives (torch.func.jacfwd
  through the step, the site transmission's per-sample moment inside)
  against JAX's derivatives.compute (rtol 1e-8).
* per task against the golden: the condim-3 points (atol 1e-10), qacc
  and qfrc_constraint (rtol 1e-7, atol 1e-6), the residual (1e-10), the
  next qvel (1e-7) and qpos (1e-8) at four states; Quadrotor's goal path
  and Hill's mode switches (Quadruped, Walk, Flip on the hills with its
  ground snapshot); a 16-candidate x 6-step plan's returns (rtol 1e-8)
  and winner.
* points_per_pair, pair_params and contact_table against JAX's order;
  the snapshots current; the registry holds JAX's 23 names, and the four
  tasks raise without a card and plan with nothing of JAX or mujoco
  importable, reaching B1's dispatch (and B2's where rows exist).
"""

import os

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu.physics import collision as jcollision
from mujoco_mpc_tpu.physics import forward as jfwd
from mujoco_mpc_tpu.physics import kinematics as jkin
from mujoco_mpc_tpu.physics import support as jsupport
from mujoco_mpc_tpu.physics.model import make_data as jmake_data
from mujoco_mpc_tpu.physics.model import put_model
from mujoco_mpc_tpu.tasks import registry as jregistry
from mujoco_mpc_tpu_torch.physics import collision
from mujoco_mpc_tpu_torch.physics import constraint
from mujoco_mpc_tpu_torch.physics import forward as fwd
from mujoco_mpc_tpu_torch.physics import kinematics as kin
from mujoco_mpc_tpu_torch.physics import model as model_lib
from mujoco_mpc_tpu_torch.physics import support
from mujoco_mpc_tpu_torch.physics.model import make_data
from mujoco_mpc_tpu_torch.planners import derivatives
from mujoco_mpc_tpu_torch.tasks import registry
import tests.test_actuators as jactuators
import tests.test_hfield as jhfield
from tests.test_torch_box_pairs import _rotations, _signed_perms
from tests.test_torch_package import BLOCK, _check_snapshot, _run
from tests.torch_recorded import RecordedJax
from tools import export_torch_snapshot as export

torch.set_num_threads(1)

TASKS = export.LAST_TASKS
N = 256
JAX_CALLS = 'last_tasks_jax_calls_golden.npz'
# the shank's half sizes where a test makes it a cylinder or an ellipsoid
RETYPED_SIZE = (2.0 ** -4, 2.0 ** -3, 2.0 ** -5)
HILL = 'Quadruped Hill'
# Hill's geoms the collider tests place: the terrain, a shank capsule, a
# foot sphere and the trunk box, with dyadic sizes so that axis-aligned
# ends and corners land on the grid's lines (cells 0.25 m)
TERRAIN, CAPSULE, SPHERE, BOX = 1, 6, 7, 3
SIZES = {CAPSULE: (2.0 ** -5, 2.0 ** -3, 0.0), SPHERE: (2.0 ** -5, 0.0, 0.0),
         BOX: (2.0 ** -3, 2.0 ** -2, 2.0 ** -4)}


def _f64(x):
  return torch.from_numpy(np.asarray(x, np.float64))


def _close(got, want, what, atol=1e-10, rtol=0.0):
  np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                             atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# Height-field colliders
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def hill_models():
  """(JAX model, port model) of Quadruped Hill in float64, the placed
  geoms at SIZES."""
  jm = export._f64(jregistry.get_task(HILL).model)
  m = registry.get_task(HILL, device='cpu', dtype=torch.float64).model
  size = np.array(jm.geom_size)
  for g, s in SIZES.items():
    size[g] = s
  return (jm.replace(geom_size=jnp.asarray(size)),
          m.replace(geom_size=_f64(size)))


def _terrain(m):
  grid, size = m.geom_hfield[TERRAIN]
  return grid.numpy(), size.numpy()


def _hfield_cases(m, rng, n=N):
  """(field pos (n, 3), field frame (n, 3, 3), geom centre (n, 3), geom
  frame (n, 3, 3)) by index mod 8: 0 random over the terrain near its
  surface; 1 the centre on a cell's edge (x on the grid's lines), 2 on a
  grid vertex, 3 on a cell's diagonal (u = v); 4 on the flattened centre
  (a flat box's corners tie); 5 beyond the extent; 6 inside its one-cell
  margin; 7 a tilted, moved field. 1-6 put the field at the origin
  unrotated, with dyadic centres and signed-permutation geom frames."""
  grid, size = _terrain(m)
  kind = np.arange(n) % 8
  cell = 2.0 * size[0] / (grid.shape[1] - 1)              # 0.25
  p1 = np.zeros((n, 3))
  m1 = np.broadcast_to(np.eye(3), (n, 3, 3)).copy()
  m2 = _rotations(rng, n)
  xy = rng.uniform(-3.9, 3.9, (n, 2))
  on = rng.integers(1, 31, (n, 2)) * cell - size[0]
  frac = rng.integers(1, 8, (n, 1)) * 2.0 ** -3 * cell
  dyadic = rng.integers(-32, 32, (n, 2)) * 2.0 ** -7
  xy[kind == 1] = np.stack([on[:, 0], on[:, 1] + dyadic[:, 1]], -1)[kind == 1]
  xy[kind == 2] = on[kind == 2]
  xy[kind == 3] = (on + frac)[kind == 3]
  xy[kind == 4] = (dyadic * 0.25)[kind == 4]
  sign = rng.choice([-1.0, 1.0], (n, 2))
  xy[kind == 5] = (sign * rng.uniform(4.3, 6.0, (n, 2)))[kind == 5]
  margin = np.stack([sign[:, 0] * rng.uniform(4.0, 4.24, n), xy[:, 1]], -1)
  xy[kind == 6] = margin[kind == 6]
  z = np.array([export.terrain_z(grid, size, *np.clip(p, -4, 4)) for p in xy])
  z += rng.uniform(-0.05, 0.05, n)
  exact = np.isin(kind, (1, 2, 3, 4, 5, 6))
  z[exact] = (rng.integers(-4, 12, n) * 2.0 ** -5)[exact]
  m2[exact] = _signed_perms(int(exact.sum()))
  flat = kind == 4
  m2[flat] = np.eye(3)
  c = np.concatenate([xy, z[:, None]], -1)
  tilt = kind == 7
  m1[tilt] = _rotations(rng, int(tilt.sum())) @ np.array(
      [[1.0, 0.0, 0.0], [0.0, np.cos(0.2), -np.sin(0.2)],
       [0.0, np.sin(0.2), np.cos(0.2)]])
  p1[tilt] = rng.normal(scale=0.3, size=(int(tilt.sum()), 3))
  c[tilt] = (p1 + np.einsum('nij,nj->ni', m1, c))[tilt]
  return p1, m1, c, m2


def _poses(m, n, p1, m1, g2, c, m2):
  """Every geom's world pose (n, ngeom, 3), (n, ngeom, 3, 3): the field's
  and geom g2's as given, the others at the origin."""
  xpos = np.zeros((n, m.ngeom, 3))
  xmat = np.broadcast_to(np.eye(3), (n, m.ngeom, 3, 3)).copy()
  xpos[:, TERRAIN], xmat[:, TERRAIN] = p1, m1
  xpos[:, g2], xmat[:, g2] = c, m2
  return xpos, xmat


# the JAX models of the recorded calls, by key, set by each test before
# its call (the live functions read them)
_JAX_MODELS = {}


class _LiveCalls(dict):
  """The JAX functions JAX_CALLS replays, by name: 'collide/<model
  key>/<g1>/<g2>' (narrowphase on the pair at the two geoms' poses, the
  others at the origin, vmapped) and 'point/<model key>' (_hfield_point
  on the terrain), jitted once each."""

  def __missing__(self, name):
    kind, key, *geoms = name.split('/')
    jm = _JAX_MODELS[key]
    jd = jmake_data(jm, dtype=jnp.float64)

    def at(p, r, gs):
      xpos = jnp.zeros((jm.ngeom, 3), p.dtype).at[jnp.asarray(gs)].set(p)
      xmat = jnp.broadcast_to(jnp.eye(3, dtype=r.dtype), (jm.ngeom, 3, 3))
      return jd.replace(geom_xpos=xpos,
                        geom_xmat=xmat.at[jnp.asarray(gs)].set(r))
    if kind == 'collide':
      g1, g2 = map(int, geoms)
      fn = jax.jit(jax.vmap(lambda p, r: [tuple(cp[:3]) for cp in
                                          jcollision.narrowphase(
                                              jm, at(p, r, (g1, g2)),
                                              g1, g2)]))
    else:
      fn = jax.jit(jax.vmap(lambda p, mat, cc, rr: tuple(
          jcollision._hfield_point(jm, at(p[None], mat[None], (TERRAIN,)),
                                   TERRAIN, cc, rr)[:3])))
    self[name] = fn
    return fn


_REC = RecordedJax(os.path.join(registry.ASSETS, JAX_CALLS), _LiveCalls)


@pytest.fixture(scope='module', autouse=True)
def _record():
  yield
  if _REC.recording:
    _REC.save()


@pytest.mark.slow
def test_jax_calls_golden_is_jaxs(hill_models):
  """The recorded JAX calls are what the JAX package computes now."""
  jm, m = hill_models
  _JAX_MODELS['hill'] = jm
  for geom in ('cylinder', 'ellipsoid'):
    _JAX_MODELS[geom] = _retyped(jm, m, CAPSULE, getattr(
        model_lib.GeomType, geom.upper()), RETYPED_SIZE)[0]
  _REC.check_live()


def _jax_collide(key, jm, g1, g2, xpos, xmat):
  """JAX's narrowphase on the pair (g1, g2) of model jm (its key in
  _JAX_MODELS) at the two geoms' poses (the rest at the origin, as
  _poses places them), replayed."""
  _JAX_MODELS[key] = jm
  out = _REC(f'collide/{key}/{g1}/{g2}', jnp.asarray(xpos[:, [g1, g2]]),
             jnp.asarray(xmat[:, [g1, g2]]))
  return [[np.asarray(x) for x in p] for p in out]


def _same(got, want, what):
  """Every point's dist, pos and normal within atol 1e-10; a point beyond
  the extent lies ~5e9 m out (pos = c - n (r + dist / 2), dist 1e10), so
  positions are also let differ by 1e-14 relative (a few ulps there)."""
  assert len(got) == len(want), what
  for k, (g, w) in enumerate(zip(got, want)):
    for name, a, b in zip(('dist', 'pos', 'normal'), g[:3], w):
      _close(a.numpy(), b, f'{what} point {k} {name}',
             rtol=1e-14 if name == 'pos' else 0.0)


def _retyped(jm, m, g, gtype, size):
  """Both models with geom g made `gtype` of half sizes `size`."""
  types = m.geom_type[:g] + (int(gtype),) + m.geom_type[g + 1:]
  jsize = np.array(jm.geom_size)
  jsize[g] = size
  return (jm.replace(geom_type=types, geom_size=jnp.asarray(jsize)),
          m.replace(geom_type=types, geom_size=_f64(jsize)))


@pytest.mark.parametrize('geom', ['sphere', 'capsule', 'box', 'cylinder',
                                  'ellipsoid'])
def test_hfield_collide_matches_jax(hill_models, geom):
  """narrowphase's height-field branch (_hfield_collide) on the terrain
  against a foot sphere, a shank capsule and the trunk box, and the shank
  made a cylinder (its end-disc centres as spheres) and an ellipsoid (its
  centre, the least semi-axis), 256 configurations each (atol 1e-10): 1,
  2, 4, 2 and 1 points, beyond the extent at depth 1e10 with finite
  positions, the box's four deepest corners in JAX's stable order."""
  jm, m = hill_models
  if geom in ('cylinder', 'ellipsoid'):
    jm, m = _retyped(jm, m, CAPSULE, getattr(model_lib.GeomType,
                                             geom.upper()), RETYPED_SIZE)
  g2 = {'sphere': SPHERE, 'box': BOX}.get(geom, CAPSULE)
  rng = np.random.default_rng({'sphere': 61, 'capsule': 62, 'box': 63,
                               'cylinder': 67, 'ellipsoid': 68}[geom])
  p1, m1, c, m2 = _hfield_cases(m, rng)
  xpos, xmat = _poses(m, N, p1, m1, g2, c, m2)
  d = make_data(m, N).replace(geom_xpos=_f64(xpos), geom_xmat=_f64(xmat))
  got = collision.narrowphase(m, d, TERRAIN, g2)
  assert len(got) == collision.points_per_pair(m, TERRAIN, g2) == {
      'sphere': 1, 'capsule': 2, 'box': 4, 'cylinder': 2,
      'ellipsoid': 1}[geom]
  key = geom if geom in ('cylinder', 'ellipsoid') else 'hill'
  _same(got, _jax_collide(key, jm, TERRAIN, g2, xpos, xmat),
        f'hfield-{geom}')
  kind = np.arange(N) % 8
  dist = np.stack([p.dist.numpy() for p in got], -1)
  assert (dist[kind == 5] == 1e10).all()
  assert (dist[kind < 5] < 1e9).all()
  assert all(torch.isfinite(p.pos).all() for p in got)
  assert (dist[kind == 0] < 0).any() and (dist[kind == 0] > 0).any()
  if geom == 'box':
    # the flat box: its four bottom corners at one depth, in index order
    flat = dist[kind == 4]
    assert (flat == flat[:, :1]).all()


def test_hfield_point_matches_jax(hill_models):
  """_hfield_point of spheres of random radii (and points, r 0) at the
  cases of _hfield_cases against JAX's (atol 1e-10)."""
  jm, m = hill_models
  rng = np.random.default_rng(64)
  p1, m1, c, _ = _hfield_cases(m, rng)
  r = rng.uniform(0.0, 0.1, N)
  r[::3] = 0.0
  _JAX_MODELS['hill'] = jm
  want = _REC('point/hill', *(jnp.asarray(x) for x in (p1, m1, c, r)))
  got = collision._hfield_point(*m.geom_hfield[TERRAIN], _f64(p1),
                                _f64(m1), _f64(c), _f64(r))
  _same([got], [[np.asarray(x) for x in want]], 'hfield point')


def test_sphere_capsule_matches_jax(hill_models):
  """narrowphase's sphere-capsule branch (the segment point closest to
  the centre, then _sphere_sphere; 1 point) on a foot sphere against a
  shank capsule, 256 configurations (atol 1e-10), by index mod 4: random;
  the centre inside the capsule; on its axis (a zero normal: the axis
  along a coordinate axis, dyadic centres, so that the offset is exactly
  zero; off the grid the normal is the direction of the offset's last
  ulps); beyond an end."""
  jm, m = hill_models
  rng = np.random.default_rng(65)
  kind = np.arange(N) % 4
  m2 = _rotations(rng, N)
  c2 = rng.normal(scale=0.1, size=(N, 3))
  axis = m2[:, :, 2]
  half = SIZES[CAPSULE][1]
  t = rng.uniform(-half, half, (N, 1))
  side = np.cross(axis, rng.normal(size=(N, 3)))
  side /= np.linalg.norm(side, axis=1, keepdims=True)
  c1 = c2 + rng.normal(scale=0.1, size=(N, 3))
  c1[kind == 1] = (c2 + t * axis + 0.01 * side)[kind == 1]
  on = kind == 2
  m2[on] = _signed_perms(int(on.sum()))
  c2[on] = rng.integers(-16, 16, (int(on.sum()), 3)) * 2.0 ** -6
  axis = m2[:, :, 2]
  t[on] = rng.integers(-4, 5, (int(on.sum()), 1)) * 2.0 ** -5
  c1[on] = (c2 + t * axis)[on]
  c1[kind == 3] = (c2 + (half + 0.03) * axis + 0.02 * side)[kind == 3]
  xpos = np.zeros((N, m.ngeom, 3))
  xmat = np.broadcast_to(np.eye(3), (N, m.ngeom, 3, 3)).copy()
  xpos[:, SPHERE], xpos[:, CAPSULE], xmat[:, CAPSULE] = c1, c2, m2
  d = make_data(m, N).replace(geom_xpos=_f64(xpos), geom_xmat=_f64(xmat))
  got = collision.narrowphase(m, d, SPHERE, CAPSULE)
  assert collision.points_per_pair(m, SPHERE, CAPSULE) == 1
  _same(got, _jax_collide('hill', jm, SPHERE, CAPSULE, xpos, xmat),
        'sphere-capsule')
  assert (got[0].dist.numpy()[kind == 1] < 0).all()
  assert (got[0].normal.numpy()[on] == 0).all()


def test_hfield_mesh_is_refused(hill_models):
  """A height field against a mesh (JAX emits no point there) raises
  naming its ROADMAP item, in narrowphase and in the point count."""
  _, m = hill_models
  m = m.replace(geom_type=m.geom_type[:BOX] + (int(model_lib.GeomType.MESH),)
                + m.geom_type[BOX + 1:])
  d = kin.kinematics(m, make_data(m, 2))
  for call in (lambda: collision.narrowphase(m, d, TERRAIN, BOX),
               lambda: collision.points_per_pair(m, TERRAIN, BOX)):
    with pytest.raises(NotImplementedError, match='hfield-mesh.*ROADMAP A7'):
      call()


# ---------------------------------------------------------------------------
# The scenes of tests/test_hfield.py against MuJoCo
# ---------------------------------------------------------------------------


def _scene(body, grid):
  """(MjModel, the port's float64 model) of test_hfield.py's 9 x 9 field
  with `body` over it, the elevations `grid`."""
  mjm, jm = jhfield._models(jhfield._hfield_xml(body=body), grid)
  return mjm, model_lib.from_arrays(*export.model_snapshot(jm),
                                    device='cpu', dtype=torch.float64)


def _roll(mjm, m, steps):
  """`steps` steps of the port's model m and, where given, of MuJoCo's
  mjm: (MjData or None, Data)."""
  mjd = None if mjm is None else mujoco.MjData(mjm)
  d = make_data(m)
  for _ in range(steps):
    if mjm is not None:
      mujoco.mj_step(mjm, mjd)
    d = fwd.step(m, d)
  return mjd, d


def test_sphere_rests_on_flat_hfield():
  """600 steps: the ball's centre at 0.3 (the surface at 0.2) within 5e-3,
  and at MuJoCo's height within 5e-3."""
  body = ('<body name="ball" pos="0.3 0.2 0.6"><freejoint/>'
          '<geom type="sphere" size="0.1" mass="0.3"/></body>')
  mjm, m = _scene(body, 0.4 * np.ones((9, 9)))
  mjd, d = _roll(mjm, m, 600)
  z = float(d.qpos[0, 2])
  assert abs(z - 0.3) < 5e-3, z
  np.testing.assert_allclose(z, mjd.qpos[2], atol=5e-3)


def test_ball_rolls_down_sloped_hfield():
  """500 steps on a slope rising along +x: downhill past -0.15 in both
  engines, within 0.15 of MuJoCo."""
  body = ('<body name="ball" pos="0 0 0.8"><freejoint/>'
          '<geom type="sphere" size="0.1" mass="0.3" friction="0.8"/>'
          '</body>')
  mjm, m = _scene(body, np.tile(np.linspace(0.0, 1.0, 9)[None, :], (9, 1)))
  mjd, d = _roll(mjm, m, 500)
  x = float(d.qpos[0, 0])
  assert x < -0.15 and mjd.qpos[0] < -0.15, (x, mjd.qpos[0])
  np.testing.assert_allclose(x, mjd.qpos[0], atol=0.15)


def test_capsule_contacts_hfield():
  """A lying capsule settles on its radius on a flat field (5e-3)."""
  body = ('<body name="cap" pos="0 0 0.5"><freejoint/>'
          '<geom type="capsule" size="0.05 0.2" mass="0.2" euler="0 90 0"/>'
          '</body>')
  _, m = _scene(body, np.zeros((9, 9)))
  _, d = _roll(None, m, 500)
  assert abs(float(d.qpos[0, 2]) - 0.05) < 5e-3, float(d.qpos[0, 2])


def test_ground_height_raycast_on_hfield():
  """ground_height on the slope: 0.25 at the centre (1e-6), near 0.5 at
  the top edge (0.07), and JAX's at both (1e-12)."""
  mjm, jm = jhfield._models(jhfield._hfield_xml(),
                            np.tile(np.linspace(0.0, 1.0, 9)[None, :],
                                    (9, 1)))
  m = model_lib.from_arrays(*export.model_snapshot(jm), device='cpu',
                            dtype=torch.float64)
  d = fwd.forward(m, make_data(m))
  jd = jfwd.forward(jm, jmake_data(jm, dtype=jnp.float64))
  pts = np.array([[0.0, 0.0, 1.0], [1.99, 0.0, 1.0]])
  h = support.ground_height(m, d, _f64(pts)[None])[0].numpy()
  want = [float(jsupport.ground_height(jm, jd, jnp.asarray(p))) for p in pts]
  assert abs(h[0] - 0.25) < 1e-6 and abs(h[1] - 0.5) < 0.07, h
  _close(h, want, 'ground height', atol=1e-12)


# ---------------------------------------------------------------------------
# Quadruped Hill: ground height and standing
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def specs():
  """name -> the port's spec on the CPU in float64."""
  return {n: registry.get_task(n, device='cpu', dtype=torch.float64)
          for n in TASKS}


def test_hill_ground_height_and_standing(specs):
  """Flat (|h| < 1e-6) at the home stance, raised (> 0.05) out on the
  hills, equal to JAX's ground_height at every probe (1e-12); standing
  100 steps from `home`, the trunk stays between 0.2 and 0.6 m
  (tests/test_locomotion_tasks.py)."""
  spec = specs[HILL]
  m = spec.model
  jm = export._f64(jregistry.get_task(HILL).model)
  home = m.keyframe_qpos('home')[None]
  d = fwd.forward(m, make_data(m).replace(qpos=home))
  probes = np.array([[0.0, 0.0, 0.5]] + [[x, y, 0.5]
                                          for x in (-2.5, -1.5, 1.5, 2.5)
                                          for y in (-2.0, 0.0, 2.0)])
  h = support.ground_height(m, d, _f64(probes)[None])[0].numpy()
  jd = jax.jit(lambda q: jkin.kinematics(jm, jmake_data(
      jm, dtype=jnp.float64).replace(qpos=q)))(jnp.asarray(home[0].numpy()))
  want = [float(jsupport.ground_height(jm, jd, jnp.asarray(p)))
          for p in probes]
  assert abs(h[0]) < 1e-6
  assert h[1:].max() > 0.05, h
  _close(h, want, 'ground height', atol=1e-12)
  for _ in range(100):
    d = fwd.step(m, d)
  assert 0.2 < float(d.qpos[0, 2]) < 0.6, float(d.qpos[0, 2])


# ---------------------------------------------------------------------------
# Site transmissions
# ---------------------------------------------------------------------------


def _mj_moment(mjm, mjd):
  mom = np.zeros((mjm.nu, mjm.nv))
  mujoco.mju_sparse2dense(mom, mjd.actuator_moment, mjd.moment_rownnz,
                          mjd.moment_rowadr, mjd.moment_colind)
  return mom


def test_refsite_transmission_matches_mujoco():
  """The refsite finger of tests/test_actuators.py (intvelocity over the
  tip's pose in a hinged reference frame): actuator_length,
  actuator_moment and qfrc_actuator equal mj_forward's (atol 1e-12)."""
  mjm, mjd, jm, _ = jactuators._setup([0.5, -0.3, 0.8, 0.4],
                                      qpos=[0.4, 0.02, -0.05, 0.1, 0.7])
  arrays, static = export.model_snapshot(jm)
  assert static['actuator_refid'] == [0, 0, 0, 0]
  m = model_lib.from_arrays(arrays, static, device='cpu',
                            dtype=torch.float64)
  d = fwd.forward(m, make_data(m).replace(qpos=_f64(mjd.qpos)[None],
                                          ctrl=_f64(mjd.ctrl)[None]))
  _close(d.actuator_length[0], mjd.actuator_length, 'length', atol=1e-12)
  _close(d.actuator_moment[0], _mj_moment(mjm, mjd), 'moment', atol=1e-12)
  _close(d.qfrc_actuator[0], mjd.qfrc_actuator, 'qfrc', atol=1e-12)


def test_quadrotor_rotors_match_mujoco():
  """Quadrotor's four rotors (site transmissions without a reference
  site: the gear's wrench in the rotor site's frame) on a float64 model
  of quadrotor.xml at 8 random states: zero lengths, actuator_moment and
  qfrc_actuator equal mj_forward's (atol 1e-12)."""
  mjm = jregistry.get_task('Quadrotor').mj_model
  jm = put_model(mjm, dtype=jnp.float64)
  m = model_lib.from_arrays(*export.model_snapshot(jm), device='cpu',
                            dtype=torch.float64)
  assert set(m.actuator_trntype) == {int(model_lib.TrnType.SITE)}
  assert set(m.actuator_refid) == {-1}
  mjd = mujoco.MjData(mjm)
  rng = np.random.default_rng(66)
  for _ in range(8):
    q = mjm.qpos0.copy()
    q[:3] += rng.normal(size=3)
    q[3:7] = rng.normal(size=4)
    q[3:7] /= np.linalg.norm(q[3:7])
    mjd.qpos[:], mjd.qvel[:] = q, rng.normal(size=mjm.nv)
    mjd.ctrl[:] = rng.uniform(0.0, 5.0, mjm.nu)
    mujoco.mj_forward(mjm, mjd)
    d = fwd.forward(m, make_data(m).replace(
        qpos=_f64(q)[None], qvel=_f64(mjd.qvel)[None],
        ctrl=_f64(mjd.ctrl)[None]))
    assert (d.actuator_length == 0).all()
    _close(d.actuator_moment[0], _mj_moment(mjm, mjd), 'moment', atol=1e-12)
    _close(d.qfrc_actuator[0], mjd.qfrc_actuator, 'qfrc', atol=1e-12)


@pytest.fixture(scope='module')
def golden():
  path = os.path.join(registry.ASSETS, export.LAST_TASKS_GOLDEN)
  with np.load(path) as z:
    return {k: z[k] for k in z.files}


def _data(m, g):
  """The golden's four states as port Data, with their goals."""
  return make_data(m, 4).replace(
      qpos=_f64(g['qpos']), qvel=_f64(g['qvel']), ctrl=_f64(g['ctrl']),
      mocap_pos=_f64(g['mocap_pos']))


def test_quadrotor_transmission_matches_the_golden(specs, golden):
  """At the golden's four states (turned and moved rotors): the per-
  sample moment (B, nu, nv), zero lengths and qfrc_actuator equal JAX's
  (1e-10)."""
  spec = specs['Quadrotor']
  g = export.task_inputs(golden, 'Quadrotor')
  d = fwd.forward(spec.model, _data(spec.model, g))
  assert d.actuator_moment.shape == (4, 4, 6)
  for k in ('actuator_length', 'actuator_moment', 'qfrc_actuator'):
    _close(getattr(d, k), g[k], k)
  assert np.abs(g['actuator_moment'][1] - g['actuator_moment'][2]).max() > 0.1


def test_quadrotor_derivatives_match_jax(specs, golden):
  """derivatives.compute over a 4-step nominal from the golden's state 1:
  A and B by jacfwd through the step, the site transmission's moment per
  sample inside, and the cost derivatives, against JAX's recorded
  derivatives.compute (rtol 1e-8)."""
  spec = specs['Quadrotor']
  g = export.task_inputs(golden, 'Quadrotor')
  m = spec.model
  d0 = make_data(m).replace(qpos=_f64(g['qpos'][1:2]),
                            qvel=_f64(g['qvel'][1:2]))
  traj = derivatives.nominal_trajectory(
      spec, d0, _f64(g['derivatives/actions']), spec.default_params)
  got = derivatives.compute(spec, d0, traj, spec.default_params)
  for k in ('a', 'b', 'cx', 'cu', 'cxx', 'cxu', 'cuu'):
    want = g['derivatives/' + k]
    np.testing.assert_allclose(getattr(got, k).numpy(), want, rtol=1e-8,
                               atol=1e-8 * max(1.0, np.abs(want).max()),
                               err_msg=k)
  # the rotors' moment turns with the body: B is not constant in q
  assert np.abs(g['derivatives/b'][0] - g['derivatives/b'][-1]).max() > 0


# ---------------------------------------------------------------------------
# The four tasks: registry, tables, golden
# ---------------------------------------------------------------------------


def test_registry_holds_every_jax_task():
  assert set(registry.task_names()) == set(jregistry.task_names())
  assert len(registry.task_names()) == 23


@pytest.mark.parametrize('name', TASKS)
def test_snapshots_are_current(name):
  _check_snapshot(name)


@pytest.mark.parametrize('name', TASKS)
def test_get_task_needs_a_card(name):
  """Each of the four raises without CUDA by default and builds on the
  CPU when asked."""
  with pytest.raises(RuntimeError, match='no CUDA device'):
    registry.get_task(name)
  assert registry.get_task(name, device='cpu').model.device.type == 'cpu'


@pytest.mark.parametrize('name', ['OP3 Stand', HILL])
def test_contact_table_matches_jax(specs, name):
  """Each pair's point count is the length of JAX's narrowphase output
  (traced abstractly: plane-box 8, plane-capsule 2, plane-sphere 1,
  hfield-box 4, hfield-capsule 2, hfield-sphere 1), its parameters are
  JAX's pair_params, and the condim-3 group's per-point parameters and
  bodies are those repeated over its points in the order of
  collision_pairs (P 29 for OP3, 36 for Hill)."""
  m = specs[name].model
  jm = export._f64(jregistry.get_task(name).model)
  jd = jmake_data(jm, dtype=jnp.float64)
  want = {k: [] for k in ('margin', 'solref', 'solimp', 'mu', 'invw',
                          'b1', 'b2')}
  counts = {(0, 6): 8, (0, 3): 2, (0, 2): 1, (1, 6): 4, (1, 3): 2,
            (1, 2): 1}
  for pair in m.collision_pairs:
    n = collision.points_per_pair(m, *pair)
    assert n == len(jax.eval_shape(
        lambda x, pair=pair: jcollision.narrowphase(jm, x, *pair), jd))
    assert n == counts[(int(m.geom_type[pair[0]]), int(m.geom_type[pair[1]]))]
    got, jp = collision.pair_params(m, *pair), jcollision.pair_params(
        jm, *pair)
    assert got.condim == jp.condim == 3
    for k in ('friction', 'solref', 'solimp', 'includemargin', 'invweight'):
      _close(getattr(got, k).numpy(), np.asarray(getattr(jp, k)), k,
             atol=0, rtol=1e-12)
    for k, v in (('margin', jp.includemargin), ('solref', jp.solref),
                 ('solimp', jp.solimp), ('mu', jp.friction),
                 ('invw', jp.invweight), ('b1', jm.geom_bodyid[pair[0]]),
                 ('b2', jm.geom_bodyid[pair[1]])):
      want[k] += [np.asarray(v)] * n
  (table,) = m.contact
  assert table.condim == 3
  assert table.margin.shape == ({'OP3 Stand': 29, HILL: 36}[name],)
  for k in ('margin', 'solref', 'solimp', 'mu', 'invw'):
    _close(getattr(table, k).numpy(), np.stack(want[k]), k, atol=0,
           rtol=1e-12)
  np.testing.assert_array_equal(table.b1, np.stack(want['b1']))
  np.testing.assert_array_equal(table.b2, np.stack(want['b2']))


@pytest.mark.parametrize('name', TASKS)
def test_step_matches_the_golden(specs, golden, name):
  """At the golden's four states (and goals): OP3's and Hill's condim-3
  points in JAX's order (atol 1e-10; Hill's out on the hills touch the
  terrain), qacc and qfrc_constraint (rtol 1e-7, atol 1e-6), the residual
  (1e-10), the next qvel (1e-7) and qpos (1e-8). The rows of the points
  beyond the terrain or far from it are finite and inactive in float32
  too."""
  spec = specs[name]
  g = export.task_inputs(golden, name)
  m = spec.model
  d = _data(m, g)
  if m.collision_pairs:
    (s,) = constraint._contact_groups(m, fwd.fwd_position(m, d)).values()
    for k, got in (('dist', s.dist), ('pos', s.pos3), ('normal', s.normal)):
      _close(got.numpy(), g[k], k)
    assert (g['dist'] < 0).any(-1).all()
  if name == HILL:
    hf = slice(20, 36)
    assert (g['dist'][2:, hf] < 0).any(-1).all()
    assert (g['dist'][2:, :20] > 0.05).all()      # off the floor plane
  got = export.port_step(spec, g['qpos'], g['qvel'], g['ctrl'],
                         g['mocap_pos'], d.mocap_quat.numpy())
  for k in ('qacc', 'qfrc_constraint'):
    _close(got[k], g[k], k, rtol=1e-7, atol=1e-6)
  _close(got['residual'], g['residual'], 'residual')
  _close(got['next_qvel'], g['next_qvel'], 'next_qvel', rtol=1e-7,
         atol=1e-7)
  _close(got['next_qpos'], g['next_qpos'], 'next_qpos', rtol=1e-8,
         atol=1e-8)
  if m.collision_pairs:
    m32 = registry.get_task(name, device='cpu', dtype=torch.float32).model
    d32 = fwd.fwd_position(m32, make_data(m32, 4).replace(
        qpos=_f64(g['qpos']).float(), qvel=_f64(g['qvel']).float()))
    (pr,), capped = constraint.contact_point_groups(m32, d32)
    assert capped is None
    assert torch.isfinite(pr.aref).all() and torch.isfinite(pr.dvec).all()


def test_hill_far_points_are_inactive_in_float32(specs):
  """Hill standing beyond the terrain: its hfield points at depth 1e10
  stay finite with zero penalty rows in float32."""
  m32 = registry.get_task(HILL, device='cpu', dtype=torch.float32).model
  q = m32.keyframe_qpos('home').clone()
  q[:2] = torch.tensor([7.0, -6.0])
  d32 = fwd.fwd_position(m32, make_data(m32).replace(qpos=q[None]))
  (s,) = constraint._contact_groups(m32, d32).values()
  far = s.dist >= 1e9
  assert int(far.sum()) == 16
  assert torch.isfinite(s.pos3).all()
  (pr,), _ = constraint.contact_point_groups(m32, d32)
  assert torch.isfinite(pr.aref).all() and (pr.dvec[far] == 0).all()


def test_quadrotor_transition_matches_the_golden(specs, golden):
  """The goal on its circle at the golden's times (atol 1e-15), the
  params returned unchanged."""
  spec = specs['Quadrotor']
  g = export.task_inputs(golden, 'Quadrotor')
  m = spec.model
  for t, want in zip(g['transition/time'], g['transition/mocap_pos']):
    d = make_data(m).replace(time=_f64([t]))
    d2, p2 = spec.transition_fn(m, d, spec.default_params, torch.Generator())
    assert p2 is spec.default_params
    _close(d2.mocap_pos[0], want, f'goal at {t}', atol=1e-15)


@pytest.mark.parametrize('branch', list(export.HILL_BRANCHES))
def test_hill_transition_matches_the_golden(specs, golden, branch):
  """Hill's transition from the golden's state 3 (out on the hills) after
  kinematics and com velocities, in Quadruped mode (the goal far: no
  draw), Walk on a circle and Flip entered (its ground snapshot the
  terrain's height under the com): parameters (rtol 1e-10, atol 1e-12),
  weights (1e-12) and the goal (1e-12) equal JAX's."""
  spec = specs[HILL]
  m = spec.model
  g = export.task_inputs(golden, HILL)
  d = make_data(m).replace(
      time=_f64([g['transition/time']]), qpos=_f64(g['qpos'][3:4]),
      qvel=_f64(g['qvel'][3:4]),
      mocap_pos=_f64(g['transition/mocap_pos'])[None])
  d = kin.com_vel(m, kin.com_pos(m, kin.kinematics(m, d)))
  pre = f'transition/{branch}/'
  params = spec.default_params.replace(
      residual_params=_f64(g[pre + 'residual_params']))
  d2, p2 = spec.transition_fn(m, d, params, torch.Generator())
  _close(p2.residual_params, g[pre + 'next_residual_params'],
         'residual_params', rtol=1e-10, atol=1e-12)
  _close(p2.weights, g[pre + 'next_weights'], 'weights', atol=1e-12)
  _close(d2.mocap_pos[0], g[pre + 'next_mocap_pos'], 'goal', atol=1e-12)
  if branch == 'flip':
    ground = p2.residual_params[spec.residual_param_names.index(
        '_flip_ground')]
    assert float(ground) > 0.01


@pytest.mark.parametrize('name', TASKS)
def test_plan_matches_the_golden(specs, golden, name):
  """A 16-candidate x 6-step Predictive Sampling plan from the golden's
  state 1 with its knots and noise: the same returns (rtol 1e-8) and
  winner."""
  spec = specs[name]
  g = export.task_inputs(golden, name)
  m = spec.model
  d0 = make_data(m).replace(qpos=_f64(g['qpos'][1:2]),
                            qvel=_f64(g['qvel'][1:2]))
  got = export.port_plan(spec, d0, g, export.MANIPULATION_STEPS)
  np.testing.assert_allclose(got['returns'], g['plan/returns'], rtol=1e-8)
  assert int(got['winner']) == int(g['plan/winner'])


def test_tasks_plan_without_jax_or_mujoco():
  """The four tasks load, take a transition and run a 4 x 3 Predictive
  Sampling plan through make_planner with nothing of JAX or mujoco
  importable, reaching the kernels' device dispatch (where a CUDA tensor
  launches them): B1 twice a rollout step at n 2 / 6 / 18 / 18, B2 once at
  nv 18 with its one condim-3 group of P 29 (OP3) and 36 (Hill), and no
  B2 for Acrobot and Quadrotor, which have no constraint rows."""
  proc = _run(BLOCK + (
      "import torch\n"
      "from mujoco_mpc_tpu_torch.ops import newton, spd_solve\n"
      "from mujoco_mpc_tpu_torch.physics import forward\n"
      "from mujoco_mpc_tpu_torch.physics.model import make_data\n"
      "from mujoco_mpc_tpu_torch.planners import registry as planners\n"
      "from mujoco_mpc_tpu_torch.tasks import registry\n"
      "torch.set_num_threads(1)\n"
      "calls = []\n"
      "solve, newt = spd_solve._solve, newton._newton\n"
      "def rec_solve(a, b):\n"
      "  calls.append(('chol_solve', b.shape[1]))\n"
      "  return solve(a, b)\n"
      "def rec_newton(*args, **kw):\n"
      "  calls.append(('newton', args[1].shape[1], args[11].shape[1]))\n"
      "  return newt(*args, **kw)\n"
      "spd_solve._solve, newton._newton = rec_solve, rec_newton\n"
      "for name in ('Acrobot', 'Quadrotor', 'OP3 Stand',\n"
      "             'Quadruped Hill'):\n"
      "  spec = registry.get_task(name, device='cpu')\n"
      "  m, p = spec.model, spec.default_params\n"
      "  d = forward.forward(m, make_data(m))\n"
      "  if spec.transition_fn is not None:\n"
      "    d, p = spec.transition_fn(m, d, p, torch.Generator())\n"
      "  plan = planners.make_planner(spec, planners.SAMPLING, 4, 3, 3)\n"
      "  calls.clear()\n"
      "  _, info = plan.optimize(plan.init(), d, p, torch.Generator())\n"
      "  print(name.replace(' ', '_'), len(calls), sorted(set(calls)),\n"
      "        int(bool(torch.isfinite(info['best_return']))))\n"))
  assert proc.returncode == 0, proc.stderr
  lines = proc.stdout.strip().splitlines()
  want = {'Acrobot': (6, "[('chol_solve', 2)]"),
          'Quadrotor': (6, "[('chol_solve', 6)]"),
          'OP3_Stand': (9, "[('chol_solve', 18), ('newton', 18, 29)]"),
          'Quadruped_Hill': (9, "[('chol_solve', 18), ('newton', 18, 36)]")}
  assert len(lines) == 4
  for line in lines:
    name, n, rest = line.split(maxsplit=2)
    calls, finite = rest.rsplit(' ', 1)
    assert (int(n), calls) == want[name], line
    assert finite == '1', line


@pytest.mark.slow
def test_golden_is_jaxs(golden):
  """The golden file is what the JAX package computes now: every task's
  outputs recomputed live from the file's inputs (four JAX step compiles
  and Quadrotor's derivative pass, minutes)."""
  for name in TASKS:
    want = export.jax_last_task_golden(name,
                                       export.task_inputs(golden, name))
    for k, v in want.items():
      np.testing.assert_allclose(v, golden[k], rtol=1e-10, atol=1e-12,
                                 err_msg=k)
