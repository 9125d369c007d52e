"""The port's primitive contacts against JAX and MuJoCo, in float64.

* The plane-sphere, plane-capsule (with its tangent hint) and plane-box
  colliders and the tangent frames against mujoco_mpc_tpu.physics.
  collision on random poses, and pair_params on the Quadruped's pairs.
* contact_point_groups (g, cdofc, dmask, aref, dvec, mu) and
  contact_blocks against JAX's, vmapped at B 4, on Quadruped Flat states
  with contacts and joint limits active; expand_point_rows equal to
  contact_blocks' rows.
* The constrained qacc against mujoco.mj_forward at 3 states, with the
  tolerance of tests/test_contacts.py.
* The convex-hull colliders (_plane_mesh, _sphere_mesh, _box_mesh,
  capsule-mesh, _sphere_sphere) and the four batched clusters against
  JAX's, eagerly vmapped, on Shadow Reorient's chamfered-cube hull and its
  own pairs, in float64: random poses and the resting pose at qpos0, where
  8 hull vertices tie for the lowest; the tied choice takes the same
  vertex indices as lax.top_k. Mesh-mesh, height-field and the other
  primitive pairs still raise, naming their ROADMAP item.
"""

import os

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu.physics import collision as jcollision
from mujoco_mpc_tpu.physics import constraint as jconstraint
from mujoco_mpc_tpu.physics import kinematics as jkin
from mujoco_mpc_tpu.models import hands
from mujoco_mpc_tpu.physics.model import load_model
from mujoco_mpc_tpu.physics.model import make_data as jmake_data
from mujoco_mpc_tpu_torch.physics import collision
from mujoco_mpc_tpu_torch.physics import constraint
from mujoco_mpc_tpu_torch.physics import forward as fwd
from mujoco_mpc_tpu_torch.physics import kinematics as kin
from mujoco_mpc_tpu_torch.physics import model as model_lib
from tools import export_torch_snapshot as export

torch.set_num_threads(1)

XML = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'mujoco_mpc_tpu', 'models', 'quadruped.xml')
NPOSE = 16
NSTATE = 4


def _close(got, want, name, atol=1e-10):
  np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-10,
                             atol=atol, err_msg=name)


def _unit(rng, *shape):
  v = rng.normal(size=shape + (3,))
  return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _rotations(rng, n):
  q = rng.normal(size=(n, 4))
  q /= np.linalg.norm(q, axis=-1, keepdims=True)
  return np.stack([mujoco_quat_to_mat(x) for x in q])


def mujoco_quat_to_mat(q):
  mat = np.zeros(9)
  mujoco.mju_quat2Mat(mat, q)
  return mat.reshape(3, 3)


@pytest.mark.parametrize('pair', ['sphere', 'capsule', 'capsule_upright',
                                  'box'])
def test_plane_primitive_narrowphase(pair):
  rng = np.random.default_rng(['sphere', 'capsule', 'capsule_upright',
                               'box'].index(pair))
  pp = rng.normal(scale=0.3, size=(NPOSE, 3))
  pn = _unit(rng, NPOSE)
  c = pp + rng.normal(scale=0.2, size=(NPOSE, 3))
  mat = _rotations(rng, NPOSE)
  size = np.array([0.05, 0.12, 0.07])
  if pair == 'capsule_upright':       # axis along the normal: makeFrame t1
    mat[:NPOSE // 2, :, 2] = pn[:NPOSE // 2]
  t = lambda x: torch.from_numpy(np.asarray(x))  # noqa: E731
  if pair == 'sphere':
    got = collision._plane_sphere(t(pp), t(pn), t(c), t(size[0]))
    want = jax.vmap(lambda a, b, x: jcollision._plane_sphere(
        a, b, x, size[0]))(pp, pn, c)
  elif pair == 'box':
    signs = t([[sx, sy, sz] for sx in (-1., 1.) for sy in (-1., 1.)
               for sz in (-1., 1.)])
    got = collision._plane_box(t(pp), t(pn), t(c), t(mat), t(size), signs)
    want = jax.vmap(lambda a, b, x, r: jcollision._plane_box(
        a, b, x, r, jnp.asarray(size)))(pp, pn, c, mat)
  else:
    got = collision._plane_capsule(t(pp), t(pn), t(c), t(mat[..., 2]),
                                   t(size[1]), t(size[0]))
    want = jax.vmap(lambda a, b, x, ax: jcollision._plane_capsule(
        a, b, x, ax, size[1], size[0]))(pp, pn, c, mat[..., 2])
  assert len(got) == len(want)
  for k, (g, w) in enumerate(zip(got, want)):
    for field in ('dist', 'pos', 'normal', 'tangent'):
      gv, wv = getattr(g, field), getattr(w, field)
      assert (gv is None) == (wv is None), (k, field)
      if gv is not None:
        _close(gv.numpy(), wv, f'point {k} {field}')


def test_tangent_frames_with_hints():
  rng = np.random.default_rng(4)
  n = _unit(rng, NPOSE)
  n[:3] = np.eye(3)                     # ties of |n_i| at the axes
  hint = np.cross(n, _unit(rng, NPOSE))
  hint /= np.linalg.norm(hint, axis=-1, keepdims=True)
  hint[::2] = 0.0                       # every other row: no override
  got = collision._make_frames(torch.from_numpy(n), torch.from_numpy(hint))
  want = jcollision._make_frames(jnp.asarray(n), jnp.asarray(hint))
  for g, w, name in zip(got, want, ('t1', 't2')):
    _close(g.numpy(), w, name)


@pytest.fixture(scope='module')
def quadruped():
  jm, mj = load_model(XML, dtype=jnp.float64)
  m = model_lib.from_arrays(*export.model_snapshot(jm), device='cpu',
                            dtype=torch.float64)
  rng = np.random.default_rng(0)
  qpos = np.tile(np.asarray(jm.key_qpos[0]), (NSTATE, 1))
  qpos[:, 2] -= rng.uniform(0.0, 0.06, NSTATE)   # feet and shanks sink
  qpos[:, 7:] += rng.normal(scale=0.35, size=(NSTATE, 12))
  qpos[3, 8] = 1.7                               # a thigh past its limit
  qvel = rng.normal(scale=0.5, size=(NSTATE, jm.nv))
  ctrl = rng.normal(scale=0.3, size=(NSTATE, jm.nu))
  return jm, mj, m, (qpos, qvel, ctrl)


@pytest.mark.parametrize('case', ['default', 'priority', 'solmix'])
def test_pair_params(quadruped, case):
  jm, _, m, _ = quadruped
  if case == 'priority':
    prio = (1,) + (0,) * (jm.ngeom - 1)
    jm, m = jm.replace(geom_priority=prio), m.replace(geom_priority=prio)
  elif case == 'solmix':
    mix = np.linspace(0.0, 2.0, jm.ngeom)
    solref = np.asarray(jm.geom_solref).copy()
    solref[2] = (-100.0, -10.0)         # one direct solref: min rule
    jm = jm.replace(geom_solmix=jnp.asarray(mix),
                    geom_solref=jnp.asarray(solref))
    m = m.replace(geom_solmix=torch.from_numpy(mix),
                  geom_solref=torch.from_numpy(solref))
  for g1, g2 in jm.collision_pairs:
    got = collision.pair_params(m, g1, g2)
    want = jcollision.pair_params(jm, g1, g2)
    assert got.condim == want.condim
    for field in ('friction', 'solref', 'solimp', 'includemargin',
                  'invweight'):
      _close(getattr(got, field).numpy(), getattr(want, field),
             f'({g1}, {g2}) {field}')


@pytest.fixture(scope='module')
def rows(quadruped):
  """The port's and JAX's contact rows at the module's states."""
  jm, _, m, (qpos, qvel, ctrl) = quadruped
  jd0 = jmake_data(jm, dtype=jnp.float64)

  @jax.jit
  @jax.vmap
  def jax_rows(q, v):
    d = jkin.com_pos(jm, jkin.kinematics(jm, jd0.replace(qpos=q, qvel=v)))
    groups, _ = jconstraint.contact_point_groups(jm, d)
    blocks = jconstraint.contact_blocks(jm, d)
    return ([(p.g, p.cdofc, p.aref, p.dvec, p.mu) for p in groups],
            [(b.rows, b.frame, b.pos) for b in blocks])

  d = model_lib.make_data(m, NSTATE).replace(qpos=torch.from_numpy(qpos),
                                             qvel=torch.from_numpy(qvel))
  d = kin.com_pos(m, kin.kinematics(m, d))
  jd = jkin.kinematics(jm, jd0.replace(qpos=jnp.asarray(qpos[0])))
  dmasks = [p.dmask for p in jconstraint.contact_point_groups(
      jm, jkin.com_pos(jm, jd))[0]]
  return (constraint.contact_point_groups(m, d)[0],
          constraint.contact_blocks(m, d), jax_rows(qpos, qvel), dmasks)


def test_contact_point_groups(rows):
  groups, _, (want, _), dmasks = rows
  assert [p.condim for p in groups] == [3]
  assert groups[0].g.shape[1] == want[0][0].shape[1]     # P from JAX: 20
  assert bool((groups[0].dvec > 0).any()), 'no contact active'
  for p, w, dm in zip(groups, want, dmasks):
    np.testing.assert_array_equal(p.dmask.numpy(), dm)
    for name, got, ref in zip(('g', 'cdofc', 'aref', 'dvec', 'mu'),
                              (p.g, p.cdofc, p.aref, p.dvec, p.mu), w):
      # f64, the same formulas; aref scales with qvel and the stiffness
      _close(got.numpy(), ref, name, atol=1e-8)


def test_contact_blocks(rows):
  _, blocks, (_, want), _ = rows
  assert len(blocks) == len(want) == 1
  for b, (wrows, wframe, wpos) in zip(blocks, want):
    for name in ('j', 'pos', 'margin', 'aref', 'd'):
      _close(getattr(b.rows, name).numpy(), getattr(wrows, name), name,
             atol=1e-8)
    np.testing.assert_array_equal(b.rows.active.numpy(), wrows.active)
    _close(b.frame.numpy(), wframe, 'frame')
    _close(b.pos.numpy(), wpos, 'pos')


def test_expand_point_rows_equals_contact_blocks(rows):
  groups, blocks, _, _ = rows
  for p, b in zip(groups, blocks):
    j, aref, dvec = constraint.expand_point_rows(p)
    _close(j.numpy(), b.rows.j.numpy(), 'j')
    _close(aref.numpy(), b.rows.aref.numpy(), 'aref', atol=1e-8)
    want_d = torch.where(b.rows.active, b.rows.d, torch.zeros_like(b.rows.d))
    _close(dvec.numpy(), want_d.numpy(), 'dvec', atol=1e-8)


def test_qacc_matches_mujoco(quadruped):
  """Both solvers run to convergence (100 iterations instead of the
  model's planning cap of 6), so both reach the one minimiser."""
  _, mj, m, (qpos, qvel, ctrl) = quadruped
  m = m.replace(opt=m.opt.replace(iterations=100))
  mj.opt.iterations = 100
  d = model_lib.make_data(m, 3).replace(
      qpos=torch.from_numpy(qpos[:3]), qvel=torch.from_numpy(qvel[:3]),
      ctrl=torch.from_numpy(ctrl[:3]))
  got = fwd.forward(m, d).qacc.numpy()
  mjd = mujoco.MjData(mj)
  for i in range(3):
    mjd.qpos[:], mjd.qvel[:], mjd.ctrl[:] = qpos[i], qvel[i], ctrl[i]
    mujoco.mj_forward(mj, mjd)
    assert mjd.ncon > 0
    np.testing.assert_allclose(got[i], mjd.qacc, rtol=1e-5, atol=1e-6,
                               err_msg=f'state {i} ncon={mjd.ncon}')


# ---------------------------------------------------------------------------
# Convex hulls on Shadow Reorient's model: floor (geom 0, plane), cube (2,
# the mesh hull, V 24, F 44), palm (3, box), finger capsules and the five
# fingertip spheres.
# ---------------------------------------------------------------------------

NHULL = 12      # sample 0: the pose at qpos0; the rest random


@pytest.fixture(scope='module')
def shadow():
  """(JAX model f64, port model f64, JAX Data and port Data batches with
  geom poses: sample 0 from the kinematics at qpos0, the others random
  around the cube, so that planes, boxes, capsules and spheres cut the
  hull)."""
  xml = hands.hand_xml('Shadow Reorient', 4, mesh_cube=True)
  jm, _ = load_model(xml_string=xml, dtype=jnp.float64)
  m = model_lib.from_arrays(*export.model_snapshot(jm), device='cpu',
                            dtype=torch.float64)
  d0 = kin.kinematics(m, model_lib.make_data(m))
  rng = np.random.default_rng(7)
  xpos = np.repeat(d0.geom_xpos.numpy(), NHULL, 0)
  xmat = np.repeat(d0.geom_xmat.numpy(), NHULL, 0)
  xpos[1:] = xpos[1:, 2:3] + rng.normal(scale=0.03,
                                        size=(NHULL - 1, jm.ngeom, 3))
  xmat[1:] = _rotations(rng, (NHULL - 1) * jm.ngeom).reshape(
      NHULL - 1, jm.ngeom, 3, 3)
  d = model_lib.make_data(m, NHULL).replace(
      geom_xpos=torch.from_numpy(xpos), geom_xmat=torch.from_numpy(xmat))
  jd = jmake_data(jm, dtype=jnp.float64)
  return jm, m, d, jd, (xpos, xmat)


def _jax_vmap(jd, fn, xpos, xmat):
  return jax.vmap(lambda p, r: fn(jd.replace(geom_xpos=p, geom_xmat=r)))(
      jnp.asarray(xpos), jnp.asarray(xmat))


CLUSTER_CASES = {'sphere_mesh_batched': 'sm', 'capsule_mesh_batched': 'cm',
                 'plane_mesh_batched': 'pm', 'box_mesh_batched': 'bm'}


@pytest.mark.parametrize('case', ['plane_mesh', 'sphere_mesh', 'box_mesh',
                                  'capsule_mesh', 'sphere_sphere'])
def test_hull_narrowphase(shadow, case):
  """The unrolled colliders, through narrowphase, against JAX's on every
  pair of that kind in the model. f64, the same formulas: to rounding
  (rtol and atol 1e-10)."""
  jm, m, d, jd, (xpos, xmat) = shadow
  kinds = {'plane_mesh': (0, 7), 'sphere_mesh': (2, 7),
           'box_mesh': (6, 7), 'capsule_mesh': (3, 7),
           'sphere_sphere': (2, 2)}
  pairs = [p for p in jm.collision_pairs
           if (m.geom_type[p[0]], m.geom_type[p[1]]) == kinds[case]]
  assert pairs
  for g1, g2 in pairs:
    got = collision.narrowphase(m, d, g1, g2)
    want = _jax_vmap(jd, lambda x: jcollision.narrowphase(jm, x, g1, g2),
                     xpos, xmat)
    assert len(got) == len(want) == collision.points_per_pair(m, g1, g2)
    for k, (g, w) in enumerate(zip(got, want)):
      assert g.tangent is None and w.tangent is None
      for field in ('dist', 'pos', 'normal'):
        _close(getattr(g, field).numpy(), getattr(w, field),
               f'({g1}, {g2}) point {k} {field}')


def _vertex_ids(verts_w, dist, pos, normal):
  """Hull vertex indices of selected candidates: pos + dist/2 n is the
  vertex (the candidate sits halfway into the penetration)."""
  v = pos + 0.5 * dist[..., None] * normal
  return np.argmin(np.linalg.norm(v[:, None] - verts_w[None], axis=-1), 1)


def test_tied_hull_vertices_at_qpos0(shadow):
  """At qpos0 the cube rests unrotated: 8 of its 24 hull vertices share
  the lowest z. The floor's and the palm's k = 4 choices take lax.top_k's
  vertices (the lower index first among equals), unrolled and batched."""
  jm, m, d, jd, _ = shadow
  d0 = d.replace(geom_xpos=d.geom_xpos[:1], geom_xmat=d.geom_xmat[:1])
  verts_w = collision._hull_world(m, d0, 2)[0][0].numpy()
  low = np.isclose(verts_w[:, 2], verts_w[:, 2].min(), rtol=0, atol=0)
  assert low.sum() == 8
  jd0 = jd.replace(geom_xpos=jnp.asarray(d0.geom_xpos[0].numpy()),
                   geom_xmat=jnp.asarray(d0.geom_xmat[0].numpy()))
  jv, _, _ = jcollision._hull_world(jm, jd0, 2)
  pn = jd0.geom_xmat[0][:, 2]
  _, want_floor = jax.lax.top_k(-((jv - jd0.geom_xpos[0]) @ pn), 4)
  assert set(np.asarray(want_floor)) <= set(np.flatnonzero(low))
  for pts in (collision.narrowphase(m, d0, 0, 2),
              collision.plane_mesh_batched(
                  m, d0, collision.hull_cluster(m, [(0, 2)]))):
    if isinstance(pts, list):
      pts = tuple(torch.stack([getattr(p, f) for p in pts], 1)
                  for f in ('dist', 'pos', 'normal'))
    ids = _vertex_ids(verts_w, *(x[0].numpy() for x in pts))
    np.testing.assert_array_equal(ids, np.asarray(want_floor))
  # the palm's half of box-mesh: hull vertices in the box, the 4 deepest
  jw = jcollision._box_mesh(jm, jd0, 3, 2)[4:]
  want_palm = _vertex_ids(verts_w, *(np.stack([np.asarray(getattr(p, f))
                                               for p in jw])
                                     for f in ('dist', 'pos', 'normal')))
  got = collision.narrowphase(m, d0, 3, 2)[4:]
  ids = _vertex_ids(verts_w, *(torch.stack([getattr(p, f) for p in got],
                                           1)[0].numpy()
                               for f in ('dist', 'pos', 'normal')))
  np.testing.assert_array_equal(ids, want_palm)
  got_b = collision.box_mesh_batched(m, d0,
                                     collision.hull_cluster(m, [(3, 2)]))
  want_b = jcollision.box_mesh_batched(jm, jd0, [(3, 2)])
  for g, w in zip(got_b, want_b):
    _close(g[0].numpy(), w, 'box_mesh_batched at qpos0')


@pytest.mark.parametrize('case', sorted(CLUSTER_CASES))
def test_hull_clusters(shadow, case):
  """Each batched cluster on the model's pairs of its kind (pm and bm:
  Shadow's single floor and palm pairs, called directly) against JAX's:
  the averaged-face normals, the pair-major order and the two box-mesh
  halves. f64: rtol and atol 1e-10."""
  jm, m, d, jd, (xpos, xmat) = shadow
  kind = CLUSTER_CASES[case]
  _, sm, _, _, cm, _ = jcollision.contact_clusters(jm)
  pairs = {'sm': sm[0] if sm else None, 'cm': cm[0] if cm else None,
           'pm': [(0, 2)], 'bm': [(3, 2)]}[kind]
  assert pairs and (kind in ('pm', 'bm') or len(pairs) >= 4)
  got = getattr(collision, case)(m, d, collision.hull_cluster(m, pairs))
  want = _jax_vmap(jd, lambda x: getattr(jcollision, case)(jm, x, pairs),
                   xpos, xmat)
  for name, g, w in zip(('dist', 'pos', 'normal'), got, want):
    assert g.shape == w.shape, (name, g.shape, w.shape)
    _close(g.numpy(), w, f'{case} {name}')


def test_contact_clusters_match_jax(shadow):
  """sm (5 fingertips) and cm (15 capsules) as JAX forms them; the
  floor and palm pairs stay on the unrolled path."""
  jm, m, _, _, _ = shadow
  want = jcollision.contact_clusters(jm)
  got = collision.contact_clusters(m)
  for g, w in zip(got[:5], want[:5]):
    assert [list(map(tuple, c)) for c in g] == [list(map(tuple, c))
                                                 for c in w]
  assert got[5] == want[5]
  assert [[len(c) for c in cls] for cls in got[:5]] == [[], [5], [], [],
                                                        [15]]


@pytest.mark.parametrize('pair,item', [((2, 2), 'A7'), ('hfield', 'A7'),
                                       ((7, 4), 'A6'), ((3, 3), 'A6')])
def test_unported_pairs_raise(shadow, pair, item):
  """No pair falls back to nothing: mesh-mesh and height fields raise
  naming A7, the other primitive pairs A6, in narrowphase, in the point
  count and when a model with such a pair builds its contact table."""
  _, m, d, _, _ = shadow
  if pair == 'hfield':
    m = m.replace(geom_type=(int(model_lib.GeomType.HFIELD),)
                  + m.geom_type[1:])
    pair = (0, 2)
  for call in (lambda: collision.narrowphase(m, d, *pair),
               lambda: collision.points_per_pair(m, *pair),
               lambda: constraint.contact_table(
                   m.replace(collision_pairs=(pair,)))):
    with pytest.raises(NotImplementedError, match=f'ROADMAP {item}'):
      call()


def test_mesh_mesh_cluster_raises(shadow):
  """Eight condim-1 mesh-mesh pairs of one hull shape form JAX's mm
  cluster, with its dynamic rows: refused, naming A7."""
  _, m, _, _, _ = shadow
  m = m.replace(collision_pairs=((2, 2),) * 8,
                geom_condim=tuple(1 for _ in m.geom_condim))
  with pytest.raises(NotImplementedError, match='mesh-mesh.*ROADMAP A7'):
    constraint.contact_table(m)
