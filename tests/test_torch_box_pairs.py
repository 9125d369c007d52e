"""The box-pair slice of the port against the JAX package and MuJoCo,
float64 on the CPU: the box-box, capsule-box and capsule-capsule pairs and
the four tasks they open (Walker, nv 9: plane- and capsule-capsule;
Bimanual Insert, nv 18: a box peg in a box socket; Allegro Cube, nv 18: a
box cube on a box palm with capsule fingers; Humanoid Interact, nv 23: the
humanoid beside a box chair).

No JAX step is compiled here (four would take minutes): each task's step
is held to assets/box_pairs_golden.npz, written once from the JAX package
in float64 by `python tools/export_torch_snapshot.py --box-pairs-golden`
(its inputs, JAX version and command are in the file); test_golden_is_jaxs
recomputes it live (slow). Tolerances are those of
tests/test_torch_manipulation.py:

* _segment_closest, capsule-capsule, _box_box_sat and _capsule_box
  against JAX's under one jitted vmap each, 256 configurations each from
  a numpy seed (every point's dist, pos and normal; atol 1e-10): aligned
  stacked boxes (the face tie), concentric boxes (jnp.sign(0): zero
  normals), parallel edges, edge-edge wins, separated and touching boxes;
  a capsule parallel to a face, through the box's centre, across an edge;
  parallel, antiparallel, collinear, near-parallel and crossing segments.
* the box-box trajectories of tests/test_contacts.py against mj_step:
  the aligned stack, 80 steps, qpos atol 5e-3; the 30-degree twisted drop,
  60 steps, atol 2e-2.
* points_per_pair and pair_params against JAX's on each model, and
  contact_table against them in JAX's stacking order (exact, 1e-12).
* per task, against the golden: the condim-3 points (atol 1e-10), qacc
  and qfrc_constraint (rtol 1e-7, atol 1e-6), the residual (1e-10; Humanoid
  Interact's also with active keyframe pairs), the next qvel (1e-7) and
  qpos (1e-8) at four states; Allegro Cube's transition (a new goal; a
  dropped cube put back) and Humanoid Interact's mode switch (switched;
  kept), with JAX's draw handed to the port's generator (atol 1e-15); a
  16-candidate x 6-step Predictive Sampling plan's returns (rtol 1e-8)
  and winner.
* the snapshots match a fresh export; the four tasks load and plan with
  nothing of JAX or mujoco importable, reaching both kernels' device
  dispatch at their n, nv and point counts.
"""

import os

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu.physics import collision as jcollision
from mujoco_mpc_tpu.physics.model import load_model
from mujoco_mpc_tpu.physics.model import make_data as jmake_data
from mujoco_mpc_tpu.tasks import registry as jregistry
from mujoco_mpc_tpu_torch.physics import collision
from mujoco_mpc_tpu_torch.physics import constraint
from mujoco_mpc_tpu_torch.physics import forward as fwd
from mujoco_mpc_tpu_torch.physics import kinematics as kin
from mujoco_mpc_tpu_torch.physics import model as model_lib
from mujoco_mpc_tpu_torch.physics.model import make_data
from mujoco_mpc_tpu_torch.tasks import registry
import tests.test_contacts as jcontacts
from tests.test_torch_manipulation import _Draw
from tests.test_torch_package import BLOCK, _check_snapshot, _run
from tools import export_torch_snapshot as export

torch.set_num_threads(1)

TASKS = export.BOX_PAIR_TASKS
N = 256


def _f64(x):
  return torch.from_numpy(np.asarray(x, np.float64))


def _jax(fn, *args):
  """fn under one jitted vmap on numpy args: its points' (dist, pos,
  normal) as numpy."""
  out = jax.jit(jax.vmap(lambda *a: [tuple(p[:3]) for p in fn(*a)]))(
      *(jnp.asarray(x) for x in args))
  return [[np.asarray(x) for x in p] for p in out]


def _same(got, want, what):
  assert len(got) == len(want), what
  for k, (g, w) in enumerate(zip(got, want)):
    for name, a, b in zip(('dist', 'pos', 'normal'), g[:3], w):
      np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-10,
                                 err_msg=f'{what} point {k} {name}')


def _rotations(rng, n):
  q = rng.normal(size=(n, 4))
  q /= np.linalg.norm(q, axis=1, keepdims=True)
  out = np.zeros((n, 9))
  for i in range(n):
    mujoco.mju_quat2Mat(out[i], q[i])
  return out.reshape(n, 3, 3)


def _about(axis, angle):
  """Rotation matrices (n, 3, 3) by `angle` (n,) about a unit axis."""
  k = np.array([[0.0, -axis[2], axis[1]], [axis[2], 0.0, -axis[0]],
                [-axis[1], axis[0], 0.0]])
  a = np.asarray(angle)[:, None, None]
  return np.eye(3) + np.sin(a) * k + (1.0 - np.cos(a)) * (k @ k)


def _signed_perms(n):
  """n signed permutation frames (proper rotations), cycling."""
  perms = [np.eye(3)[list(p)] * s[:, None]
           for p in ((0, 1, 2), (1, 2, 0), (2, 0, 1))
           for s in (np.ones(3), np.array([-1.0, 1.0, -1.0]),
                     np.array([1.0, -1.0, -1.0]))]
  return np.stack([perms[i % len(perms)] for i in range(n)])


# ---------------------------------------------------------------------------
# Segments and capsule-capsule
# ---------------------------------------------------------------------------


def _segment_cases(rng, n=N):
  """(c1, a1, h1, r1, c2, a2, h2, r2), by index mod 8: 0 random; 1
  parallel and 2 antiparallel axes, offset sideways, and 4 collinear and
  overlapping: the floored denominator, along the coordinate axes with
  dyadic centres, as Walker's legs stand at qpos0 (turned, the floor
  makes s of a last-ulp difference in b f - c, which XLA's fused
  multiply-adds round otherwise: no float64 reference holds there); 3
  crossing at right angles; 5 near-parallel (1e-3 rad); 6 axis-aligned
  dyadic crossings touching (dist exactly 0); 7 far apart, both clamped
  to an end."""
  kind = np.arange(n) % 8
  c1 = rng.normal(scale=0.1, size=(n, 3))
  a1 = rng.normal(size=(n, 3))
  a1 /= np.linalg.norm(a1, axis=1, keepdims=True)
  a2 = rng.normal(size=(n, 3))
  a2 /= np.linalg.norm(a2, axis=1, keepdims=True)
  h1, h2 = rng.uniform(0.02, 0.2, n), rng.uniform(0.02, 0.2, n)
  r1, r2 = rng.uniform(0.01, 0.05, n), rng.uniform(0.01, 0.05, n)
  side = np.cross(a1, rng.normal(size=(n, 3)))
  side /= np.linalg.norm(side, axis=1, keepdims=True)
  lat = side * rng.uniform(0.0, 0.08, (n, 1))
  c2 = c1 + rng.normal(scale=0.1, size=(n, 3))
  perp = np.cross(a1, side)
  a2[kind == 3] = perp[kind == 3]
  c2[kind == 3] = (c1 + lat)[kind == 3]
  near = _about(np.array([0.0, 0.0, 1.0]), np.full(n, 1e-3))
  tilt = np.einsum('ij,nj->ni', near[0], a1)
  a2[kind == 5], c2[kind == 5] = tilt[kind == 5], (c1 + lat)[kind == 5]
  par = np.isin(kind, (1, 2, 4))
  npar = int(par.sum())
  frames = _signed_perms(npar)
  a1[par] = frames[:, :, 0]
  c1[par] = rng.integers(-8, 8, (npar, 3)) * 2.0 ** -5
  h1[par] = rng.integers(1, 8, npar) * 2.0 ** -5
  h2[par] = rng.integers(1, 8, npar) * 2.0 ** -5
  shift = (frames[:, :, 1] * rng.integers(1, 4, (npar, 1))
           + frames[:, :, 0] * rng.integers(-4, 4, (npar, 1))) * 2.0 ** -6
  shift[kind[par] == 4] = (frames[:, :, 0] * rng.integers(
      -4, 4, (npar, 1)) * 2.0 ** -6)[kind[par] == 4]
  a2[par] = np.where((kind[par] == 2)[:, None], -a1[par], a1[par])
  c2[par] = c1[par] + shift
  exact = kind == 6
  e = np.eye(3)
  a1[exact], a2[exact] = e[0], e[1]
  c1[exact] = 0.0
  h1[exact], h2[exact] = 2.0 ** -3, 2.0 ** -3
  r1[exact], r2[exact] = 2.0 ** -5, 2.0 ** -6
  c2[exact] = (rng.choice([-1.0, 1.0], (int(exact.sum()), 1))
               * (2.0 ** -5 + 2.0 ** -6) * e[2])
  far = kind == 7
  c2[far] = c1[far] + a1[far] * 2.0 + side[far] * 0.3
  return c1, a1, h1, r1, c2, a2, h2, r2


def test_segment_closest_matches_jax():
  c1, a1, h1, _, c2, a2, h2, _ = _segment_cases(np.random.default_rng(5))
  args = (c1, a1, h1, c2, a2, h2)
  want = jax.jit(jax.vmap(jcollision._segment_closest))(
      *(jnp.asarray(x) for x in args))
  got = collision._segment_closest(*(_f64(x) for x in args))
  for name, g, w in zip(('q1', 'q2'), got, want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-10,
                               err_msg=name)
  q = collision._closest_on_segment(_f64(c2), _f64(c1), _f64(a1), _f64(h1))
  w = jax.jit(jax.vmap(jcollision._closest_on_segment))(
      *(jnp.asarray(x) for x in (c2, c1, a1, h1)))
  np.testing.assert_allclose(q.numpy(), np.asarray(w), rtol=0, atol=1e-10)


def test_capsule_capsule_matches_jax():
  """narrowphase's capsule-capsule branch: the closest segment points,
  then _sphere_sphere."""
  c1, a1, h1, r1, c2, a2, h2, r2 = _segment_cases(np.random.default_rng(6))

  def jax_pair(c1, a1, h1, r1, c2, a2, h2, r2):
    q1, q2 = jcollision._segment_closest(c1, a1, h1, c2, a2, h2)
    return jcollision._sphere_sphere(q1, r1, q2, r2)

  args = (c1, a1, h1, r1, c2, a2, h2, r2)
  got = collision._capsule_capsule(*(_f64(x) for x in args))
  _same(got, _jax(jax_pair, *args), 'capsule-capsule')
  kind = np.arange(N) % 8
  assert (got[0].dist.numpy()[kind == 6] == 0.0).all()
  assert (got[0].dist.numpy()[kind == 7] > 0.0).all()


# ---------------------------------------------------------------------------
# Box-box
# ---------------------------------------------------------------------------


def _box_box_cases(rng, n=N):
  """(p1, m1, s1, p2, m2, s2), by index mod 8: 0 random poses around
  each other; 1 aligned stacked boxes (one signed-permutation frame,
  dyadic sizes and offsets; every other one with equal sizes, where the
  two boxes' face separations tie exactly); 2 the stack turned about its
  vertical axis (parallel vertical edges: degenerate edge axes); 3
  edge-edge wins (drawn from random poses until the edge axis wins); 4
  separated; 5 aligned, touching (depth exactly 0); 6 concentric
  (jnp.sign(0): a zero reference normal); 7 one box resting 2 mm into
  another's face, random frames."""
  kind = np.arange(n) % 8
  s1 = rng.uniform(0.02, 0.06, (n, 3))
  s2 = rng.uniform(0.02, 0.06, (n, 3))
  m1, m2 = _rotations(rng, n), _rotations(rng, n)
  p1 = rng.normal(scale=0.1, size=(n, 3))
  p2 = p1 + rng.normal(scale=0.05, size=(n, 3))
  exact = np.isin(kind, (1, 2, 5, 6))
  ne = int(exact.sum())
  m1[exact] = _signed_perms(ne)
  s1[exact] = rng.choice([2.0 ** -5, 2.0 ** -4], (ne, 3))
  s2[exact] = rng.choice([2.0 ** -5, 2.0 ** -6], (ne, 3))
  tie = (kind == 1) & (np.arange(n) // 8 % 2 == 0)
  s2[tie] = s1[tie]
  p1[exact] = 0.0
  m2[exact] = m1[exact]
  turn = _about(np.array([0.0, 0.0, 1.0]), rng.uniform(0.2, 1.2, n))
  m2[kind == 2] = (m1 @ turn)[kind == 2]
  # box 2 over box 1 along box 1's third axis
  up = m1[:, :, 2]
  gap = np.where(kind == 5, 0.0, -rng.choice([1.0, 2.0, 3.0], n) * 2.0 ** -9)
  lateral = (m1[:, :, 0] * rng.choice([-1.0, 0.0, 1.0], (n, 1))
             + m1[:, :, 1] * rng.choice([-1.0, 0.0, 1.0], (n, 1))) * 2.0 ** -7
  stacked = p1 + lateral + up * (s1[:, 2] + s2[:, 2] + gap)[:, None]
  for k in (1, 2, 5):
    p2[kind == k] = stacked[kind == k]
  p2[kind == 4] = p1[kind == 4] + 0.5 * _unit(rng, int((kind == 4).sum()))
  p2[kind == 6] = p1[kind == 6]
  reach = np.einsum('ni,ni->n', s2,
                    np.abs(np.einsum('nji,nj->ni', m2, up)))
  rest = p1 + up * (s1[:, 2] + reach - 0.002)[:, None]
  p2[kind == 7] = rest[kind == 7]
  # edge-edge wins: random poses until the edge axis wins (the port's
  # choice here; the test holds every case to JAX's)
  edge = np.flatnonzero(kind == 3)
  cand = 64 * len(edge)
  cp1 = rng.normal(scale=0.1, size=(cand, 3))
  cm1, cm2 = _rotations(rng, cand), _rotations(rng, cand)
  cs1 = rng.uniform(0.02, 0.06, (cand, 3))
  cs2 = rng.uniform(0.02, 0.06, (cand, 3))
  cp2 = cp1 + _unit(rng, cand) * np.linalg.norm(cs1 + cs2, axis=1,
                                                keepdims=True) * 0.75
  pts = collision._box_box_sat(*(_f64(x) for x in (cp1, cm1, cs1, cp2, cm2,
                                                    cs2)))
  wins = np.flatnonzero(pts[4].dist.numpy() < 0)[:len(edge)]
  assert len(wins) == len(edge)
  for a, c in ((p1, cp1), (m1, cm1), (s1, cs1), (p2, cp2), (m2, cm2),
               (s2, cs2)):
    a[edge] = c[wins]
  return p1, m1, s1, p2, m2, s2


def _unit(rng, n):
  v = rng.normal(size=(n, 3))
  return v / np.linalg.norm(v, axis=1, keepdims=True)


def test_box_box_matches_jax():
  args = _box_box_cases(np.random.default_rng(7))
  got = collision._box_box_sat(*(_f64(x) for x in args))
  _same(got, _jax(jcollision._box_box_sat, *args), 'box-box')
  kind = np.arange(N) % 8
  dist = np.stack([p.dist.numpy() for p in got], -1)       # (N, 5)
  face = dist[:, 4] == 1e6
  assert face[np.isin(kind, (1, 2, 5, 6))].all()
  assert not face[kind == 3].any() and (dist[kind == 3, :4] == 1e6).all()
  assert (dist[kind == 5, :4] == 0.0).all()
  assert (dist[kind == 1, :4] < 0.0).all()
  assert (dist[kind == 4] > 0.0).all()
  assert (np.linalg.norm(got[0].normal.numpy()[kind == 6], axis=-1)
          == 0.0).all()
  # the face tie: the largest face separations of the two boxes equal
  # (to the rounding of the sums JAX forms them with)
  p1, m1, s1, p2, m2, s2 = args
  r = np.einsum('nji,njk->nik', m1, m2)
  t = np.einsum('nji,nj->ni', m1, p2 - p1)
  absr = np.abs(r) + 1e-9
  sep1 = np.abs(t) - (s1 + np.einsum('nij,nj->ni', absr, s2))
  sep2 = np.abs(np.einsum('nji,nj->ni', r, t)) - (
      s2 + np.einsum('nji,nj->ni', absr, s1))
  tie = (kind == 1) & (np.arange(N) // 8 % 2 == 0)
  np.testing.assert_allclose(sep1.max(-1)[tie], sep2.max(-1)[tie],
                             rtol=0, atol=1e-15)


# ---------------------------------------------------------------------------
# Capsule-box
# ---------------------------------------------------------------------------


def _capsule_box_cases(rng, n=N):
  """(c, axis, half, r, bc, bmat, bsize), by index mod 8: 0 random; 1 a
  capsule parallel to a face, 0.5-3 mm into it (every segment point
  equally deep); 2 the axis through the box's centre, the capsule centred
  on it (the middle sphere at the exact centre: a zero normal); 3 across
  an edge, perpendicular to it, 0.5-3 mm in; 4 one end inside the box; 5
  separated; 6 standing on a face, the axis normal to it; 7 along a box
  axis at a dyadic offset. 1, 2, 4, 6 and 7 take signed-permutation
  frames about the origin and dyadic sizes, 4 and 7 dyadic centres and
  axes along the box's: where the segment crosses the box's surface the
  projections end on it, and the middle point's normal is the direction
  of the last ulps of its offset (exact arithmetic alone gives one
  answer)."""
  kind = np.arange(n) % 8
  bsize = rng.uniform(0.02, 0.06, (n, 3))
  bmat = _rotations(rng, n)
  bc = rng.normal(scale=0.1, size=(n, 3))
  half = rng.uniform(0.02, 0.1, n)
  r = rng.uniform(0.005, 0.02, n)
  exact = np.isin(kind, (1, 2, 4, 6, 7))
  bmat[exact] = _signed_perms(int(exact.sum()))
  bc[exact] = 0.0
  bsize[exact] = 2.0 ** -5
  r[exact], half[exact] = 2.0 ** -7, 2.0 ** -5
  h = bsize
  depth = (r - rng.uniform(0.0005, 0.003, n))[:, None]   # centre off face
  lat = rng.uniform(-0.5, 0.5, (n, 3)) * h
  ax = _unit(rng, n)                               # the axis, box frame
  local = rng.uniform(-1.5, 1.5, (n, 3)) * h       # the centre, box frame
  ex, ey, ez = np.eye(3)
  diag = (ey + ez) / np.sqrt(2.0)
  box_axis = (np.eye(3)[rng.integers(3, size=n)]
              * rng.choice([-1.0, 1.0], (n, 1)))
  dyadic = rng.integers(-3, 4, (n, 3)) * 2.0 ** -7
  cases = {1: (ex, lat * ey + ez * (h[:, 2:] + depth)),
           2: (ax, np.zeros((n, 3))),
           3: ((ey - ez) / np.sqrt(2.0),
               lat * ex + ey * h[:, 1:2] + ez * h[:, 2:] + diag * depth),
           4: (box_axis, dyadic + box_axis * half[:, None]),
           5: (ax, np.sign(local) * (h + half[:, None] + r[:, None] + 0.05)),
           6: (ez, lat * (ex + ey) + ez * (h[:, 2:] + half[:, None]
                                           + depth)),
           7: (box_axis, 4.0 * dyadic)}
  for k, (a, loc) in cases.items():
    sel = kind == k
    ax[sel] = np.broadcast_to(a, (n, 3))[sel]
    local[sel] = loc[sel]
  axis = np.einsum('nij,nj->ni', bmat, ax)
  c = bc + np.einsum('nij,nj->ni', bmat, local)
  return c, axis, half, r, bc, bmat, bsize


def test_capsule_box_matches_jax():
  args = _capsule_box_cases(np.random.default_rng(8))
  got = collision._capsule_box(*(_f64(x) for x in args))
  _same(got, _jax(jcollision._capsule_box, *args), 'capsule-box')
  kind = np.arange(N) % 8
  dist = np.stack([p.dist.numpy() for p in got], -1)       # (N, 3)
  assert (dist[np.isin(kind, (1, 3, 6)), 0] < 0).all()
  assert (dist[kind == 5] > 0).all()
  assert (dist[kind == 4].min(-1) < 0).all()
  assert (np.linalg.norm(got[0].normal.numpy()[kind == 2], axis=-1)
          == 0.0).all()


# ---------------------------------------------------------------------------
# Box-box trajectories against MuJoCo
# ---------------------------------------------------------------------------


def _traj_case(test):
  """(xml, q0, steps, atol) of a tests/test_contacts.py trajectory test,
  read by running it with its _traj_check replaced."""
  seen = []
  real = jcontacts._traj_check
  jcontacts._traj_check = lambda xml, q0, v0, n, atol, ctrl=None: (
      seen.append((xml, q0, n, atol)))
  try:
    getattr(jcontacts, test)()
  finally:
    jcontacts._traj_check = real
  return seen[0]


@pytest.mark.parametrize('test', ['test_box_box_sat_stack',
                                  'test_box_box_sat_rotated'],
                         ids=['stack', 'rotated'])
def test_box_box_trajectory_matches_mujoco(test):
  """The aligned stack (80 steps, qpos atol 5e-3) and the 30-degree
  twisted drop (60 steps, atol 2e-2), stepped by the port and by
  mj_step, at JAX's tolerances."""
  xml, q0, steps, atol = _traj_case(test)
  jm, mjm = load_model(xml_string=xml, dtype=jnp.float64)
  m = model_lib.from_arrays(*export.model_snapshot(jm), device='cpu',
                            dtype=torch.float64)
  mjd = mujoco.MjData(mjm)
  mjd.qpos[:] = q0
  d = make_data(m).replace(qpos=_f64(q0)[None])
  for _ in range(steps):
    mujoco.mj_step(mjm, mjd)
    d = fwd.step(m, d)
  np.testing.assert_allclose(d.qpos[0].numpy(), mjd.qpos, atol=atol)


# ---------------------------------------------------------------------------
# The four tasks: models, golden
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def golden():
  path = os.path.join(registry.ASSETS, export.BOX_PAIRS_GOLDEN)
  with np.load(path) as z:
    return {k: z[k] for k in z.files}


@pytest.fixture(scope='module')
def specs():
  """name -> the port's spec on the CPU in float64."""
  return {n: registry.get_task(n, device='cpu', dtype=torch.float64)
          for n in TASKS}


@pytest.mark.parametrize('name', TASKS)
def test_snapshots_are_current(name):
  _check_snapshot(name)


@pytest.mark.parametrize('name', TASKS)
def test_contact_table_matches_jax(specs, name):
  """Each pair's point count is the length of JAX's narrowphase output
  for it (traced abstractly: box-box 5, capsule-box 3, capsule-capsule
  1), its parameters are JAX's pair_params, and the condim-3 group's
  per-point parameters and bodies are those repeated over its points in
  the order of collision_pairs, as JAX's _contact_groups stacks a model
  without hull clusters (held to _contact_groups itself by
  test_torch_manipulation.py)."""
  m = specs[name].model
  jm = export._f64(jregistry.get_task(name).model)
  jd = jmake_data(jm, dtype=jnp.float64)
  counts = {(6, 6): 5, (3, 6): 3, (3, 3): 1}
  want = {k: [] for k in ('margin', 'solref', 'solimp', 'mu', 'invw',
                          'b1', 'b2')}
  seen = set()
  for pair in m.collision_pairs:
    types = (int(m.geom_type[pair[0]]), int(m.geom_type[pair[1]]))
    n = collision.points_per_pair(m, *pair)
    assert n == len(jax.eval_shape(
        lambda x, pair=pair: jcollision.narrowphase(jm, x, *pair), jd))
    assert n == counts.get(types, n)
    seen.add(types)
    got, jp = collision.pair_params(m, *pair), jcollision.pair_params(
        jm, *pair)
    assert got.condim == jp.condim == 3
    for k in ('friction', 'solref', 'solimp', 'includemargin', 'invweight'):
      np.testing.assert_allclose(getattr(got, k).numpy(),
                                 np.asarray(getattr(jp, k)), rtol=1e-12,
                                 atol=0, err_msg=k)
    for k, v in (('margin', jp.includemargin), ('solref', jp.solref),
                 ('solimp', jp.solimp), ('mu', jp.friction),
                 ('invw', jp.invweight), ('b1', jm.geom_bodyid[pair[0]]),
                 ('b2', jm.geom_bodyid[pair[1]])):
      want[k] += [np.asarray(v)] * n
  assert seen & set(counts)
  (table,) = m.contact
  assert table.condim == 3
  for k in ('margin', 'solref', 'solimp', 'mu', 'invw'):
    np.testing.assert_allclose(getattr(table, k).numpy(),
                               np.stack(want[k]), rtol=1e-12, atol=0,
                               err_msg=k)
  np.testing.assert_array_equal(table.b1, np.stack(want['b1']))
  np.testing.assert_array_equal(table.b2, np.stack(want['b2']))


@pytest.mark.parametrize('name', TASKS)
def test_step_matches_the_golden(specs, golden, name):
  """At the golden's four states: the condim-3 group's stacked points in
  JAX's order (far points of the unselected box-box family at 1e6
  included), qacc and qfrc_constraint (rtol 1e-7, atol 1e-6), the
  residual (1e-10), the next qvel (1e-7) and qpos (1e-8). The far points'
  rows are finite and inactive in float32 too."""
  spec = specs[name]
  g = export.task_inputs(golden, name)
  m = spec.model
  d = fwd.fwd_position(m, make_data(m, 4).replace(qpos=_f64(g['qpos'])))
  (s,) = constraint._contact_groups(m, d).values()
  for k, got in (('dist', s.dist), ('pos', s.pos3), ('normal', s.normal)):
    np.testing.assert_allclose(got.numpy(), g[k], rtol=0, atol=1e-10,
                               err_msg=k)
  assert (g['dist'][1:] < 0).any(-1).all()
  got = export.port_step(spec, g['qpos'], g['qvel'], g['ctrl'])
  for k in ('qacc', 'qfrc_constraint'):
    np.testing.assert_allclose(got[k], g[k], rtol=1e-7, atol=1e-6,
                               err_msg=k)
  np.testing.assert_allclose(got['residual'], g['residual'], rtol=0,
                             atol=1e-10)
  np.testing.assert_allclose(got['next_qvel'], g['next_qvel'], rtol=1e-7,
                             atol=1e-7)
  np.testing.assert_allclose(got['next_qpos'], g['next_qpos'], rtol=1e-8,
                             atol=1e-8)
  if 'residual_active' in g:
    rp = _f64(g['residual_params_active'])
    d = fwd.forward(m, make_data(m, 4).replace(
        qpos=_f64(g['qpos']), qvel=_f64(g['qvel']), ctrl=_f64(g['ctrl'])))
    res = spec.residual_fn(m, d, rp).numpy()
    np.testing.assert_allclose(res, g['residual_active'], rtol=0,
                               atol=1e-10)
    assert (np.abs(res[:, -15:-6]) > 0).any() and (res[:, -6:] == 0).all()
  # the far points in float32: finite reference accelerations and
  # penalties, no active row
  m32 = registry.get_task(name, device='cpu', dtype=torch.float32).model
  d32 = fwd.fwd_position(m32, make_data(m32, 4).replace(
      qpos=_f64(g['qpos']).float(), qvel=_f64(g['qvel']).float()))
  (pr,), capped = constraint.contact_point_groups(m32, d32)
  assert capped is None
  assert torch.isfinite(pr.aref).all() and torch.isfinite(pr.dvec).all()
  (s32,) = constraint._contact_groups(m32, d32).values()
  far = s32.dist >= 1e5
  assert far.any() == ('box-box' in _pairs(m32))
  assert (pr.dvec[far] == 0).all()


def _pairs(m):
  names = {(6, 6): 'box-box', (3, 6): 'capsule-box', (3, 3): 'capsule'}
  return {names.get((int(m.geom_type[a]), int(m.geom_type[b])))
          for a, b in m.collision_pairs}


def test_allegro_transition_matches_the_golden(specs, golden, monkeypatch):
  """Allegro Cube's transition on the golden's state 0: with the goal at
  the cube's orientation, a new goal from the normal draw JAX made
  (handed to the port through torch.randn); with the goal 1 rad off and
  the cube dropped below -0.12, the cube back above the palm at rest and
  the goal kept (atol 1e-15)."""
  name = 'Allegro Cube'
  spec = specs[name]
  m = spec.model
  g = export.task_inputs(golden, name)
  draw = g['transition/draw']
  randn = torch.randn

  def drawn(shape, generator, **kw):
    if not isinstance(generator, _Draw):
      return randn(shape, generator=generator, **kw)
    assert tuple(shape) == draw.shape
    return _f64(draw).to(kw['dtype'])

  monkeypatch.setattr(torch, 'randn', drawn)
  for branch in ('reached', 'not'):
    pre = f'transition/{branch}/'
    d = kin.kinematics(m, make_data(m).replace(
        qpos=_f64(g[pre + 'qpos'])[None], qvel=_f64(g['qvel'][:1]),
        mocap_quat=_f64(g[pre + 'mocap_quat'])[None]))
    d2, p2 = spec.transition_fn(m, d, spec.default_params, _Draw(draw))
    assert p2 is spec.default_params
    for k in ('qpos', 'qvel', 'mocap_quat'):
      np.testing.assert_allclose(getattr(d2, k)[0].numpy(),
                                 g[pre + 'next_' + k], rtol=0, atol=1e-15,
                                 err_msg=f'{branch} {k}')
    moved = not np.array_equal(d2.mocap_quat[0].numpy(),
                               g[pre + 'mocap_quat'])
    reset = not np.array_equal(d2.qpos[0].numpy(), g[pre + 'qpos'])
    assert (moved, reset) == ((True, False) if branch == 'reached'
                              else (False, True))


def test_interact_transition_matches_the_golden(specs, golden):
  """Humanoid Interact's mode switch: select_mode 2 over _cur_mode 0
  writes the Relaxing preset (the float32 table) into the weights; equal
  modes keep them; both store the mode in _cur_mode."""
  name = 'Humanoid Interact'
  spec = specs[name]
  m = spec.model
  g = export.task_inputs(golden, name)
  cur = spec.residual_param_names.index('_cur_mode')
  d = make_data(m)
  for branch in ('reached', 'not'):
    pre = f'transition/{branch}/'
    p = spec.default_params.replace(
        residual_params=_f64(g[pre + 'residual_params']))
    d2, p2 = spec.transition_fn(m, d, p, torch.Generator())
    assert d2 is d
    np.testing.assert_allclose(p2.weights.numpy(), g[pre + 'next_weights'],
                               rtol=0, atol=1e-15)
    np.testing.assert_allclose(p2.residual_params.numpy(),
                               g[pre + 'next_residual_params'], rtol=0,
                               atol=1e-15)
    changed = not np.array_equal(p2.weights.numpy(), p.weights.numpy())
    assert changed == (branch == 'reached')
    assert float(p2.residual_params[cur]) == (2.0 if branch == 'reached'
                                              else 1.0)


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
  importable, reaching both kernels' device dispatch (where a CUDA tensor
  launches them) at n and nv 9 / 18 / 18 / 23, B2 with its one condim-3
  group of P 29 / 32 / 59 / 48: B1 twice and B2 once a rollout step."""
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
      "for name in ('Walker', 'Bimanual Insert', 'Allegro Cube',\n"
      "             'Humanoid Interact'):\n"
      "  spec = registry.get_task(name, device='cpu')\n"
      "  m, p = spec.model, spec.default_params\n"
      "  d = forward.forward(m, make_data(m))\n"
      "  if spec.transition_fn is not None:\n"
      "    d, p = spec.transition_fn(m, d, p, torch.Generator())\n"
      "  plan = planners.make_planner(spec, planners.SAMPLING, 4, 3, 3)\n"
      "  calls.clear()\n"
      "  _, info = plan.optimize(plan.init(), d, p, torch.Generator())\n"
      "  print(name.replace(' ', '_'), sorted(set(calls)) ==\n"
      "        sorted(set(calls[:2])), len(calls), calls[:2],\n"
      "        int(bool(torch.isfinite(info['best_return']))))\n"))
  assert proc.returncode == 0, proc.stderr
  lines = proc.stdout.strip().splitlines()
  want = {'Walker': (9, 29), 'Bimanual_Insert': (18, 32),
          'Allegro_Cube': (18, 59), 'Humanoid_Interact': (23, 48)}
  assert len(lines) == 4
  for line in lines:
    name, same, n, first = line.split(maxsplit=3)
    nv, points = want[name]
    assert same == 'True' and n == '9', line      # 3 steps: 2 B1 + 1 B2
    assert first.rsplit(' ', 1)[0] == (
        f"[('chol_solve', {nv}), ('newton', {nv}, {points})]"), line
    assert first.rsplit(' ', 1)[1] == '1', line


@pytest.mark.slow
def test_golden_is_jaxs(golden):
  """The golden file is what the JAX package computes now: every task's
  outputs recomputed live from the file's inputs (four JAX step compiles,
  minutes)."""
  for name in TASKS:
    want = export.jax_box_pair_golden(name,
                                      export.task_inputs(golden, name))
    for k, v in want.items():
      np.testing.assert_allclose(v, golden[k], rtol=1e-10, atol=1e-12,
                                 err_msg=k)
