"""The manipulation slice of the port against the JAX package and MuJoCo,
float64 on the CPU: the sphere-box pair and the five tasks it opens
(FreeFingers, Panda, Panda Bring, Bimanual Handover, Bimanual Reorient;
fingertip spheres against a free box on a floor plane, nv 12 / 15 / 18).

No JAX step is compiled here (five would take minutes): each task's step
is held to assets/manipulation_golden.npz, written once from the JAX
package in float64 by `python tools/export_torch_snapshot.py
--manipulation-golden` (its inputs, JAX version and command are in the
file); test_golden_is_jaxs recomputes it live (slow).

* _sphere_box against JAX's under one jitted vmap, 256 configurations:
  shallow and deep, the centre on a face, edge and corner ties of the
  deep branch's axis, the exact centre (a zero normal, as jnp.sign gives
  it) and a sphere touching a face (dist, pos, normal; atol 1e-10).
* narrowphase's flipped sphere-box points against mujoco.mj_forward's
  contacts (dist, position, frame normal; atol 1e-9) at the golden's
  states with a fingertip against the object, shallow and deep, on float64
  models compiled from each task's MJCF.
* points_per_pair, contact_table and pair_params against JAX's on each
  model (exact, 1e-12).
* per task, against the golden (tolerances at each test): the contact
  points, qacc, qfrc_constraint, the residual and the next state at its
  four states; the transition in both branches, with the draw JAX made
  handed to the port's generator; a 16-candidate x 6-step Predictive
  Sampling plan's returns and winner.
* the constrained qacc against mujoco.mj_forward (rtol 1e-5, atol 1e-6,
  100 iterations in both, as test_torch_contacts.py's Quadruped case).
* the snapshots match a fresh export; the five tasks load, step and
  plan with nothing of JAX or mujoco importable, reaching both kernels'
  device dispatch at their nv and point counts.
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
from mujoco_mpc_tpu.physics.model import load_model
from mujoco_mpc_tpu.physics.model import make_data as jmake_data
from mujoco_mpc_tpu.tasks import registry as jregistry
from mujoco_mpc_tpu_torch.physics import collision
from mujoco_mpc_tpu_torch.physics import constraint
from mujoco_mpc_tpu_torch.physics import forward as fwd
from mujoco_mpc_tpu_torch.physics import kinematics as kin
from mujoco_mpc_tpu_torch.physics import model as model_lib
from mujoco_mpc_tpu_torch.physics.model import GeomType, make_data
from mujoco_mpc_tpu_torch.tasks import registry
from tests.test_torch_package import BLOCK, _check_snapshot, _run
from tools import export_torch_snapshot as export

torch.set_num_threads(1)

TASKS = export.MANIPULATION
SHALLOW = (1, 2)      # the golden's states with a fingertip 0.5-3 mm in
DEEP = 3              # its state with the sphere's centre inside the box


def _f64(x):
  return torch.from_numpy(np.asarray(x, np.float64))


# ---------------------------------------------------------------------------
# _sphere_box against JAX's
# ---------------------------------------------------------------------------


def _sphere_box_cases(rng, n=256):
  """(c, r, bc, bmat, bsize) batches, numpy, by index mod 8: 0 random
  poses around the box (shallow and deep), 1 centres strictly inside
  (deep), 2 centres on a face (the closest point the centre itself: a
  zero normal), 3 spheres touching a face (dist exactly 0), 4-6 deep
  ties of a cube's axes of least depth (x and y, y and z, all three: the
  first axis wins), 7 the exact centre of a cube (a zero normal, as
  jnp.sign gives it). Kinds 2-7 take signed-permutation frames about the
  origin and dyadic sizes, so that the box coordinates are exact."""
  kind = np.arange(n) % 8
  bsize = rng.uniform(0.01, 0.05, (n, 3))
  r = rng.uniform(0.005, 0.02, n)
  q = rng.normal(size=(n, 4))
  bmat = np.stack([_quat2mat(x / np.linalg.norm(x)) for x in q])
  bc = rng.normal(scale=0.1, size=(n, 3))
  local = rng.uniform(-1.6, 1.6, (n, 3)) * bsize
  local[kind == 1] *= 0.5
  exact = kind >= 2
  perms = [np.eye(3)[list(p)] * s[:, None]
           for p in ((0, 1, 2), (1, 2, 0), (2, 0, 1), (0, 2, 1))
           for s in (np.ones(3), np.array([-1.0, 1.0, -1.0]))]
  bmat[exact] = [perms[i % len(perms)] for i in range(int(exact.sum()))]
  bc[exact] = 0.0
  h, rr = 2.0 ** -5, 2.0 ** -7
  bsize[exact], r[exact] = h, rr
  sgn = rng.choice([-1.0, 1.0], (n, 3))
  lat = rng.choice([-0.5, 0.0, 0.5], (n, 3)) * h
  t = rng.choice([1.0, 2.0, 3.0], (n, 1)) * 2.0 ** -8      # depth of a tie
  cases = {2: np.concatenate([lat[:, :2], sgn[:, 2:] * h], 1),
           3: np.concatenate([-(h + rr) * np.ones((n, 1)), lat[:, 1:]], 1),
           4: np.concatenate([(h - t) * sgn[:, :2], lat[:, 2:]], 1),
           5: np.concatenate([lat[:, :1], (h - t) * sgn[:, 1:]], 1),
           6: (h - t) * sgn,
           7: np.zeros((n, 3))}
  for k, v in cases.items():
    local[kind == k] = v[kind == k]
  c = bc + np.einsum('bij,bj->bi', bmat, local)
  return c, r, bc, bmat, bsize


def _quat2mat(q):
  mat = np.zeros(9)
  mujoco.mju_quat2Mat(mat, q)
  return mat.reshape(3, 3)


def test_sphere_box_matches_jax():
  c, r, bc, bmat, bsize = _sphere_box_cases(np.random.default_rng(3))
  want = jax.jit(jax.vmap(
      lambda *a: tuple(jcollision._sphere_box(*a)[0])))(
          *(jnp.asarray(x) for x in (c, r, bc, bmat, bsize)))
  (got,) = collision._sphere_box(*(_f64(x) for x in (c, r, bc, bmat,
                                                     bsize)))
  for name, g, w in zip(('dist', 'pos', 'normal'), got, want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-10,
                               err_msg=name)
  # the cases are there: ties resolved to the first axis of least depth,
  # zero normals at the exact centre and on a face, touching spheres
  kind = np.arange(len(c)) % 8
  local = np.einsum('bji,bj->bi', bmat, c - bc)
  inside = np.all(np.abs(local) < bsize, -1)
  assert inside[kind == 1].all() and inside[kind >= 4].all()
  assert not inside[(kind == 2) | (kind == 3)].any()
  axis = np.argmax(np.abs(np.einsum('bji,bj->bi', bmat, got[2].numpy())), -1)
  assert (axis[(kind == 4) | (kind == 6)] == 0).all()
  assert (axis[kind == 5] == 1).all()
  zero = np.linalg.norm(got[2].numpy(), axis=-1) == 0.0
  assert zero[(kind == 2) | (kind == 7)].all() and not zero[kind < 2].any()
  assert (got[0].numpy()[kind == 3] == 0.0).all()


# ---------------------------------------------------------------------------
# The five tasks: models, golden, MuJoCo
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def golden():
  path = os.path.join(registry.ASSETS, export.MANIPULATION_GOLDEN)
  with np.load(path) as z:
    return {k: z[k] for k in z.files}


@pytest.fixture(scope='module')
def specs():
  """name -> the port's spec on the CPU in float64."""
  return {n: registry.get_task(n, device='cpu', dtype=torch.float64)
          for n in TASKS}


@pytest.fixture(scope='module')
def mj_models():
  """name -> (MuJoCo's model, the port's model in float64 compiled from
  the same MJCF by the JAX package's put_model). The snapshots carry the
  JAX tasks' float32 constants, whose rounding (~1e-9 m in a geom size or
  body offset) would be measured against MuJoCo's float64 ones."""
  out = {}
  for name in TASKS:
    xml = export.manipulation_mjcf(name)
    jm, _ = load_model(xml_string=xml, dtype=jnp.float64)
    out[name] = (mujoco.MjModel.from_xml_string(xml), model_lib.from_arrays(
        *export.model_snapshot(jm), device='cpu', dtype=torch.float64))
  return out


def _sphere_box_pairs(m):
  return [(g1, g2) for g1, g2 in m.collision_pairs
          if (m.geom_type[g1], m.geom_type[g2]) == (GeomType.SPHERE,
                                                    GeomType.BOX)]


@pytest.mark.parametrize('name', TASKS)
def test_snapshots_are_current(name):
  """The task/ group: the JAX closures' site, body and mocap ids."""
  _check_snapshot(name)


@pytest.mark.parametrize('name', TASKS)
def test_contact_table_matches_jax(specs, golden, name):
  """Each pair's point count is the length of JAX's narrowphase output
  for it, and the condim-3 group's per-point parameters and bodies are
  JAX's _contact_groups' (the pair parameters mixed by JAX's rules)."""
  m = specs[name].model
  jm = export._f64(jregistry.get_task(name).model)
  g = export.task_inputs(golden, name)
  d = kin.kinematics(m, make_data(m).replace(qpos=_f64(g['qpos'][:1])))
  jd = jmake_data(jm, dtype=jnp.float64).replace(
      geom_xpos=jnp.asarray(d.geom_xpos[0].numpy()),
      geom_xmat=jnp.asarray(d.geom_xmat[0].numpy()))
  assert len(_sphere_box_pairs(m)) in (2, 4)
  for pair in m.collision_pairs:
    assert collision.points_per_pair(m, *pair) == len(
        jcollision.narrowphase(jm, jd, *pair))
    got, want = collision.pair_params(m, *pair), jcollision.pair_params(
        jm, *pair)
    assert got.condim == want.condim == 3
    for k in ('friction', 'solref', 'solimp', 'includemargin', 'invweight'):
      np.testing.assert_allclose(getattr(got, k).numpy(),
                                 np.asarray(getattr(want, k)), rtol=1e-12,
                                 atol=0, err_msg=k)
  (table,) = m.contact
  jg = jconstraint._Stacked(jconstraint._contact_groups(jm, jd)[0][3])
  assert table.condim == 3 and table.margin.shape[0] == jg.dist.shape[0]
  for k in ('margin', 'solref', 'solimp', 'mu', 'invw'):
    np.testing.assert_allclose(getattr(table, k).numpy(),
                               np.asarray(getattr(jg, k)), rtol=1e-12,
                               atol=0, err_msg=k)
  np.testing.assert_array_equal(table.b1, np.asarray(jg.b1))
  np.testing.assert_array_equal(table.b2, np.asarray(jg.b2))


@pytest.mark.parametrize('name', TASKS)
def test_sphere_box_points_match_mujoco(mj_models, golden, name):
  """At the golden's states with a fingertip against the object, the deep
  one included, every MuJoCo sphere-box contact is a port point of the
  same pair with the same depth, position and normal (MuJoCo's frame
  normal points from geom1, the sphere, to geom2, the box, as the port's
  flipped normal does; atol 1e-9), and every port point in contact is
  one of MuJoCo's."""
  mjm, m = mj_models[name]
  g = export.task_inputs(golden, name)
  mjd = mujoco.MjData(mjm)
  states = [*SHALLOW, DEEP]
  d = kin.kinematics(m, make_data(m, len(states)).replace(
      qpos=_f64(g['qpos'][states])))
  pairs = _sphere_box_pairs(m)
  for i, state in enumerate(states):
    mjd.qpos[:] = g['qpos'][state]
    mujoco.mj_forward(mjm, mjd)
    want = {(int(c.geom1), int(c.geom2)): c for c in mjd.contact[:mjd.ncon]
            if (int(c.geom1), int(c.geom2)) in pairs}
    assert want, f'state {state}: no fingertip against the object'
    for pair in pairs:
      (cp,) = collision.narrowphase(m, d, *pair)
      if pair not in want:
        assert float(cp.dist[i]) > 0, (state, pair)
        continue
      c = want[pair]
      np.testing.assert_allclose(float(cp.dist[i]), c.dist, atol=1e-9)
      np.testing.assert_allclose(cp.pos[i].numpy(), c.pos, atol=1e-9)
      np.testing.assert_allclose(cp.normal[i].numpy(), c.frame[:3],
                                 atol=1e-9)


@pytest.mark.parametrize('name', TASKS)
def test_step_matches_the_golden(specs, golden, name):
  """At the golden's four states: the condim-3 group's stacked points
  (plane-box corners, then each sphere-box point, in JAX's order), qacc
  and qfrc_constraint (rtol 1e-7, atol 1e-6: six to eight Newton
  iterations amplify ulps of the rows), the residual (1e-10), the next
  qvel (1e-7, qacc's through the timestep) and qpos (1e-8)."""
  spec = specs[name]
  g = export.task_inputs(golden, name)
  m = spec.model
  d = fwd.fwd_position(m, make_data(m, 4).replace(qpos=_f64(g['qpos'])))
  (s,) = constraint._contact_groups(m, d).values()
  for k, got in (('dist', s.dist), ('pos', s.pos3), ('normal', s.normal)):
    np.testing.assert_allclose(got.numpy(), g[k], rtol=0, atol=1e-10,
                               err_msg=k)
  assert (g['dist'][list(SHALLOW) + [DEEP]] < 0).any(-1).all()
  got = export.port_step(spec, g['qpos'], g['qvel'], g['ctrl'])
  for k in ('qacc', 'qfrc_constraint'):
    np.testing.assert_allclose(got[k], g[k], rtol=1e-7, atol=1e-6,
                               err_msg=k)
  np.testing.assert_allclose(got['residual'], g['residual'], rtol=0,
                             atol=1e-10)
  # qvel' = qvel + h qacc: qacc's tolerance times h <= 0.005 and more
  np.testing.assert_allclose(got['next_qvel'], g['next_qvel'], rtol=1e-7,
                             atol=1e-7)
  np.testing.assert_allclose(got['next_qpos'], g['next_qpos'], rtol=1e-8,
                             atol=1e-8)


class _Draw:
  """A generator stand-in carrying the numbers JAX's transition drew."""
  device = torch.device('cpu')

  def __init__(self, values):
    self.values = values


@pytest.mark.parametrize('branch', ['reached', 'not'])
@pytest.mark.parametrize('name', TASKS)
def test_transition_matches_the_golden(specs, golden, monkeypatch, name,
                                       branch):
  """On the golden's state 0 after kinematics, with the mocap poses of
  the branch: the goal moves to what JAX drew when reached (a uniform xy,
  Handover's x and y, or Reorient's z-only normal draw, handed to the
  port through torch.rand or torch.randn) and stays otherwise (atol
  1e-15); the params are returned unchanged."""
  spec = specs[name]
  m = spec.model
  g = export.task_inputs(golden, name)
  draw = g['transition/draw']
  lo, hi = {'FreeFingers': (-0.15, 0.15), 'Panda': (-0.45, 0.45),
            'Panda Bring': (-0.45, 0.45),
            'Bimanual Handover': (np.array([-0.25, -0.3]),
                                  np.array([0.25, 0.3]))}.get(name, (0, 1))
  unit = (draw - lo) / (hi - lo)
  rand, randn = torch.rand, torch.randn

  def drawn(real, values):
    def fn(shape, generator, **kw):
      if not isinstance(generator, _Draw):
        return real(shape, generator=generator, **kw)
      assert tuple(shape) == values.shape
      return _f64(values).to(kw['dtype'])
    return fn

  monkeypatch.setattr(torch, 'rand', drawn(rand, unit))
  monkeypatch.setattr(torch, 'randn', drawn(randn, draw))
  pre = f'transition/{branch}/'
  d = kin.kinematics(m, make_data(m).replace(
      qpos=_f64(g['qpos'][:1]), qvel=_f64(g['qvel'][:1]),
      mocap_pos=_f64(g[pre + 'mocap_pos'])[None],
      mocap_quat=_f64(g[pre + 'mocap_quat'])[None]))
  d2, p2 = spec.transition_fn(m, d, spec.default_params, _Draw(draw))
  assert p2 is spec.default_params
  for k in ('mocap_pos', 'mocap_quat'):
    np.testing.assert_allclose(getattr(d2, k)[0].numpy(), g[pre + 'next_' + k],
                               rtol=0, atol=1e-15, err_msg=k)
  moved = not (np.array_equal(d2.mocap_pos[0].numpy(), g[pre + 'mocap_pos'])
               and np.array_equal(d2.mocap_quat[0].numpy(),
                                  g[pre + 'mocap_quat']))
  assert moved == (branch == 'reached')


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


@pytest.mark.parametrize('name', TASKS)
def test_qacc_matches_mujoco(mj_models, golden, name):
  """The constrained qacc at the golden's states 0-2 (the box on the
  floor, fingertips pressing on it): both solvers run to convergence
  (100 iterations instead of the planning caps of 6-8), so both reach the
  one minimiser."""
  states = [0, *SHALLOW]
  mjm, m = mj_models[name]
  m = m.replace(opt=m.opt.replace(iterations=100))
  g = export.task_inputs(golden, name)
  got = fwd.forward(m, make_data(m, len(states)).replace(
      qpos=_f64(g['qpos'][states]), qvel=_f64(g['qvel'][states]),
      ctrl=_f64(g['ctrl'][states]))).qacc.numpy()
  mjm.opt.iterations = 100
  mjd = mujoco.MjData(mjm)
  for i, state in enumerate(states):
    mjd.qpos[:], mjd.qvel[:], mjd.ctrl[:] = (g[k][state] for k in (
        'qpos', 'qvel', 'ctrl'))
    mujoco.mj_forward(mjm, mjd)
    assert mjd.ncon > 0
    np.testing.assert_allclose(got[i], mjd.qacc, rtol=1e-5, atol=1e-6,
                               err_msg=f'state {state} ncon={mjd.ncon}')


def test_tasks_plan_without_jax_or_mujoco():
  """The five tasks load, take a transition and run a 4 x 3 Predictive
  Sampling plan through make_planner with nothing of JAX or mujoco
  importable, reaching both kernels' device dispatch (where a CUDA tensor
  launches them) at n and nv 12 / 15 / 18, B2 with its one condim-3
  group of P 10 or 12: B1 twice and B2 once a rollout step."""
  proc = _run(BLOCK + (
      "import torch\n"
      "from mujoco_mpc_tpu_torch.ops import newton, spd_solve\n"
      "from mujoco_mpc_tpu_torch.physics import forward\n"
      "from mujoco_mpc_tpu_torch.physics.model import make_data\n"
      "from mujoco_mpc_tpu_torch.planners import registry as planners\n"
      "from mujoco_mpc_tpu_torch.tasks import registry\n"
      "calls = []\n"
      "solve, newt = spd_solve._solve, newton._newton\n"
      "def rec_solve(a, b):\n"
      "  calls.append(('chol_solve', b.shape[1]))\n"
      "  return solve(a, b)\n"
      "def rec_newton(*args, **kw):\n"
      "  calls.append(('newton', args[1].shape[1], args[11].shape[1]))\n"
      "  return newt(*args, **kw)\n"
      "spd_solve._solve, newton._newton = rec_solve, rec_newton\n"
      "for name in ('FreeFingers', 'Panda', 'Panda Bring',\n"
      "             'Bimanual Handover', 'Bimanual Reorient'):\n"
      "  spec = registry.get_task(name, device='cpu')\n"
      "  m, p = spec.model, spec.default_params\n"
      "  d = forward.forward(m, make_data(m))\n"
      "  d, p = spec.transition_fn(m, d, p, torch.Generator())\n"
      "  plan = planners.make_planner(spec, planners.SAMPLING, 4, 3, 3)\n"
      "  calls.clear()\n"
      "  _, info = plan.optimize(plan.init(), d, p, torch.Generator())\n"
      "  print(name.replace(' ', '_'), sorted(set(calls)) ==\n"
      "        sorted(set(calls[:2])), len(calls), calls[:2],\n"
      "        int(bool(torch.isfinite(info['best_return']))))\n"))
  assert proc.returncode == 0, proc.stderr
  lines = proc.stdout.strip().splitlines()
  want = {'FreeFingers': (12, 10), 'Panda': (15, 10), 'Panda_Bring': (15, 10),
          'Bimanual_Handover': (18, 12), 'Bimanual_Reorient': (18, 12)}
  assert len(lines) == 5
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
  outputs recomputed live from the file's inputs (five JAX step compiles,
  minutes)."""
  for name in TASKS:
    want = export.jax_manipulation_golden(name,
                                          export.task_inputs(golden, name))
    for k, v in want.items():
      np.testing.assert_allclose(v, golden[k], rtol=1e-10, atol=1e-12,
                                 err_msg=k)
