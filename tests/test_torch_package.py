"""Package-level checks of the PyTorch port.

* Every module of mujoco_mpc_tpu_torch imports, and the Cartpole,
  Quadruped Flat, Humanoid Track, Shadow Reorient, Particle and Swimmer
  tasks load and step (Particle and Swimmer through an iLQG iteration),
  with jax, flax, mujoco and the JAX package blocked: the GPU machine has
  none of them.
* Entry points build on the card unless asked for the CPU: without a card
  the default raises.
* chip_smoke.py refuses to run without a card and prints no result.
* The committed model snapshots match a fresh export from the JAX tasks.
* The kernel wrappers raise, never fall back to the plain version, on a
  non-CPU request the kernel cannot take, malformed contact groups
  included; on a request they take, the primal and the tangent
  (torch.func.jvp, and vmap of jvp as one launch) go to the kernels.
* Every planner's iteration reaches both kernels' device dispatch (where
  a CUDA tensor launches the kernel) at the batches its rollouts and its
  derivative pass run, as often as chip_smoke.py expects on the card.
"""

import collections
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from mujoco_mpc_tpu.tasks import registry as jregistry
from mujoco_mpc_tpu_torch import convert
from mujoco_mpc_tpu_torch.ops import cuda_build
from mujoco_mpc_tpu_torch.ops import linalg
from mujoco_mpc_tpu_torch.ops import newton
from mujoco_mpc_tpu_torch.ops import spd_solve
from mujoco_mpc_tpu_torch.physics.model import make_data
from mujoco_mpc_tpu_torch.planners import registry as planners
from mujoco_mpc_tpu_torch.tasks import registry
from tools import export_torch_snapshot as export

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the planner layer's modules, and the entry points over it
NEW_MODULES = ('planners.cross_entropy', 'planners.sample_gradient',
               'planners.ranked', 'planners.robust',
               'planners.gradient_planner', 'planners.ilqs', 'testspeed')
BLOCK = ("import sys\n"
         "for name in ('jax', 'jaxlib', 'flax', 'mujoco', 'mujoco_mpc_tpu'):\n"
         "  sys.modules[name] = None\n")


def _run(code, cwd=ROOT, args=()):
  env = dict(os.environ, PYTHONPATH=ROOT if cwd == ROOT else '')
  return subprocess.run([sys.executable, *args] + (['-c', code] if code
                                                   else []),
                        cwd=cwd, env=env, capture_output=True, text=True,
                        timeout=300, check=False)


def test_port_imports_without_jax_or_mujoco():
  proc = _run(BLOCK + (
      "import importlib, pkgutil\n"
      "import mujoco_mpc_tpu_torch as pkg\n"
      "names = [m.name for m in pkgutil.walk_packages(pkg.__path__,\n"
      "                                               pkg.__name__ + '.')]\n"
      "for n in names:\n"
      "  importlib.import_module(n)\n"
      "from mujoco_mpc_tpu_torch.tasks import registry\n"
      "spec = registry.get_task('Cartpole', device='cpu')\n"
      "print(len(names), spec.model.nv, *names)\n"))
  assert proc.returncode == 0, proc.stderr
  count, nv, *names = proc.stdout.split()
  assert int(count) >= 20 and int(nv) == 2
  for mod in NEW_MODULES:
    assert 'mujoco_mpc_tpu_torch.' + mod in names, mod


def test_quadruped_loads_without_jax_or_mujoco():
  proc = _run(BLOCK + (
      "import torch\n"
      "from mujoco_mpc_tpu_torch.physics import forward\n"
      "from mujoco_mpc_tpu_torch.physics.model import make_data\n"
      "from mujoco_mpc_tpu_torch.tasks import registry\n"
      "spec = registry.get_task('Quadruped Flat', device='cpu')\n"
      "m = spec.model\n"
      "d = forward.forward(m, make_data(m).replace(\n"
      "    qpos=m.keyframe_qpos('home')[None]))\n"
      "r = spec.residual_fn(m, d, spec.default_params.residual_params)\n"
      "print(m.nv, len(m.collision_pairs), r.shape[1],\n"
      "      int(torch.isfinite(d.qacc).all()))\n"))
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.split() == ['18', '9', '42', '1']


def test_humanoid_track_steps_without_jax_or_mujoco():
  """The Track clip travels in the snapshot: the task loads and one CPU
  step runs its residual, cost and transition with nothing of JAX or
  mujoco importable."""
  proc = _run(BLOCK + (
      "import torch\n"
      "from mujoco_mpc_tpu_torch.physics import forward\n"
      "from mujoco_mpc_tpu_torch.physics.model import make_data\n"
      "from mujoco_mpc_tpu_torch.tasks import registry\n"
      "spec = registry.get_task('Humanoid Track', device='cpu')\n"
      "m, p = spec.model, spec.default_params\n"
      "d = make_data(m).replace(qpos=m.keyframe_qpos('home')[None])\n"
      "d, p = spec.transition_fn(m, d, p, torch.Generator())\n"
      "d = forward.forward(m, d)\n"
      "c = spec.cost(spec.residual_fn(m, d, p.residual_params), p)\n"
      "d = forward.integrate(m, d)\n"
      "print(m.nv, len(m.collision_pairs), spec.num_residual,\n"
      "      int(torch.isfinite(c).all() and torch.isfinite(d.qpos).all()))\n"))
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.split() == ['23', '7', '109', '1']


def test_shadow_reorient_steps_without_jax_or_mujoco():
  """The cube's hull travels in the snapshot: the task loads and one CPU
  step from the cube lowered onto the palm runs its contacts, residual,
  cost and transition with nothing of JAX or mujoco importable."""
  proc = _run(BLOCK + (
      "import torch\n"
      "from mujoco_mpc_tpu_torch.physics import forward\n"
      "from mujoco_mpc_tpu_torch.physics.model import make_data\n"
      "from mujoco_mpc_tpu_torch.tasks import registry\n"
      "spec = registry.get_task('Shadow Reorient', device='cpu')\n"
      "m, p = spec.model, spec.default_params\n"
      "q = m.qpos0.clone()\n"
      "q[2] -= 0.025\n"
      "d = forward.forward(m, make_data(m).replace(qpos=q[None]))\n"
      "d, p = spec.transition_fn(m, d, p, torch.Generator())\n"
      "c = spec.cost(spec.residual_fn(m, d, p.residual_params), p)\n"
      "d = forward.integrate(m, d)\n"
      "print(m.nv, len(m.collision_pairs), sorted(m.geom_mesh),\n"
      "      spec.num_residual, int(torch.isfinite(c).all()\n"
      "      and torch.isfinite(d.qpos).all()))\n"))
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.split() == ['21', '32', '[2]', '27', '1']


def test_particle_and_swimmer_plan_without_jax_or_mujoco():
  """Particle (Euler, limit rows) and Swimmer (fluid drag, the implicit
  integrator) load, take a transition and run one iLQG iteration through
  make_planner, derivatives included, on the CPU."""
  proc = _run(BLOCK + (
      "import torch\n"
      "from mujoco_mpc_tpu_torch.physics import forward\n"
      "from mujoco_mpc_tpu_torch.physics.model import make_data\n"
      "from mujoco_mpc_tpu_torch.planners import registry as planners\n"
      "from mujoco_mpc_tpu_torch.tasks import registry\n"
      "out = []\n"
      "for name in ('Particle', 'Swimmer'):\n"
      "  spec = registry.get_task(name, device='cpu')\n"
      "  m, p = spec.model, spec.default_params\n"
      "  d = forward.forward(m, make_data(m))\n"
      "  d, p = spec.transition_fn(m, d, p, torch.Generator())\n"
      "  plan = planners.make_planner(spec, planners.ILQG, 3, 4, 3)\n"
      "  state, info = plan.optimize(plan.init(), d, p, None)\n"
      "  d = forward.step(m, d.replace(ctrl=plan.action(\n"
      "      state, d.qpos, d.qvel, d.act, d.time)))\n"
      "  out += [m.nv, int(bool(info['backward_pass_ok'])\n"
      "                    and torch.isfinite(d.qpos).all())]\n"
      "print(*out)\n"))
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.split() == ['2', '1', '8', '1']


def test_get_task_defaults_to_the_card():
  """No quiet CPU fallback: the default device is CUDA, and without a
  card asking for it raises."""
  registry.get_task.cache_clear()
  if torch.cuda.is_available():
    assert registry.get_task('Quadruped Flat').model.device.type == 'cuda'
  else:
    for name in registry.task_names():
      with pytest.raises(RuntimeError, match='no CUDA device'):
        registry.get_task(name)
    with pytest.raises(RuntimeError, match='no CUDA device'):
      convert.params_from_arrays({k: np.zeros(1) for k in
                                  convert.PARAM_FIELDS})


def test_chip_smoke_fails_without_a_card(tmp_path):
  """Without CUDA, and alone in a directory, chip_smoke.py exits non-zero
  and prints no result line."""
  for cwd in (ROOT, str(tmp_path)):
    if cwd != ROOT:
      shutil.copy(os.path.join(ROOT, 'chip_smoke.py'), cwd)
    proc = _run(None, cwd=cwd, args=('chip_smoke.py',))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def _check_snapshot(name):
  arrays, static = export.task_snapshot(jregistry.get_task(name))
  fname, _ = registry.TASKS[name]
  c_arrays, c_static = convert.load_snapshot(
      os.path.join(registry.ASSETS, fname))
  hint = 'stale snapshot: run python tools/export_torch_snapshot.py'
  assert sorted(arrays) == sorted(c_arrays), hint
  for k, v in arrays.items():
    assert v.dtype == c_arrays[k].dtype, (k, hint)
    np.testing.assert_array_equal(v, c_arrays[k], err_msg=f'{k}: {hint}')
  assert static == c_static, hint


def test_snapshot_is_current():
  _check_snapshot('Cartpole')


def test_quadruped_snapshot_is_current():
  _check_snapshot('Quadruped Flat')


@pytest.mark.parametrize('name', ['Humanoid Track', 'Humanoid Stand',
                                  'Humanoid Walk'])
def test_humanoid_snapshots_are_current(name):
  """Track's clip arrays ('task/markers', 'task/starts', 'task/lengths')
  included."""
  _check_snapshot(name)


def test_shadow_snapshot_is_current():
  """The cube's hull tables ('model/geom_mesh/2/verts', '.../normals',
  '.../offsets', float32 as JAX holds them) included."""
  _check_snapshot('Shadow Reorient')


@pytest.mark.parametrize('name', ['Particle', 'ParticleFixed', 'Swimmer'])
def test_ilqg_task_snapshots_are_current(name):
  _check_snapshot(name)


def test_port_uses_no_compiler_or_jit():
  pkg = os.path.join(ROOT, 'mujoco_mpc_tpu_torch')
  for dirpath, _, files in os.walk(pkg):
    for f in files:
      if f.endswith('.py'):
        with open(os.path.join(dirpath, f)) as fh:
          src = fh.read()
        for banned in ('torch.compile', 'torch.jit', 'import jax',
                       'import flax'):
          assert banned not in src, (f, banned)


def test_kernels_are_built_for_hopper():
  assert 'arch=compute_90a,code=sm_90a' in cuda_build.NVCC_FLAGS
  for name, entry in (('chol_solve', 'mjpc_chol_solve_f32'),
                      ('newton', 'mjpc_newton_f32'),
                      ('newton', 'mjpc_newton_blocks_per_sm')):
    with open(os.path.join(cuda_build.CSRC, name + '.cu')) as f:
      assert f'extern "C" int {entry}(' in f.read()


@pytest.fixture
def no_plain(monkeypatch):
  """Fail if a wrapper reaches its plain version, and let `meta` tensors
  stand in for CUDA ones (there is no card here)."""
  def boom(*a, **k):
    raise AssertionError('fell back to the plain version')
  monkeypatch.setattr(spd_solve.linalg, 'solve_spd', boom)
  monkeypatch.setattr(newton, 'newton_reference', boom)

  def as_cuda(*tensors):
    for t in tensors:
      if t.device.type != 'meta':
        raise ValueError(f'expected a CUDA tensor, got one on {t.device}')
  monkeypatch.setattr(cuda_build, 'require_cuda', as_cuda)


def _meta(*shape, dtype=torch.float32):
  return torch.empty(shape, dtype=dtype, device='meta')


def _newton_args(bsz=4, nv=3, n=2, ns=2, dtype=torch.float32,
                 dof_dtype=torch.int32):
  return (_meta(bsz, nv, nv, dtype=dtype), _meta(bsz, nv, dtype=dtype),
          _meta(bsz, n, nv, dtype=dtype), _meta(bsz, n, dtype=dtype),
          _meta(bsz, n, dtype=dtype), _meta(bsz, n, dtype=dtype),
          _meta(bsz, ns, dtype=dtype), _meta(bsz, ns, dtype=dtype),
          _meta(ns, dtype=dof_dtype), _meta(ns, dtype=dtype))


def _group_args(bsz=4, nv=3, condim=3, p=5):
  """(cdofc, g, aref, dvec, mu) and the dmask of one well-formed group."""
  nrep = {1: 1, 3: 4, 4: 6, 6: 10}[condim]
  return ((_meta(bsz, nv, 6), _meta(bsz, p, condim, 6),
           _meta(bsz, nrep, p), _meta(bsz, p), _meta(bsz, 3, p)),
          _meta(p, nv))


def _malformed(case):
  """(group operands, condims, dmasks) broken in one way."""
  gargs, dmask = _group_args()
  if case == 'missing_operand':
    return gargs[:-1], (3,), (dmask,)
  if case == 'missing_dmask':
    return gargs, (3,), ()
  if case == 'bad_condim':
    return gargs, (2,), (dmask,)
  if case == 'two_groups_one_condim':
    return gargs + gargs[1:], (3, 3), (dmask, dmask)
  if case == 'wrong_facet_count':
    return gargs[:2] + (_meta(4, 6, 5),) + gargs[3:], (3,), (dmask,)
  if case == 'wrong_dmask_shape':
    return gargs, (3,), (_meta(5, 4),)
  if case == 'wrong_cdofc':
    return (_meta(4, 3, 3),) + gargs[1:], (3,), (dmask,)
  if case == 'float64':
    return gargs[:4] + (_meta(4, 3, 5, dtype=torch.float64),), (3,), (dmask,)
  raise ValueError(case)


@pytest.mark.parametrize('args,error', [
    ((_meta(8, 3, 3, dtype=torch.float64), _meta(8, 3, dtype=torch.float64)),
     TypeError),
    ((_meta(8, 3, 3, dtype=torch.float16), _meta(8, 3, dtype=torch.float16)),
     TypeError),
    ((_meta(8, 0, 0), _meta(8, 0)), ValueError),
    ((_meta(8, 33, 33), _meta(8, 33)), ValueError),
    ((_meta(8, 3, 3), _meta(8, 4)), ValueError),
    ((_meta(8, 3, 3).transpose(1, 2), _meta(8, 3)), ValueError),
    ((_meta(8, 3, 3), _meta(8, 6)[:, ::2]), ValueError),
    ((torch.zeros(8, 3, 3), _meta(8, 3)), ValueError),
])
def test_spd_wrapper_refuses(no_plain, monkeypatch, args, error):
  """What the kernel cannot take is refused before nvcc is reached."""
  built = []
  monkeypatch.setattr(cuda_build, 'load', built.append)
  spd_solve._entry.cache_clear()
  with pytest.raises(error):
    spd_solve.solve_spd(*args)
  assert built == []


@pytest.mark.parametrize('kwargs,error', [
    (dict(dtype=torch.float64), TypeError),
    (dict(dof_dtype=torch.int64), TypeError),
    (dict(nv=33), ValueError),
])
def test_newton_wrapper_refuses(no_plain, kwargs, error):
  with pytest.raises(error):
    newton.newton(*_newton_args(**kwargs), cap=8, tol=1e-5)


def test_newton_wrapper_refuses_groups_and_mixed_devices(no_plain):
  """Malformed contact-group operands and operands on two devices."""
  args = _newton_args()
  with pytest.raises(ValueError):       # group operands without condims
    newton.newton(*args, _meta(4, 3, 6), cap=8, tol=1e-5)
  gargs, dmask = _group_args()
  with pytest.raises(ValueError):       # a group on another device
    newton.newton(*args, *gargs[:4], torch.zeros(4, 3, 5), cap=8, tol=1e-5,
                  condims=(3,), dmasks=(dmask,))
  mixed = (torch.zeros(4, 3, 3),) + args[1:]
  with pytest.raises(ValueError):
    newton.newton(*mixed, cap=8, tol=1e-5)


@pytest.mark.parametrize('case', [
    'missing_operand', 'missing_dmask', 'bad_condim', 'two_groups_one_condim',
    'wrong_facet_count', 'wrong_dmask_shape', 'wrong_cdofc', 'float64'])
def test_newton_wrapper_refuses_malformed_groups(no_plain, case):
  gargs, condims, dmasks = _malformed(case)
  error = TypeError if case == 'float64' else ValueError
  with pytest.raises(error):
    newton.newton(*_newton_args(), *gargs, cap=8, tol=1e-5,
                  condims=condims, dmasks=dmasks)


def test_wrappers_go_to_the_kernel_not_the_plain_version(no_plain,
                                                         monkeypatch):
  """A request the kernel takes goes on to build and launch it; here the
  build stops (no nvcc) and the plain version is never called."""
  calls = []

  def no_build(name):
    calls.append(name)
    raise RuntimeError('no nvcc here')
  monkeypatch.setattr(cuda_build, 'load', no_build)
  spd_solve._entry.cache_clear()
  newton._entry.cache_clear()
  with pytest.raises(RuntimeError, match='no nvcc'):
    spd_solve.solve_spd(_meta(8, 3, 3), _meta(8, 3))
  with pytest.raises(RuntimeError, match='no nvcc'):
    newton.newton(*_newton_args(), cap=8, tol=1e-5)
  assert calls == ['chol_solve', 'newton']


def test_tangents_go_to_the_kernels_not_the_plain_version(no_plain,
                                                          monkeypatch):
  """torch.func.jvp through both Functions launches the kernels for the
  primal and the tangent; vmap of jvp launches each once for all its
  directions (B1 at B * D), never the plain version."""
  launches = []

  def load(name):
    """A built library stand-in: each entry point records the batch it
    was launched at (its fourth or fourteenth argument) and succeeds."""
    def entry(batch_arg):
      return lambda *args: launches.append((name, args[batch_arg])) or 0
    return types.SimpleNamespace(mjpc_chol_solve_f32=entry(3),
                                 mjpc_newton_f32=entry(13))
  monkeypatch.setattr(cuda_build, 'load', load)
  monkeypatch.setattr(torch.cuda, 'current_stream', lambda device=None: (
      type('Stream', (), {'cuda_stream': 0})()))
  spd_solve._entry.cache_clear()
  newton._entry.cache_clear()
  a, b = _meta(8, 3, 3), _meta(8, 3)
  torch.func.jvp(spd_solve.solve_spd, (a, b), (_meta(8, 3, 3), _meta(8, 3)))
  assert launches == [('chol_solve', 8), ('chol_solve', 8)]
  launches.clear()
  torch.func.vmap(lambda v: torch.func.jvp(
      spd_solve.solve_spd, (a, b), (torch.zeros_like(a), v))[1])(
          _meta(5, 8, 3))
  assert launches == [('chol_solve', 8), ('chol_solve', 40)]

  args = _newton_args()
  gargs, dmask = _group_args()
  primals = args[:8] + args[10:] + gargs

  def f(*x):
    return newton.newton(*x[:8], *args[8:10], *x[8:], cap=8, tol=1e-5,
                         condims=(3,), dmasks=(dmask,))
  launches.clear()
  torch.func.jvp(f, primals, tuple(torch.zeros_like(x) for x in primals))
  assert launches == [('newton', 4), ('chol_solve', 4)]
  launches.clear()
  torch.func.vmap(lambda *t: torch.func.jvp(f, primals, t)[1])(
      *(_meta(6, *x.shape) for x in primals))
  assert launches == [('newton', 4), ('chol_solve', 24)]
  spd_solve._entry.cache_clear()
  newton._entry.cache_clear()


def test_newton_wrapper_takes_groups_to_the_kernel(no_plain, monkeypatch):
  """Well-formed contact groups (two, of condims 1 and 6) pass the checks
  and go on to the kernel: no facet expansion, no plain version."""
  calls = []

  def no_build(name):
    calls.append(name)
    raise RuntimeError('no nvcc here')
  monkeypatch.setattr(cuda_build, 'load', no_build)
  monkeypatch.setattr(newton, 'expand_group', no_plain_expand)
  newton._entry.cache_clear()
  g1, m1 = _group_args(condim=1, p=2)
  g6, m6 = _group_args(condim=6, p=3)
  with pytest.raises(RuntimeError, match='no nvcc'):
    newton.newton(*_newton_args(), *g1, *g6[1:], cap=8, tol=1e-5,
                  condims=(1, 6), dmasks=(m1, m6))
  assert calls == ['newton']


def no_plain_expand(*a, **k):
  raise AssertionError('expanded the facets in PyTorch')


def _rollout(t_steps, bsz):
  """The dispatches of one rollout of t_steps at batch bsz on Cartpole
  (Euler): B1 for qacc_smooth and the damping system, B2 once, a step."""
  return {('chol_solve', bsz): 2 * t_steps, ('newton', bsz): t_steps}


def _derivative_pass(t_steps, dirs):
  """The transition's step at B T - 1 (two B1 systems, primal and
  tangent, B2's primal and its tangent's B1) and the cost's forward at
  B T (qacc_smooth's primal and tangent, B2's primal and its tangent's
  B1), the tangents at B * D."""
  t1 = t_steps - 1
  return {('chol_solve', t1): 2, ('chol_solve', t1 * dirs): 3,
          ('newton', t1): 1, ('chol_solve', t_steps): 1,
          ('chol_solve', t_steps * dirs): 2, ('newton', t_steps): 1}


def _sum(*counts):
  out = collections.Counter()
  for c in counts:
    out.update(c)
  return dict(out)


@pytest.mark.parametrize('planner_id', [
    planners.GRADIENT, planners.ILQS, planners.ROBUST, planners.CEM,
    planners.SAMPLE_GRADIENT])
def test_planners_reach_the_kernels_dispatch(monkeypatch, planner_id):
  """One iteration of each new planner on Cartpole (T 4, K 8): every
  rollout step, the Robust re-rollouts and the derivative pass's primal
  and tangent solves go through the kernels' dispatch (recorded here,
  computed by the plain versions on the CPU)."""
  calls = []
  monkeypatch.setattr(spd_solve, '_solve', lambda a, b: calls.append(
      ('chol_solve', b.shape[0])) or linalg.solve_spd(a, b))
  monkeypatch.setattr(newton, '_newton', lambda *a, **k: calls.append(
      ('newton', a[1].shape[0])) or newton.newton_reference(*a, **k))
  spec = registry.get_task('Cartpole', device='cpu')
  t_steps, k = 4, 8
  plan = planners.make_planner(spec, planner_id, k, t_steps, 3)
  d0 = make_data(spec.model).replace(qpos=torch.tensor([[0.5, 3.0]]))
  _, info = plan.optimize(plan.init(), d0, spec.default_params,
                          torch.Generator().manual_seed(0))
  assert torch.isfinite(info['best_return'])
  deriv = _derivative_pass(t_steps, 2 * spec.model.nv + spec.model.nu)
  if planner_id in (planners.CEM, planners.SAMPLE_GRADIENT):
    want = _rollout(t_steps, k)
  elif planner_id == planners.ROBUST:
    # the Sampling delegate's K + 1, then min(12, K) x 5 re-rollouts
    want = _sum(_rollout(t_steps, k + 1), _rollout(t_steps, k * 5))
  elif planner_id == planners.GRADIENT:
    want = _sum(_rollout(t_steps, 1), deriv, _rollout(t_steps, k))
  else:
    # sampling, the seeded nominal, and eager iLQG at max(K // 4, 4)
    # unless sampling improved
    want = _sum(_rollout(t_steps, k + 1), _rollout(t_steps, 1),
                {} if bool(info['sampling_improved']) else _sum(
                    _rollout(t_steps, 1), deriv, _rollout(t_steps, 4)))
  assert dict(collections.Counter(calls)) == want
