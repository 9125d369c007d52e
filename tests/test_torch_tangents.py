"""The tangent of B2's Function, and Cartpole's iLQG, against JAX, float64.

* ops/newton.NewtonSolve's jvp against jax.jvp of pallas_newton.make_newton
  on problems with dense rows, one-hot rows and contact groups (condim 3,
  and 3 with 6), built away from ties (|jar| > 1e-6 at the solution); its
  vmap rules (of the jvp over directions, and over problems).
* Cartpole from its cart past the slider limit, so that the limit rows and
  B2's tangent are live in every step: the exact derivatives at T 4, and
  ilqg.optimize, two pipelined iterations then one eager, at T 6 with 4
  candidates, against JAX (helpers in tests/test_torch_ilqg.py; JAX's
  iterations replayed from assets/cartpole_ilqg_optimize_golden.npz, made
  live by the slow test_optimize_golden_is_jaxs).

The CPU runs B2's plain version through the same Function, so its jvp and
vmap rules are exercised here; the kernel itself is held against the
plain version on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jvp, vmap

from mujoco_mpc_tpu.ops import pallas_newton
from mujoco_mpc_tpu_torch.ops import newton
from tests.test_torch_ilqg import (F64, _rel, check_derivatives, check_optimize,
                                   jax_optimize)
from tests.test_torch_newton import _cone_empty, _group_problem

torch.set_num_threads(1)


# name -> (groups ((condim, P), ...), dof, sign); nv 6, n 3, ns 2, B 8
NEWTON_CASES = {
    'dense_and_scalar': ((), (0, 5), (1.0, -1.0)),
    'condim3_group': (((3, 3),), (0, 5), (1.0, -1.0)),
    'two_groups': (((3, 3), (6, 2)), (2, 3), (1.0, 1.0)),
}


def _newton_port(base, gargs, dmasks, groups, dof, sign):
  def f(*a):
    return newton.newton(
        *a[:8], torch.tensor(dof, dtype=torch.int32),
        torch.tensor(sign, dtype=F64), *a[8:], cap=60, tol=1e-13,
        condims=tuple(c for c, _ in groups),
        dmasks=tuple(torch.from_numpy(x) for x in dmasks))
  return f, tuple(torch.from_numpy(x) for x in base + gargs)


def _newton_tangents(rng, base, gargs):
  tb = [rng.normal(size=x.shape) for x in base]
  tb[0] = tb[0] + np.transpose(tb[0], (0, 2, 1))
  tb[5] = np.zeros_like(tb[5])           # eqf is a flag
  return tb + [rng.normal(size=x.shape) for x in gargs]


@pytest.mark.parametrize('case', sorted(NEWTON_CASES))
def test_newton_function_jvp_matches_jax(case):
  groups, dof, sign = NEWTON_CASES[case]
  base, gargs, dmasks = _group_problem(11, 8, 6, 3, 2, groups, np.float64)
  tangents = _newton_tangents(np.random.default_rng(5), base, gargs)
  f, primals = _newton_port(base, gargs, dmasks, groups, dof, sign)
  out, dout = jvp(f, primals, tuple(torch.from_numpy(t) for t in tangents))
  # the construction stays away from the active set's ties
  assert min(float(o.abs().min()) for o in out[1:]) > 1e-6

  fn = pallas_newton.make_newton(
      dof, sign, 60, 1e-13, (), tuple(c for c, _ in groups),
      tuple(d.astype(np.float32).tobytes() for d in dmasks))
  cone = _cone_empty(8, 6, jnp.float64)
  p = (tuple(jnp.asarray(x) for x in base) + cone
       + tuple(jnp.asarray(x) for x in gargs))
  t = (tuple(jnp.asarray(x) for x in tangents[:8])
       + tuple(jnp.zeros_like(c) for c in cone)
       + tuple(jnp.asarray(x) for x in tangents[8:]))
  wp, wt = jax.vmap(lambda p, t: jax.jvp(fn, p, t))(p, t)
  for name, g, w in zip(('qacc', 'jar_d', 'jar_s', 'jar_g0', 'jar_g1'),
                        dout, wt[:3] + wt[5:]):
    _rel(g, w, 1e-8, 'd' + name)
  for name, g, w in zip(('qacc', 'jar_d'), out, wp):
    _rel(g, w, 1e-8, name)


def test_newton_function_vmap_rules():
  """vmap of the jvp over directions equals the loop, and vmap over
  problems equals one call on the stacked batch."""
  groups, dof, sign = NEWTON_CASES['condim3_group']
  base, gargs, dmasks = _group_problem(12, 8, 6, 3, 2, groups, np.float64)
  rng = np.random.default_rng(6)
  f, primals = _newton_port(base, gargs, dmasks, groups, dof, sign)
  dirs = [_newton_tangents(rng, base, gargs) for _ in range(3)]
  stacked = tuple(torch.from_numpy(np.stack(x)) for x in zip(*dirs))
  got = vmap(lambda *t: jvp(f, primals, t)[1])(*stacked)
  for k in range(3):
    want = jvp(f, primals, tuple(torch.from_numpy(t) for t in dirs[k]))[1]
    for g, w in zip(got, want):
      _rel(g[k], w, 1e-12, 'vmap(jvp)')

  halves = tuple(p.reshape(2, 4, *p.shape[1:]) for p in primals)
  got = vmap(f)(*halves)
  want = f(*primals)
  for g, w in zip(got, want):
    _rel(g.reshape(w.shape), w, 1e-12, 'vmap')




def test_cartpole_derivatives_match_jax():
  traj = check_derivatives('Cartpole')
  # the slider limit row is active along the trajectory
  assert float(traj.qpos[:, 0].abs().max()) > 1.8


def test_cartpole_optimize_matches_jax():
  check_optimize('Cartpole')


@pytest.mark.slow
def test_optimize_golden_is_jaxs():
  """The recorded calls of JAX's iLQG optimize on Cartpole are what the
  JAX package computes now."""
  jax_optimize('Cartpole').check_live()
