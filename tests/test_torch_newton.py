"""The port's plain Newton solve (kernel B2's plain version) against JAX.

mujoco_mpc_tpu_torch/ops/newton.newton_reference is held against the JAX
reference loop (vmapped pallas_newton._newton_reference) in float64, and
against the fused Pallas kernel it stands for (newton_batched in interpret
mode) in float32, on the synthetic problem of tests/test_pallas_newton.py
regenerated with numpy, and on Cartpole-shaped inputs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu.ops import pallas_newton
from mujoco_mpc_tpu_torch.ops import newton

torch.set_num_threads(1)


def _synthetic_problem(seed, bsz, nv, n, ns, dtype):
  """(qm, qs, j, aref, dvec, eqf, s_aref, s_dvec) as numpy arrays."""
  rng = np.random.default_rng(seed)
  softplus = lambda x: np.log1p(np.exp(x))  # noqa: E731
  a = rng.normal(size=(bsz, nv, nv))
  qm = a @ np.transpose(a, (0, 2, 1)) + 2.0 * np.eye(nv)
  out = (qm, rng.normal(size=(bsz, nv)), rng.normal(size=(bsz, n, nv)),
         rng.normal(size=(bsz, n)), softplus(rng.normal(size=(bsz, n))),
         (rng.uniform(size=(bsz, n)) < 0.2).astype(np.float64),
         rng.normal(size=(bsz, ns)), softplus(rng.normal(size=(bsz, ns))))
  return tuple(x.astype(dtype) for x in out)


def _cartpole_problem(seed, bsz, dtype):
  """Cartpole-shaped limit solve: nv 2, no dense rows, the slider's two
  limit rows on dof 0 with some samples past each side (jar < 0)."""
  rng = np.random.default_rng(seed)
  l = np.tril(rng.uniform(0.1, 1.0, size=(bsz, 2, 2)))
  qm = l @ np.transpose(l, (0, 2, 1)) + 0.05 * np.eye(2)
  qs = rng.normal(scale=20.0, size=(bsz, 2))
  s_aref = rng.normal(scale=20.0, size=(bsz, 2))
  s_dvec = np.where(rng.uniform(size=(bsz, 2)) < 0.5,
                    rng.uniform(1.0, 50.0, size=(bsz, 2)), 0.0)
  z = np.zeros((bsz, 0))
  out = (qm, qs, np.zeros((bsz, 0, 2)), z, z, z, s_aref, s_dvec)
  return tuple(x.astype(dtype) for x in out)


# name -> (problem factory, dof, sign, cap, tol)
CASES = {
    'dense_and_scalar': (functools.partial(_synthetic_problem, 0, 16, 7, 12,
                                           4), (0, 2, 0, 2),
                         (1.0, 1.0, -1.0, -1.0), 30, 1e-6),
    'dense_only': (functools.partial(_synthetic_problem, 1, 16, 5, 9, 0),
                   (), (), 30, 1e-6),
    'scalar_only': (functools.partial(_synthetic_problem, 2, 16, 4, 0, 3),
                    (1, 3, 1), (1.0, 1.0, -1.0), 30, 1e-6),
    'ragged_batch': (functools.partial(_synthetic_problem, 3, 13, 4, 6, 2),
                     (1, 3), (1.0, -1.0), 30, 1e-6),
    'cartpole_shaped': (functools.partial(_cartpole_problem, 4, 16), (0, 0),
                        (1.0, -1.0), 8, 1e-5),
}


def _port(args, dof, sign, cap, tol):
  t = [torch.from_numpy(x) for x in args]
  out = newton.newton_reference(
      *t, torch.tensor(dof, dtype=torch.int32),
      torch.tensor(sign, dtype=t[1].dtype), cap=cap, tol=tol)
  return [x.numpy() for x in out]


def _cone_empty(bsz, nv, dtype):
  return (jnp.zeros((bsz, 0, 6, nv), dtype), jnp.zeros((bsz, 0, 6), dtype),
          jnp.zeros((bsz, 0), dtype), jnp.zeros((bsz, 0, 5), dtype),
          jnp.zeros((bsz, 0), dtype), jnp.zeros((bsz, 0), dtype),
          jnp.zeros((bsz, 0), dtype), jnp.zeros((bsz, 0), dtype))


@pytest.mark.parametrize('case', sorted(CASES))
def test_plain_newton_matches_jax_reference_loop_f64(case):
  build, dof, sign, cap, tol = CASES[case]
  args = build(np.float64)
  bsz, nv = args[1].shape
  got = _port(args, dof, sign, cap, tol)
  want = jax.vmap(functools.partial(
      pallas_newton._newton_reference, dof=dof, sign=sign, cap=cap,
      tol=tol))(*(jnp.asarray(a) for a in args),
                *_cone_empty(bsz, nv, jnp.float64))[:3]
  # f64, same iteration in the same order: agreement to rounding, with
  # headroom for the different summation order of the matmuls
  for g, w in zip(got, want):
    np.testing.assert_allclose(g, np.asarray(w), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize('case', sorted(CASES))
def test_plain_newton_matches_pallas_kernel_f32(case):
  build, dof, sign, cap, tol = CASES[case]
  args = build(np.float32)
  got = _port(args, dof, sign, cap, tol)
  want = pallas_newton.newton_batched(
      *(jnp.asarray(a) for a in args), dof=dof, sign=sign, cap=cap, tol=tol,
      interpret=True)
  # f32: the kernel and the plain loop sum in different orders, so a jar
  # sitting on an activity boundary can wiggle at ~1e-3 (the tolerance of
  # tests/test_pallas_newton.py for the same comparison)
  for g, w in zip(got, want):
    np.testing.assert_allclose(g.astype(np.float64),
                               np.asarray(w, np.float64), rtol=2e-3,
                               atol=1e-3)


def test_finished_samples_stay_frozen():
  """A sample that converged early keeps its answer while others iterate:
  the same problem solved alone and inside a batch gives the same qacc."""
  args = _synthetic_problem(5, 8, 4, 6, 2, np.float64)
  dof, sign = (0, 3), (1.0, -1.0)
  batch = _port(args, dof, sign, 30, 1e-10)
  for i in range(8):
    alone = _port(tuple(a[i:i + 1] for a in args), dof, sign, 30, 1e-10)
    for b, a in zip(batch, alone):
      np.testing.assert_array_equal(b[i:i + 1], a)


def test_wrapper_takes_plain_version_on_cpu():
  build, dof, sign, cap, tol = CASES['cartpole_shaped']
  args = [torch.from_numpy(a) for a in build(np.float32)]
  d, s = torch.tensor(dof, dtype=torch.int32), torch.tensor(sign)
  before = newton.newton.launches
  got = newton.newton(*args, d, s, cap=cap, tol=tol)
  want = newton.newton_reference(*args, d, s, cap=cap, tol=tol)
  for g, w in zip(got, want):
    assert torch.equal(g, w)
  assert newton.newton.launches == before   # no kernel on the CPU


def _group_problem(seed, bsz, nv, n, ns, groups, dtype):
  """A synthetic problem with factored contact-point groups: the dense and
  one-hot operands of _synthetic_problem, then cdofc and per group
  (g, aref, dvec, mu), and the groups' static dmasks. groups: ((condim,
  P), ...). About half the points carry a zero penalty weight, as points
  out of contact do."""
  rng = np.random.default_rng(seed)
  base = _synthetic_problem(seed, bsz, nv, n, ns, dtype)
  softplus = lambda x: np.log1p(np.exp(x))  # noqa: E731
  gargs = [0.5 * rng.normal(size=(bsz, nv, 6))]
  dmasks = []
  for condim, p in groups:
    nrep = len(pallas_newton.PYRAMID_FACETS[condim])
    dvec = softplus(rng.normal(size=(bsz, p)))
    gargs += [rng.normal(size=(bsz, p, condim, 6)),
              rng.normal(size=(bsz, nrep, p)),
              np.where(rng.uniform(size=(bsz, p)) < 0.5, dvec, 0.0),
              rng.uniform(0.2, 1.0, size=(bsz, 3, p))]
    dmasks.append(rng.integers(-1, 2, size=(p, nv)).astype(np.float32))
  return base, tuple(x.astype(dtype) for x in gargs), tuple(dmasks)


# name -> (condims and point counts, dof, sign); nv 6, n 3, ns 2, B 8
GROUP_CASES = {
    'condim1': (((1, 4),), (0, 5), (1.0, -1.0)),
    'condim3': (((3, 3),), (0, 5), (1.0, -1.0)),
    'condim4': (((4, 3),), (2, 3), (1.0, 1.0)),
    'condim6': (((6, 2),), (1, 4), (-1.0, 1.0)),
    'two_groups': (((3, 3), (6, 2)), (0, 5), (1.0, -1.0)),
}


def _port_groups(base, gargs, dmasks, groups, dof, sign, cap, tol):
  t = [torch.from_numpy(x) for x in base]
  out = newton.newton_reference(
      *t, torch.tensor(dof, dtype=torch.int32),
      torch.tensor(sign, dtype=t[1].dtype),
      *(torch.from_numpy(x) for x in gargs), cap=cap, tol=tol,
      condims=tuple(c for c, _ in groups),
      dmasks=tuple(torch.from_numpy(x) for x in dmasks))
  return [x.numpy() for x in out]


@pytest.mark.parametrize('case', sorted(GROUP_CASES))
def test_plain_newton_groups_match_jax_reference_loop_f64(case):
  groups, dof, sign = GROUP_CASES[case]
  base, gargs, dmasks = _group_problem(6, 8, 6, 3, 2, groups, np.float64)
  got = _port_groups(base, gargs, dmasks, groups, dof, sign, 30, 1e-10)
  condims = tuple(c for c, _ in groups)

  def one(*a):
    jd = tuple((pallas_newton.materialize_jd(a[9 + 4 * i], a[8],
                                             dmasks[i]),)
               + tuple(a[10 + 4 * i:13 + 4 * i]) for i in range(len(groups)))
    return pallas_newton._newton_reference(
        *a[:8], *a[-8:], dof=dof, sign=sign, cap=30, tol=1e-10,
        condims=condims, groups=jd)

  want = jax.vmap(one)(*(jnp.asarray(x) for x in base + gargs),
                       *_cone_empty(8, 6, jnp.float64))
  want = want[:3] + want[5:]
  # f64, the same iteration on the facet-expanded rows in the same order
  for g, w in zip(got, want):
    np.testing.assert_allclose(g, np.asarray(w), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize('case', sorted(GROUP_CASES))
def test_plain_newton_groups_match_pallas_kernel_f32(case):
  groups, dof, sign = GROUP_CASES[case]
  base, gargs, dmasks = _group_problem(7, 8, 6, 3, 2, groups, np.float32)
  got = _port_groups(base, gargs, dmasks, groups, dof, sign, 30, 1e-6)
  want = pallas_newton.newton_batched(
      *(jnp.asarray(a) for a in base + gargs), dof=dof, sign=sign, cap=30,
      tol=1e-6, interpret=True, condims=tuple(c for c, _ in groups),
      dmasks=tuple(d.tobytes() for d in dmasks))
  # f32, tolerance as for the dense rows above
  for g, w in zip(got, want):
    np.testing.assert_allclose(g.astype(np.float64),
                               np.asarray(w, np.float64), rtol=2e-3,
                               atol=1e-3)


def test_shared_memory_footprint():
  """The kernel's per-sample shared memory: the Quadruped's shapes (nv 18,
  24 one-hot rows, one condim-3 group of 20 points) take ~11 KB; at nv 30
  with 60 one-hot rows, 64 condim-6 points (640 facet rows) fit in one
  block and 160 points (1,600 rows) do not."""
  # 80 rows x (18 + 6) + 18 x 20 + max(18 x 19, 20 x 21) + 2 x 24 floats
  assert newton.sample_smem_bytes(18, 0, 24, [(3, 20)]) == 4 * 2748
  assert newton.sample_smem_bytes(2, 0, 2) == 4 * (2 * 4 + 2 * 3 + 2 * 2)
  assert newton.sample_smem_bytes(30, 0, 60, [(6, 64)]) <= newton.SMEM_LIMIT
  assert newton.sample_smem_bytes(30, 0, 60, [(6, 160)]) > newton.SMEM_LIMIT
  # a tile per sample: the power of two at or above the bucket
  assert [newton.kernel_lanes(nv) for nv in (1, 2, 3, 8, 9, 13, 18, 32)] \
      == [2, 2, 4, 8, 16, 32, 32, 32]
