"""The port's plain SPD solve (kernel B1's plain version) against JAX.

mujoco_mpc_tpu_torch/ops/linalg.solve_spd is held against the JAX unrolled
solve (ops/linalg.solve_spd) and against the Pallas kernel it stands for
(ops/pallas_linalg.solve_spd_batched, in interpret mode as
tests/test_pallas_linalg.py runs it), on the same numpy inputs. B = 130
exercises the Pallas kernel's padding to 128-lane tiles. The CUDA kernel's
tile and shared-memory sizes, which ops/spd_solve.py mirrors, are checked
against its source.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu.ops import linalg as jlinalg
from mujoco_mpc_tpu.ops import pallas_linalg
from mujoco_mpc_tpu_torch.ops import linalg
from mujoco_mpc_tpu_torch.ops import spd_solve

torch.set_num_threads(1)


def _spd_problem(seed, bsz, n, dtype):
  rng = np.random.default_rng(seed)
  g = rng.normal(size=(bsz, n, n))
  a = g @ np.transpose(g, (0, 2, 1)) + n * np.eye(n)
  b = rng.normal(size=(bsz, n))
  return a.astype(dtype), b.astype(dtype)


CASES = [(n, bsz) for n in (2, 12, 18) for bsz in (1, 130)]
# XLA's CPU backend without its optimisation passes: the interpreted
# kernel is thousands of scalar ops, which it took longer to optimise than
# to run (about half of an n-18 case); the result agrees with the default
# compile's to ~1e-8, far inside the tolerance of the test
_QUICK_COMPILE = {'xla_backend_optimization_level': 0,
                  'xla_llvm_disable_expensive_passes': True}


def _pallas_interpret(a, b):
  a, b = jnp.asarray(a), jnp.asarray(b)
  lowered = pallas_linalg.solve_spd_batched.lower(a, b, interpret=True)
  return np.asarray(lowered.compile(compiler_options=_QUICK_COMPILE)(a, b))


@pytest.mark.parametrize('n,bsz', CASES)
def test_plain_solve_matches_jax_unrolled_f64(n, bsz):
  a, b = _spd_problem(n * 1000 + bsz, bsz, n, np.float64)
  got = linalg.solve_spd(torch.from_numpy(a), torch.from_numpy(b)).numpy()
  want = np.asarray(jax.vmap(jlinalg.solve_spd)(jnp.asarray(a),
                                                jnp.asarray(b)))
  # f64, same recurrence in the same order: agreement to rounding
  np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13)
  # and it solves the system (a well-conditioned SPD, cond <~ 10)
  np.testing.assert_allclose(np.einsum('bij,bj->bi', a, got), b,
                             rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize('n,bsz', CASES)
def test_plain_solve_matches_pallas_kernel_f32(n, bsz):
  a, b = _spd_problem(n * 7 + bsz, bsz, n, np.float32)
  got = linalg.solve_spd(torch.from_numpy(a), torch.from_numpy(b)).numpy()
  want = _pallas_interpret(a, b)
  # f32: the kernel multiplies by 1/L_ii where the plain version divides,
  # so the two round differently; cond(a) <~ 10 keeps that below ~1e-5
  np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_wrapper_takes_plain_version_on_cpu():
  a, b = _spd_problem(3, 5, 4, np.float32)
  before = spd_solve.solve_spd.launches
  got = spd_solve.solve_spd(torch.from_numpy(a), torch.from_numpy(b))
  want = linalg.solve_spd(torch.from_numpy(a), torch.from_numpy(b))
  assert torch.equal(got, want)
  assert spd_solve.solve_spd.launches == before   # no kernel on the CPU


def test_kernel_tiles_and_shared_memory_follow_the_buckets():
  """kernel_lanes and block_smem_bytes against the bucket list and the
  kernel's source: its dispatch, its block size and its 48 KB of static
  shared memory."""
  with open(os.path.join(os.path.dirname(os.path.dirname(
      os.path.abspath(__file__))), 'mujoco_mpc_tpu_torch', 'csrc',
                         'chol_solve.cu')) as f:
    src = f.read()
  assert tuple(sorted({int(k) for k in re.findall(r'launch<(\d+)>', src)})
               ) == spd_solve.N_BUCKETS
  assert f'kThreads = {spd_solve.THREADS};' in src
  for n in range(1, spd_solve.MAX_N + 1):
    bucket = min(k for k in spd_solve.N_BUCKETS if k >= n)
    lanes = spd_solve.kernel_lanes(n)
    assert lanes in (2, 4, 8) and (lanes >= bucket or lanes == 8)
    assert lanes == 2 or lanes // 2 < bucket            # the smallest such
    smem = spd_solve.block_smem_bytes(n)
    assert smem == 4 * (spd_solve.THREADS // lanes) * bucket * (bucket + 1)
    assert smem <= 48 * 1024
  assert [spd_solve.kernel_lanes(n) for n in (1, 2, 3, 5, 9, 17, 32)] == [
      2, 2, 4, 8, 8, 8, 8]
  assert spd_solve.block_smem_bytes(18) == 10944   # 8 systems of 18 x 19
  for n in (0, 33):
    for fn in (spd_solve.kernel_lanes, spd_solve.block_smem_bytes):
      with pytest.raises(ValueError):
        fn(n)
