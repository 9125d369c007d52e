"""The port's plain SPD solve (kernel B1's plain version) against JAX.

mujoco_mpc_tpu_torch/ops/linalg.solve_spd is held against the JAX unrolled
solve (ops/linalg.solve_spd) and against the Pallas kernel it stands for
(ops/pallas_linalg.solve_spd_batched, in interpret mode as
tests/test_pallas_linalg.py runs it), on the same numpy inputs. B = 130
exercises the Pallas kernel's padding to 128-lane tiles.
"""

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
  want = np.asarray(pallas_linalg.solve_spd_batched(
      jnp.asarray(a), jnp.asarray(b), interpret=True))
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
