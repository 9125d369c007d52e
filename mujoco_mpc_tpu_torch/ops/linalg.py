"""Small SPD solves, unrolled over the matrix dimension.

Port of mujoco_mpc_tpu/ops/linalg.py (chol_factor :117, chol_solve :146,
solve_spd :171): column-by-column Cholesky-Crout with the diagonal floored
at 1e-30, then forward and back substitution, every scalar of the
recurrence a (B,)-wide tensor. This is the plain PyTorch version of the
CUDA kernel in ops/spd_solve.py. It is also the reference's own path for
the iLQG backward pass's small unbatched nu x nu solves and factors
(planners/ilqg.py boxqp and riccati; JAX's ilqg.py:143, :224-235 call
ops/linalg there, not the Pallas kernel), so on the card those run here
and not on B1.

JAX switches to a blocked factorization above n = 24 (linalg.py:59) and to
XLA's own above n = 128; both compute the same factorization in another
order. The port unrolls up to n = UNROLL_N and above it runs the same
Cholesky-Crout column by column on (B, n)-wide slices (`cholesky`,
`cholesky_solve`, `solve_spd_wide`), which keeps a plain solve at Cube
Solving's nv 87 to a few hundred ops where the unrolled form takes
~n^3 / 6. On the card the CUDA kernel takes every batched solve up to
n = 96 (ops/spd_solve.py). The estimators' factors (the UKF's sigma
points and both filters' gain solves, n 36 and 45 on Quadruped Flat)
take `cholesky` at every n: JAX's chol_factor and chol_solve there are
plain XLA, not the Pallas kernel.
"""

from __future__ import annotations

import torch


def chol_factor(a: torch.Tensor):
  """Lower Cholesky factor of a (..., n, n) as a list of lists of (...)
  tensors (entries above the diagonal are None)."""
  n = a.shape[-1]
  col = [[None] * n for _ in range(n)]
  for j in range(n):
    s = a[..., j, j]
    for k in range(j):
      s = s - col[j][k] * col[j][k]
    ljj = torch.sqrt(torch.clamp(s, min=1e-30))
    col[j][j] = ljj
    inv = 1.0 / ljj
    for i in range(j + 1, n):
      s = a[..., i, j]
      for k in range(j):
        s = s - col[i][k] * col[j][k]
      col[i][j] = s * inv
  return col


def chol_solve(col, b: torch.Tensor) -> torch.Tensor:
  """Solve (L L^T) x = b for b (..., n) given chol_factor's L."""
  n = b.shape[-1]
  y = [None] * n
  for i in range(n):
    s = b[..., i]
    for k in range(i):
      s = s - col[i][k] * y[k]
    y[i] = s / col[i][i]
  x = [None] * n
  for i in reversed(range(n)):
    s = y[i]
    for k in range(i + 1, n):
      s = s - col[k][i] * x[k]
    x[i] = s / col[i][i]
  return torch.stack(x, dim=-1)


UNROLL_N = 32


def cholesky(a: torch.Tensor) -> torch.Tensor:
  """Lower Cholesky factor (..., n, n) of SPD a, by the same Cholesky-Crout
  as chol_factor (diagonal floored at 1e-30), each column a slice op."""
  n = a.shape[-1]
  lo = torch.zeros_like(a)
  for j in range(n):
    s = a[..., j:, j] - (lo[..., j:, :j] @ lo[..., j, :j, None])[..., 0]
    ljj = torch.sqrt(torch.clamp(s[..., 0], min=1e-30))
    lo[..., j, j] = ljj
    lo[..., j + 1:, j] = s[..., 1:] / ljj[..., None]
  return lo


def cholesky_solve(lo: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Solve (L L^T) x = b for b (..., n) given cholesky's L (..., n, n),
  by forward and back substitution, each row a slice op."""
  n = b.shape[-1]
  y = torch.zeros_like(b)
  for i in range(n):
    y[..., i] = (b[..., i] - torch.sum(lo[..., i, :i] * y[..., :i], -1)
                 ) / lo[..., i, i]
  x = torch.zeros_like(b)
  for i in reversed(range(n)):
    x[..., i] = (y[..., i] - torch.sum(lo[..., i + 1:, i] * x[..., i + 1:],
                                       -1)) / lo[..., i, i]
  return x


def solve_spd_wide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Solve SPD a x = b, a (..., n, n), b (..., n), by cholesky and
  cholesky_solve."""
  return cholesky_solve(cholesky(a), b)


def solve_spd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Solve SPD a x = b; a (..., n, n), b (..., n)."""
  if a.shape[-1] > UNROLL_N:
    return solve_spd_wide(a, b)
  return chol_solve(chol_factor(a), b)
