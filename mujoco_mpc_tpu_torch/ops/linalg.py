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
order. The port unrolls for every n. On the card the CUDA kernel takes
every batched solve up to n = 32, and the wrappers refuse a larger n
(ops/spd_solve.py, ops/newton.py): planner models reach nv 87 (Cube
Solving), and their design lands with the mesh-hull slice (ROADMAP A7).
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


def solve_spd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Solve SPD a x = b; a (..., n, n), b (..., n)."""
  return chol_solve(chol_factor(a), b)
