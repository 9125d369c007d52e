"""Block-banded SPD factorization and solves.

Port of mujoco_mpc_tpu/ops/banded.py (block_tridiag_cholesky :24,
block_tridiag_solve :51, pentadiag_to_superblocks :81,
block_pentadiag_solve :120): the direct optimizer's Gauss-Newton systems
(the reference's band Cholesky, mjpc/direct/direct.cc:2342-2380) kept as
n-sized blocks and factored block by block. JAX scans over the T blocks
with lax.scan; here the host loops over them, each block a dense
torch.linalg.cholesky_ex or solve_triangular (plain library calls, as
JAX's are plain XLA: neither is a Pallas kernel).

A block-pentadiagonal system (the direct Hessian couples t with t +- 2)
becomes block-tridiagonal by grouping two consecutive blocks into one
superblock.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _cholesky(a: torch.Tensor) -> torch.Tensor:
  """torch.linalg.cholesky, its lower triangle NaN where a is not
  positive definite (JAX's cholesky returns that, which the direct
  optimizer's line search reads as an infinite cost; torch's raises)."""
  lo, info = torch.linalg.cholesky_ex(a)
  return torch.where(info[..., None, None] == 0, lo,
                     torch.tril(torch.full_like(lo, float('nan'))))


def _lower_solve(lo: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """L^-1 b for b (..., n) or (..., n, k)."""
  vec = b.dim() == lo.dim() - 1
  x = torch.linalg.solve_triangular(lo, b[..., None] if vec else b,
                                    upper=False)
  return x[..., 0] if vec else x


def _upper_solve(lo: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """L^-T b for b (..., n)."""
  return torch.linalg.solve_triangular(lo.transpose(-1, -2), b[..., None],
                                       upper=True)[..., 0]


def block_tridiag_cholesky(diag: torch.Tensor, lower: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Blocked Cholesky of an SPD block-tridiagonal matrix.

  diag (T, n, n) the diagonal blocks D_t, lower (T-1, n, n) the
  sub-diagonal blocks C_t (block (t+1, t)). Returns (L_diag (T, n, n)
  lower-triangular, L_lower (T-1, n, n)) with D_0 = L_0 L_0^T,
  M_t = C_t L_t^-T and D_{t+1} - M_t M_t^T = L_{t+1} L_{t+1}^T."""
  l_diag = [_cholesky(diag[0])]
  l_lower = []
  for t in range(lower.shape[0]):
    m = _lower_solve(l_diag[-1], lower[t].T).T
    l_lower.append(m)
    l_diag.append(_cholesky(diag[t + 1] - m @ m.T))
  return (torch.stack(l_diag),
          torch.stack(l_lower) if l_lower else torch.zeros_like(lower))


def block_tridiag_solve(l_diag: torch.Tensor, l_lower: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
  """Solve A x = b (b (T, n)) given block_tridiag_cholesky's factor: the
  forward substitution L y = b, then the back substitution L^T x = y."""
  y = [_lower_solve(l_diag[0], b[0])]
  for t in range(1, b.shape[0]):
    y.append(_lower_solve(l_diag[t], b[t] - l_lower[t - 1] @ y[-1]))
  x = [_upper_solve(l_diag[-1], y[-1])]
  for t in reversed(range(b.shape[0] - 1)):
    x.append(_upper_solve(l_diag[t], y[t] - l_lower[t].T @ x[-1]))
  return torch.stack(x[::-1])


def pentadiag_to_superblocks(diag: torch.Tensor, off1: torch.Tensor,
                             off2: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Group 2 x 2 blocks of a block-pentadiagonal SPD matrix into
  superblocks. diag (T, n, n), off1 (T-1, n, n) block (t+1, t), off2
  (T-2, n, n) block (t+2, t); T even. Returns (super_diag (T/2, 2n, 2n),
  super_lower (T/2 - 1, 2n, 2n)), block-tridiagonal."""
  t, n, _ = diag.shape
  assert t % 2 == 0, 'pad the window to an even number of blocks'
  s = t // 2
  z = torch.zeros_like(diag[0])

  def super_diag_at(i):
    a, b, d = diag[2 * i], off1[2 * i], diag[2 * i + 1]
    return torch.cat([torch.cat([a, b.T], 1), torch.cat([b, d], 1)], 0)

  def super_lower_at(i):
    # superblock (i+1, i) couples blocks (2i+2, 2i+3) x (2i, 2i+1); block
    # (2i+3, 2i) lies outside the band
    c31 = off2[2 * i + 1] if 2 * i + 1 < t - 2 else z
    return torch.cat([torch.cat([off2[2 * i], off1[2 * i + 1]], 1),
                      torch.cat([z, c31], 1)], 0)

  super_diag = torch.stack([super_diag_at(i) for i in range(s)])
  super_lower = (torch.stack([super_lower_at(i) for i in range(s - 1)])
                 if s > 1 else diag.new_zeros((0, 2 * n, 2 * n)))
  return super_diag, super_lower


def block_pentadiag_solve(diag: torch.Tensor, off1: torch.Tensor,
                          off2: torch.Tensor, b: torch.Tensor
                          ) -> torch.Tensor:
  """Solve a block-pentadiagonal SPD system, b (T, n), by superblocks."""
  t, n = b.shape
  sd, sl = pentadiag_to_superblocks(diag, off1, off2)
  ld, ll = block_tridiag_cholesky(sd, sl)
  return block_tridiag_solve(ld, ll, b.reshape(t // 2, 2 * n)).reshape(t, n)
