"""Norm values, gradients and Hessians for residual cost terms.

Port of mujoco_mpc_tpu/ops/norms.py (NormType :25, num_norm_parameters
:37, norm_value :47, norm_grad :84, norm_hess :134). The gradients and
Hessians are the analytic ones, with the same zero guards, so the iLQG
cost expansion (planners/derivatives.py) sees JAX's Gauss-Newton terms.
"""

from __future__ import annotations

import enum

import torch

_EPS = 1e-12


class NormType(enum.IntEnum):
  NULL = -1
  QUADRATIC = 0
  L22 = 1
  L2 = 2
  COSH = 3
  POWER_LOSS = 5
  SMOOTH_ABS_LOSS = 6
  SMOOTH_ABS2_LOSS = 7
  RECTIFY_LOSS = 8


def num_norm_parameters(norm_type: int) -> int:
  """Number of parameters per norm (reference: norm.cc:25-47)."""
  return {
      NormType.NULL: 0, NormType.QUADRATIC: 0, NormType.L22: 2,
      NormType.L2: 1, NormType.COSH: 1, NormType.POWER_LOSS: 1,
      NormType.SMOOTH_ABS_LOSS: 1, NormType.SMOOTH_ABS2_LOSS: 2,
      NormType.RECTIFY_LOSS: 1,
  }[NormType(norm_type)]


def norm_value(x: torch.Tensor, params: torch.Tensor,
               norm_type: int) -> torch.Tensor:
  """The norm of residual x over its last axis; params (..., k)."""
  t = NormType(norm_type)
  zero = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
  p = params[..., 0] if params.shape[-1] > 0 else zero
  q = params[..., 1] if params.shape[-1] > 1 else zero
  if t == NormType.NULL:
    return x[..., 0]
  if t == NormType.QUADRATIC:
    return 0.5 * torch.sum(x * x, dim=-1)
  if t == NormType.L22:
    c = torch.sum(x * x, dim=-1)
    a = torch.pow(torch.clamp(c, min=_EPS), q / 2) + torch.pow(p, q)
    return torch.pow(a, 1.0 / q) - p
  if t == NormType.L2:
    return torch.sqrt(torch.sum(x * x, dim=-1) + p * p) - p
  pn = p[..., None]
  if t == NormType.COSH:
    return torch.sum(pn ** 2 * (torch.cosh(x / pn) - 1.0), dim=-1)
  if t == NormType.POWER_LOSS:
    return torch.sum(torch.abs(x) ** pn, dim=-1)
  if t == NormType.SMOOTH_ABS_LOSS:
    return torch.sum(torch.sqrt(x * x + pn * pn) - pn, dim=-1)
  if t == NormType.SMOOTH_ABS2_LOSS:
    qn = q[..., None]
    return torch.sum((torch.abs(x) ** qn + pn ** qn) ** (1.0 / qn) - pn,
                     dim=-1)
  if t == NormType.RECTIFY_LOSS:
    safe = torch.where(pn > 0, pn, torch.ones_like(pn))
    soft = pn * torch.log1p(torch.exp(x / safe))
    hard = torch.clamp(x, min=0.0)
    return torch.sum(torch.where(pn > 0, soft, hard), dim=-1)
  raise ValueError(f'unknown norm type {norm_type}')


def _params(x, params):
  zero = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
  p = params[..., 0] if params.shape[-1] > 0 else zero
  q = params[..., 1] if params.shape[-1] > 1 else zero
  return p, q


def norm_grad(x: torch.Tensor, params: torch.Tensor,
              norm_type: int) -> torch.Tensor:
  """Analytic gradient of the norm with respect to x, shape of x."""
  t = NormType(norm_type)
  p, q = _params(x, params)
  pn, qn = p[..., None], q[..., None]
  if t == NormType.NULL:
    return torch.ones_like(x)
  if t == NormType.QUADRATIC:
    return x
  if t == NormType.L22:
    c = torch.clamp(torch.sum(x * x, dim=-1), min=_EPS)
    a = torch.pow(c, q / 2) + torch.pow(p, q)
    b = torch.pow(a, 1.0 / q) / a * torch.pow(c, q / 2 - 1.0)
    return b[..., None] * x
  if t == NormType.L2:
    s = torch.sqrt(torch.sum(x * x, dim=-1) + p * p)[..., None]
    return torch.where(s > 0, x / torch.clamp(s, min=_EPS),
                       torch.zeros_like(x))
  if t == NormType.COSH:
    return pn * torch.sinh(x / pn)
  if t == NormType.POWER_LOSS:
    a = torch.clamp(torch.abs(x), min=_EPS)
    return torch.sign(x) * pn * a ** (pn - 1.0)
  if t == NormType.SMOOTH_ABS_LOSS:
    s = torch.sqrt(x * x + pn * pn)
    return torch.where(s > 0, x / torch.clamp(s, min=_EPS),
                       torch.zeros_like(x))
  if t == NormType.SMOOTH_ABS2_LOSS:
    a = torch.clamp(torch.abs(x), min=_EPS)
    e = a ** qn + pn ** qn
    return e ** (1.0 / qn) * a ** (qn - 2.0) / e * x
  if t == NormType.RECTIFY_LOSS:
    s = torch.exp(x / torch.where(pn > 0, pn, torch.ones_like(pn)))
    return torch.where(pn > 0, s / (1.0 + s), (x > 0).to(x.dtype))
  raise ValueError(f'unknown norm type {norm_type}')


def norm_hess(x: torch.Tensor, params: torch.Tensor,
              norm_type: int) -> torch.Tensor:
  """Analytic Hessian of the norm with respect to x, (..., n, n)."""
  t = NormType(norm_type)
  n = x.shape[-1]
  eye = torch.eye(n, dtype=x.dtype, device=x.device)
  p, q = _params(x, params)
  pn, qn = p[..., None], q[..., None]

  def diag(v):
    return eye * v[..., None]
  if t == NormType.NULL:
    return torch.zeros(x.shape[:-1] + (n, n), dtype=x.dtype,
                       device=x.device)
  if t == NormType.QUADRATIC:
    return eye.expand(x.shape[:-1] + (n, n))
  if t == NormType.L22:
    c = torch.clamp(torch.sum(x * x, dim=-1), min=_EPS)
    a = torch.pow(c, q / 2) + torch.pow(p, q)
    d = torch.pow(c, q / 2 - 1.0)
    b = torch.pow(a, 1.0 / q) / a * d
    cc = (1.0 - q) * d / a + (q - 2.0) / c
    outer = x[..., :, None] * x[..., None, :]
    return b[..., None, None] * (eye + outer * cc[..., None, None])
  if t == NormType.L2:
    s = torch.sqrt(torch.sum(x * x, dim=-1) + p * p)[..., None, None]
    g = x / torch.clamp(s[..., 0], min=_EPS)
    h = (eye - g[..., :, None] * g[..., None, :]) / torch.clamp(s, min=_EPS)
    return torch.where(s > 0, h, torch.zeros_like(h))
  if t == NormType.COSH:
    return diag(torch.cosh(x / pn))
  if t == NormType.POWER_LOSS:
    a = torch.clamp(torch.abs(x), min=_EPS)
    return diag((pn - 1.0) * pn * a ** (pn - 2.0))
  if t == NormType.SMOOTH_ABS_LOSS:
    s = torch.sqrt(x * x + pn * pn)
    g = x / torch.clamp(s, min=_EPS)
    return diag(torch.where(s > 0, (1.0 - g * g) / torch.clamp(s, min=_EPS),
                            torch.zeros_like(s)))
  if t == NormType.SMOOTH_ABS2_LOSS:
    a = torch.clamp(torch.abs(x), min=_EPS)
    dd = a ** qn
    e = dd + pn ** qn
    c = e ** (1.0 / qn) * a ** (qn - 2.0) / e
    return diag(c * (qn - 1.0) * (1.0 - dd / e))
  if t == NormType.RECTIFY_LOSS:
    pp = torch.where(pn > 0, pn, torch.ones_like(pn))
    s = torch.exp(x / pp)
    h = s / (pp * (1.0 + s) ** 2)
    return diag(torch.where(pn > 0, h, torch.zeros_like(h)))
  raise ValueError(f'unknown norm type {norm_type}')
