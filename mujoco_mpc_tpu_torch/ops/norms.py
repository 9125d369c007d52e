"""Norm values for residual cost terms.

Port of mujoco_mpc_tpu/ops/norms.py (NormType :25, num_norm_parameters
:37, norm_value :47). The analytic gradients and Hessians (:84, :134)
serve the derivative planners and come with them (ROADMAP A9).
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
