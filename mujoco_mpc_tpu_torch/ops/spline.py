"""Time-spline control plans: zero / linear / cubic interpolation.

Port of mujoco_mpc_tpu/ops/spline.py (Interp :23, _slopes :29, sample
:39, sample_many :78, resample :84, knot_times :91). A plan is
(times (P,), values (..., P, nu)); leading dimensions of `values` are
candidates. Sampling before the first or after the last knot clamps to the
end values; zero interpolation holds the left knot, found with
searchsorted(right=True) exactly as JAX's side='right'.
"""

from __future__ import annotations

import enum

import torch


class Interp(enum.IntEnum):
  ZERO = 0
  LINEAR = 1
  CUBIC = 2


def _slopes(times: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
  """Per-knot slopes (..., P, nu): averaged one-sided differences."""
  dt = torch.clamp(times[1:] - times[:-1], min=1e-10)[:, None]
  fd = (values[..., 1:, :] - values[..., :-1, :]) / dt
  interior = 0.5 * (fd[..., 1:, :] + fd[..., :-1, :])
  return torch.cat([fd[..., :1, :], interior, fd[..., -1:, :]], dim=-2)


def sample_many(times: torch.Tensor, values: torch.Tensor, ts: torch.Tensor,
                interp: int) -> torch.Tensor:
  """Sample the plan at times ts (T,) -> (..., T, nu)."""
  p = times.shape[0]
  if p == 1:
    return values[..., :1, :].expand(values.shape[:-2] + (ts.shape[0],
                                                          values.shape[-1]))
  upper = torch.searchsorted(times, ts, right=True)       # in [0, P]
  below = (upper == 0)[:, None]
  above = (upper == p)[:, None]
  lo = torch.clamp(upper - 1, 0, p - 1)
  hi = torch.clamp(upper, 0, p - 1)
  v_lo = values[..., lo, :]
  v_hi = values[..., hi, :]
  if interp == Interp.ZERO:
    inner = v_lo
  else:
    t_lo, t_hi = times[lo], times[hi]
    dt = torch.clamp(t_hi - t_lo, min=1e-10)
    s = ((ts - t_lo) / dt)[:, None]
    if interp == Interp.LINEAR:
      inner = v_lo * (1 - s) + v_hi * s
    else:
      m = _slopes(times, values)
      m0, m1 = m[..., lo, :], m[..., hi, :]
      s2, s3 = s * s, s * s * s
      dtc = dt[:, None]
      c0 = 2 * s3 - 3 * s2 + 1
      c1 = (s3 - 2 * s2 + s) * dtc
      c2 = -2 * s3 + 3 * s2
      c3 = (s3 - s2) * dtc
      inner = c0 * v_lo + c1 * m0 + c2 * v_hi + c3 * m1
  out = torch.where(below, values[..., :1, :], inner)
  return torch.where(above, values[..., p - 1:p, :], out)


def sample(times: torch.Tensor, values: torch.Tensor, t: torch.Tensor,
           interp: int) -> torch.Tensor:
  """Sample a plan (P, nu) at the times t (B,) -> (B, nu); JAX samples one
  scalar time per call."""
  return sample_many(times, values, t.reshape(-1), interp)


def resample(times: torch.Tensor, values: torch.Tensor,
             new_times: torch.Tensor, interp: int) -> torch.Tensor:
  """The plan evaluated at new knot times (sampling/planner.cc:283-305)."""
  return sample_many(times, values, new_times, interp)


def knot_times(t0: torch.Tensor, horizon_time: torch.Tensor,
               num_points: int, interp: int) -> torch.Tensor:
  """Zero splines space knots by T/P, the others by T/(P-1)."""
  if interp == Interp.ZERO:
    shift = torch.clamp(horizon_time / num_points, min=1e-5)
  else:
    shift = torch.clamp(horizon_time / max(num_points - 1, 1), min=1e-5)
  steps = torch.arange(num_points, dtype=t0.dtype, device=t0.device)
  return t0 + steps * shift
