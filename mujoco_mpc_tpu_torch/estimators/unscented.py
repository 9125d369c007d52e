"""Unscented Kalman filter, batch-first.

Port of mujoco_mpc_tpu/estimators/unscented.py (_weights :30, update
:42), the reference's Unscented estimator
(mjpc/estimators/unscented.cc): 2 ndx + 1 sigma points with alpha 1,
beta 2 (unscented.h:153-155), propagated through the sensors and the
step as ONE batch of B (2 ndx + 1) states (JAX vmaps them; the
reference steps them one by one), a joint state-sensor covariance update,
and the means on the quaternion manifold taken in the tangent space of
the center point. The sums over sigma points run in JAX's order (center
first, then +columns, then -columns).
"""

from __future__ import annotations

import torch

from mujoco_mpc_tpu_torch.estimators import base
from mujoco_mpc_tpu_torch.ops import linalg
from mujoco_mpc_tpu_torch.physics.model import Data, Model

ALPHA = 1.0
BETA = 2.0


def _weights(nd: int):
  """(wm0, wc0, ws, n + lambda) of the sigma points."""
  lam = ALPHA * ALPHA * nd - nd
  n_lam = nd + lam
  return (lam / n_lam, lam / n_lam + (1.0 - ALPHA * ALPHA + BETA),
          1.0 / (2.0 * n_lam), n_lam)


def update(m: Model, template: Data, state: base.EstimatorState,
           ctrl: torch.Tensor, sensor: torch.Tensor,
           sensor_slice=None) -> base.EstimatorState:
  """Joint UKF update over one control period; sensor (B, ns)."""
  nd = base.ndx(m)
  bsz = state.qpos.shape[0]
  ns_pts = 2 * nd + 1
  dtype, device = state.qpos.dtype, state.qpos.device
  wm0, wc0, ws, n_lam = _weights(nd)

  # sigma-point deltas: 0, +-columns of sqrt((n + lambda) P)
  chol_t = linalg.cholesky(state.covariance * n_lam).transpose(-1, -2)
  deltas = torch.cat([torch.zeros((bsz, 1, nd), dtype=dtype, device=device),
                      chol_t, -chol_t], 1)                # (B, S, nd)

  def rep(x):   # (B, ...) -> (B S, ...), each filter's rows repeated
    return x[:, None].expand(bsz, ns_pts, *x.shape[1:]).reshape(
        bsz * ns_pts, *x.shape[1:])

  qp, qv, a = base.perturb(m, rep(state.qpos), rep(state.qvel),
                           rep(state.act), deltas.reshape(-1, nd))
  time, u = rep(state.time), rep(ctrl)
  y_s = base.measure(m, template, qp, qv, a, time, u, sensor_slice)
  qp2, qv2, a2, t2 = base.predict(m, template, qp, qv, a, time, u)

  # means in the tangent space of the center sigma point
  center = [x.reshape(bsz, ns_pts, *x.shape[1:])[:, 0] for x in (qp2, qv2,
                                                                a2, t2)]
  dx_s = base.difference(m, *(rep(x) for x in center[:3]), qp2, qv2,
                         a2).reshape(bsz, ns_pts, nd)
  y_s = y_s.reshape(bsz, ns_pts, -1)
  wm = torch.full((ns_pts,), ws, dtype=dtype, device=device)
  wc = wm.clone()
  wm[0], wc[0] = wm0, wc0

  dx_mean = torch.einsum('s,bsd->bd', wm, dx_s)
  y_mean = torch.einsum('s,bsy->by', wm, y_s)
  dxc = dx_s - dx_mean[:, None]
  dyc = y_s - y_mean[:, None]
  pxx = (torch.einsum('s,bsd,bse->bde', wc, dxc, dxc)
         + torch.diag_embed(state.noise_process))
  pxy = torch.einsum('s,bsd,bsy->bdy', wc, dxc, dyc)
  pyy = (torch.einsum('s,bsy,bsz->byz', wc, dyc, dyc)
         + torch.diag_embed(state.noise_sensor))

  # gain Pxy Pyy^-1 (each row of Pxy solved against Pyy) and correction
  gain = linalg.cholesky_solve(linalg.cholesky(pyy)[:, None], pxy)
  dx = dx_mean + (gain @ (sensor - y_mean)[..., None])[..., 0]
  qp_new, qv_new, a_new = base.perturb(m, *center[:3], dx)
  p_new = pxx - gain @ pyy @ gain.transpose(-1, -2)
  p_new = 0.5 * (p_new + p_new.transpose(-1, -2))
  return state.replace(qpos=qp_new, qvel=qv_new, act=a_new, time=center[3],
                       covariance=p_new)
