"""Batch estimator: a recursive fixed-lag smoother over the direct
optimizer.

Port of mujoco_mpc_tpu/estimators/batch.py (BatchState :27, init_state
:42, _dense_hessian :58, marginalize_prior :76, update :104), the
reference's Batch estimator (mjpc/estimators/batch.{h,cc}): a sliding
window of configurations optimized with the direct cost plus a prior
0.5 (z - z_prior)' P (z - z_prior) that anchors the window to the
previous estimates; each update shifts the window by one (batch.h:127
Shift) and seeds the newest slot with the newest configuration. One
window a call, as estimators/direct.py; nothing here launches a kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from mujoco_mpc_tpu_torch.estimators import direct as direct_mod


@dataclasses.dataclass(frozen=True)
class BatchState:
  qpos_window: torch.Tensor    # (T, nq) the window's estimates
  sensor_window: torch.Tensor  # (T, ns)
  force_window: torch.Tensor   # (T, nv)
  times: torch.Tensor          # (T,)
  filled: torch.Tensor         # 0-d int: valid slots
  # the band prior weight P (batch.h:162 weight_prior_), block
  # tridiagonal: diagonal (T, nv, nv) and lower off-diagonal (T-1, nv, nv)
  prior_diag: torch.Tensor
  prior_off1: torch.Tensor

  def replace(self, **changes) -> 'BatchState':
    return dataclasses.replace(self, **changes)


def init_state(p: direct_mod.DirectProblem,
               dtype: Optional[torch.dtype] = None,
               scale_prior: float = 1.0) -> BatchState:
  m = p.model
  t = p.horizon
  kw = dict(dtype=dtype or m.dtype, device=m.device)
  eye = torch.eye(m.nv, **kw)
  return BatchState(
      qpos_window=m.qpos0.to(kw['dtype']).expand(t, m.nq).clone(),
      sensor_window=torch.zeros((t, p.sensor_dim), **kw),
      force_window=torch.zeros((t, m.nv), **kw),
      times=torch.arange(t, **kw),
      filled=torch.zeros((), dtype=torch.int32, device=m.device),
      prior_diag=(scale_prior * eye).expand(t, m.nv, m.nv).clone(),
      prior_off1=torch.zeros((t - 1, m.nv, m.nv), **kw))


def _dense_hessian(diag, off1, off2) -> torch.Tensor:
  """The dense (T nv, T nv) Hessian of its block-banded parts."""
  t, nv, _ = diag.shape
  h = diag.new_zeros((t * nv, t * nv))
  blk = lambda i, j: (slice(i * nv, (i + 1) * nv),  # noqa: E731
                      slice(j * nv, (j + 1) * nv))
  for i in range(t):
    h[blk(i, i)] = diag[i]
  for i in range(t - 1):
    h[blk(i + 1, i)] = off1[i]
    h[blk(i, i + 1)] = off1[i].T
  for i in range(t - 2):
    h[blk(i + 2, i)] = off2[i]
    h[blk(i, i + 2)] = off2[i].T
  return h


def marginalize_prior(h: torch.Tensor, nv: int, scale_prior,
                      damping: float = 1e-6):
  """The recursive prior update (batch.cc:356-388 ConditionMatrix and
  DenseToBlockBand): the oldest nv variables marginalized out of the
  window Hessian h (T nv, T nv) by a Schur complement, shifted, the
  newest slot padded with scale_prior I and the result truncated to the
  block-tridiagonal band. Returns (prior_diag (T, nv, nv), prior_off1
  (T-1, nv, nv)) for a window of the same length."""
  t = h.shape[0] // nv
  eye = torch.eye(nv, dtype=h.dtype, device=h.device)
  a = h[:nv, :nv] + damping * eye
  b = h[nv:, :nv]
  hc = h[nv:, nv:] - b @ torch.linalg.solve(a, b.T)
  diag = h.new_zeros((t, nv, nv))
  off1 = h.new_zeros((t - 1, nv, nv))
  for i in range(t - 1):
    diag[i] = hc[i * nv:(i + 1) * nv, i * nv:(i + 1) * nv]
  for i in range(t - 2):
    off1[i] = hc[(i + 1) * nv:(i + 2) * nv, i * nv:(i + 1) * nv]
  diag[t - 1] = scale_prior * eye
  return diag, off1


def update(p: direct_mod.DirectProblem, state: BatchState,
           settings: direct_mod.DirectSettings, sensor: torch.Tensor,
           force: torch.Tensor, time: torch.Tensor, timestep: torch.Tensor,
           recursive_prior: bool = False) -> Tuple[BatchState, dict]:
  """Shift the window, append the new measurement (sensor (ns,), force
  (nv,), time 0-d), re-optimize. With recursive_prior (the reference's
  filter_settings.recursive_prior_update, batch.cc:356-388, off by
  default there too, batch.h:157) the next window's prior is this
  window's Gauss-Newton Hessian with the oldest configuration
  marginalized out."""
  qpos_w = torch.cat([state.qpos_window[1:], state.qpos_window[-1:]])
  sensor_w = torch.cat([state.sensor_window[1:], sensor[None]])
  force_w = torch.cat([state.force_window[1:], force[None]])
  times = torch.cat([state.times[1:], time.reshape(1)])

  data = direct_mod.DirectData(qpos_ref=qpos_w, sensor_meas=sensor_w,
                               force_meas=force_w, times=times)
  # the prior anchors the displacements to the previous estimates (z_prior
  # 0 around qpos_ref, which holds the shifted previous solution)
  z_prior = torch.zeros(p.horizon * p.model.nv, dtype=qpos_w.dtype,
                        device=qpos_w.device)
  z, info = direct_mod.optimize(p, data, settings, z_prior=z_prior,
                                prior_diag=state.prior_diag,
                                prior_off1=state.prior_off1)
  if recursive_prior:
    diag, off1, off2, _ = direct_mod._banded_normal_equations(
        p, data, z, settings)
    h = _dense_hessian(diag + state.prior_diag, off1 + state.prior_off1,
                       off2)
    p_diag, p_off1 = marginalize_prior(h, p.model.nv, settings.prior_weight)
  else:
    p_diag, p_off1 = state.prior_diag, state.prior_off1
  new_state = BatchState(
      qpos_window=info['qpos'], sensor_window=sensor_w,
      force_window=force_w, times=times,
      filled=torch.clamp(state.filled + 1, max=p.horizon),
      prior_diag=p_diag, prior_off1=p_off1)
  info['qpos_estimate'] = info['qpos'][-2]   # the newest constrained slot
  return new_state, info
