"""Extended Kalman filter, batch-first.

Port of mujoco_mpc_tpu/estimators/kalman.py (update_measurement :24,
update_prediction :52, update :71), the reference's Kalman estimator
(mjpc/estimators/kalman.cc): a measurement update at the current state,
then the prediction step (kalman.cc:188-320). Both Jacobians are exact:
utils/math.jacfwd_batched, one torch.func.vmap of jvp over the ndx
tangent directions of every filter at once (JAX's jax.jacfwd), through
the kernels' Functions (ops/spd_solve.SpdSolve, ops/newton.NewtonSolve),
whose vmap rules fold the directions into the kernels' batch; the
measurement and the stepped state are that pass's own values (JAX's jit
merges its separate primal calls into it; eager PyTorch would run them
twice). The gain solve is the plain factor of ops/linalg (JAX's
linalg.chol_factor and chol_solve, plain XLA at ns 45).
"""

from __future__ import annotations

import torch

from mujoco_mpc_tpu_torch.estimators import base
from mujoco_mpc_tpu_torch.ops import linalg
from mujoco_mpc_tpu_torch.physics.model import Data, Model
from mujoco_mpc_tpu_torch.utils import math as tm


def _sym(p: torch.Tensor) -> torch.Tensor:
  return 0.5 * (p + p.transpose(-1, -2))


def update_measurement(m: Model, template: Data, state: base.EstimatorState,
                       ctrl: torch.Tensor, sensor: torch.Tensor,
                       sensor_slice=None) -> base.EstimatorState:
  """Correct the state by the measurements sensor (B, ns)."""
  nd = base.ndx(m)

  def h(dx):
    qp, qv, a = base.perturb(m, state.qpos, state.qvel, state.act, dx)
    y = base.measure(m, template, qp, qv, a, state.time, ctrl,
                     sensor_slice)
    return y, y

  z = torch.zeros((state.qpos.shape[0], nd), dtype=state.qpos.dtype,
                  device=state.qpos.device)
  # the prediction is the Jacobian pass's own value at dx = 0
  c, pred = tm.jacfwd_batched(h, z, has_aux=True)   # (B, ns, nd), (B, ns)
  p = state.covariance
  ct = c.transpose(-1, -2)
  s = c @ p @ ct + torch.diag_embed(state.noise_sensor)
  # K = P C' S^-1: each row of (C P)' solved against S
  gain = linalg.cholesky_solve(linalg.cholesky(s)[:, None],
                               (c @ p).transpose(-1, -2))   # (B, nd, ns)
  dx = (gain @ (sensor - pred)[..., None])[..., 0]
  qp, qv, a = base.perturb(m, state.qpos, state.qvel, state.act, dx)
  eye = torch.eye(nd, dtype=p.dtype, device=p.device)
  p_new = _sym((eye - gain @ c) @ p)
  return state.replace(qpos=qp, qvel=qv, act=a, covariance=p_new)


def update_prediction(m: Model, template: Data, state: base.EstimatorState,
                      ctrl: torch.Tensor) -> base.EstimatorState:
  """Step the state and propagate its covariance: P <- A P A' + Q."""
  nd = base.ndx(m)

  def f(dx):
    qp, qv, a = base.perturb(m, state.qpos, state.qvel, state.act, dx)
    nxt = base.predict(m, template, qp, qv, a, state.time, ctrl)
    # the difference from the step's own value, which at dx = 0 is JAX's
    # separately stepped state; detached, it carries no tangent
    ref = [x.detach() for x in nxt[:3]]
    return base.difference(m, *ref, *nxt[:3]), nxt

  z = torch.zeros((state.qpos.shape[0], nd), dtype=state.qpos.dtype,
                  device=state.qpos.device)
  a_jac, (qpos_n, qvel_n, act_n, time_n) = tm.jacfwd_batched(
      f, z, has_aux=True)                           # (B, nd, nd)
  p = (a_jac @ state.covariance @ a_jac.transpose(-1, -2)
       + torch.diag_embed(state.noise_process))
  return state.replace(qpos=qpos_n, qvel=qvel_n, act=act_n, time=time_n,
                       covariance=_sym(p))


def update(m: Model, template: Data, state: base.EstimatorState,
           ctrl: torch.Tensor, sensor: torch.Tensor,
           sensor_slice=None) -> base.EstimatorState:
  """One control period: the measurement update, then the prediction."""
  state = update_measurement(m, template, state, ctrl, sensor, sensor_slice)
  return update_prediction(m, template, state, ctrl)
