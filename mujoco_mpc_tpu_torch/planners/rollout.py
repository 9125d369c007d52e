"""Batched rollouts: a Python loop over the horizon, batch-first.

Port of mujoco_mpc_tpu/planners/rollout.py (MAX_RETURN_VALUE :30,
rollout_actions :33, batched_returns :65, total_return :79,
rollout_return :85, noisy_rollout_return :91). JAX batches one
candidate's lax.scan with vmap; here every step advances all candidates
at once. Semantics as in JAX: the
residual of step t is taken at (x_t, u_t) after forward and before
integration; only (time, qpos, qvel, act) carry from step to step; the
return is the mean cost over the horizon, and a non-finite return becomes
MAX_RETURN_VALUE.

noisy_rollout_return takes its Ornstein-Uhlenbeck noise as a tensor
(B, T, nbody, 6) in place of JAX's split(key, T) per rollout, so that a
caller can hand both packages the same draws.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mujoco_mpc_tpu_torch.physics import forward as fwd
from mujoco_mpc_tpu_torch.physics.model import Data
from mujoco_mpc_tpu_torch.tasks.base import TaskParams, TaskSpec

# reference: trajectory.cc:29
MAX_RETURN_VALUE = 1.0e6


def rollout_actions(spec: TaskSpec, d0: Data, actions: torch.Tensor,
                    params: TaskParams) -> Tuple[torch.Tensor, torch.Tensor]:
  """Roll out action sequences (B, T, nu) from d0 (batch B or 1); returns
  (residuals (B, T, nres), costs (B, T))."""
  m = spec.model
  bsz, t_steps = actions.shape[:2]
  if d0.batch != bsz:
    d0 = d0.expand(bsz)
  t, qpos, qvel, act = d0.time, d0.qpos, d0.qvel, d0.act
  residuals = []
  for k in range(t_steps):
    d = d0.replace(time=t, qpos=qpos, qvel=qvel, act=act, ctrl=actions[:, k])
    d = fwd.forward(m, d)
    residuals.append(spec.residual_fn(m, d, params.residual_params))
    d = fwd.integrate(m, d)
    t, qpos, qvel, act = d.time, d.qpos, d.qvel, d.act
  residuals = torch.stack(residuals, dim=1)
  return residuals, spec.cost(residuals, params)


def total_return(costs: torch.Tensor) -> torch.Tensor:
  """Mean cost over the horizon (last axis), divergence -> MAX_RETURN_VALUE."""
  ret = torch.mean(costs, dim=-1)
  return torch.where(torch.isfinite(ret), ret,
                     torch.full_like(ret, MAX_RETURN_VALUE))


def batched_returns(spec: TaskSpec, d0: Data, actions: torch.Tensor,
                    params: TaskParams) -> torch.Tensor:
  """Total returns (B,) of action sequences (B, T, nu)."""
  return total_return(rollout_actions(spec, d0, actions, params)[1])


def rollout_return(spec: TaskSpec, d0: Data, actions: torch.Tensor,
                   params: TaskParams) -> torch.Tensor:
  """Total return of one action sequence (T, nu) from a B = 1 state."""
  return batched_returns(spec, d0, actions[None], params)[0]


def noisy_rollout_return(spec: TaskSpec, d0: Data, actions: torch.Tensor,
                         params: TaskParams, eps: torch.Tensor,
                         xfrc_std: torch.Tensor,
                         xfrc_rate: torch.Tensor) -> torch.Tensor:
  """Total returns (B,) of action sequences (B, T, nu) under
  Ornstein-Uhlenbeck body wrenches (Trajectory::NoisyRollout): at step t
  every body's xfrc_applied becomes xfrc (1 - rate) + eps[:, t] std,
  starting from zeros whatever d0 holds; eps (B, T, nbody, 6) standard
  normal."""
  m = spec.model
  bsz, t_steps = actions.shape[:2]
  if d0.batch != bsz:
    d0 = d0.expand(bsz)
  t, qpos, qvel, act = d0.time, d0.qpos, d0.qvel, d0.act
  # a new tensor every step: d0's fields may be expanded views
  xfrc = torch.zeros((bsz, m.nbody, 6), dtype=qpos.dtype, device=qpos.device)
  residuals = []
  for k in range(t_steps):
    xfrc = xfrc * (1.0 - xfrc_rate) + eps[:, k] * xfrc_std
    d = d0.replace(time=t, qpos=qpos, qvel=qvel, act=act, ctrl=actions[:, k],
                   xfrc_applied=xfrc)
    d = fwd.forward(m, d)
    residuals.append(spec.residual_fn(m, d, params.residual_params))
    d = fwd.integrate(m, d)
    t, qpos, qvel, act = d.time, d.qpos, d.qvel, d.act
  residuals = torch.stack(residuals, dim=1)
  return total_return(spec.cost(residuals, params))
