"""Gradient (Pontryagin) planner: adjoint sweep and log-spaced line search.

Port of mujoco_mpc_tpu/planners/gradient_planner.py (MIN_LINESEARCH_STEP
:26, GradientConfig :29, default_config :35, adjoint_sweep :44, optimize
:63). The backward recursion Vx_t = cx_t + A_t' Vx_{t+1}, Qu_t = cu_t +
B_t' Vx_{t+1} is a reverse Python loop of T - 1 small products (JAX: a
reverse lax.scan), as ilqg.riccati is. The per-step improvement maps to
the knots through the transposed spline mapping, and the candidates are a
line search of steps log-spaced from 1 to MIN_LINESEARCH_STEP plus a zero
step (the nominal), rolled out as one batch.

The nominal rollout and the derivative pass are
planners/derivatives.nominal_trajectory and compute, as iLQG's: on the
card both kernels run in the rollouts and carry their tangents in the
derivative pass.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from mujoco_mpc_tpu_torch.physics.model import Data
from mujoco_mpc_tpu_torch.planners import derivatives, sampling
from mujoco_mpc_tpu_torch.tasks.base import TaskParams, TaskSpec

# reference: gradient/settings.h:23
MIN_LINESEARCH_STEP = 1.0e-8


@dataclasses.dataclass(frozen=True)
class GradientConfig:
  timestep: torch.Tensor
  horizon_time: torch.Tensor


def default_config(spec: TaskSpec) -> GradientConfig:
  m = spec.model
  cfg = spec.config
  t = lambda v: torch.as_tensor(v, dtype=m.dtype, device=m.device)  # noqa: E731
  return GradientConfig(
      timestep=(t(cfg['agent_timestep']) if 'agent_timestep' in cfg
                else m.opt.timestep),
      horizon_time=t(cfg.get('agent_horizon', 1.0)))


def adjoint_sweep(derivs: derivatives.Derivatives):
  """The backward sweep: (Qu (T-1, nu), k = -Qu, dV = sum k Qu)."""
  a, b, cx, cu = derivs.a, derivs.b, derivs.cx, derivs.cu
  tm1 = a.shape[0]
  vx = cx[-1]
  qus = [None] * tm1
  for t in reversed(range(tm1)):
    qus[t] = cu[t] + b[t].T @ vx
    vx = cx[t] + a[t].T @ vx
  qu = torch.stack(qus)
  k = -qu
  return qu, k, torch.sum(k * qu)


def linesearch_steps(num_candidates: int, dtype, device=None):
  """(K,): K - 1 steps log-spaced from 1 to MIN_LINESEARCH_STEP, then 0."""
  exps = torch.linspace(0.0, math.log10(MIN_LINESEARCH_STEP),
                        num_candidates - 1, dtype=dtype, device=device)
  return torch.cat([torch.pow(10.0, exps),
                    torch.zeros(1, dtype=dtype, device=device)])


def optimize(spec: TaskSpec, policy: sampling.SamplingPolicy, d0: Data,
             params: TaskParams, cfg: GradientConfig, num_candidates: int,
             horizon_steps: int,
             interp: int) -> Tuple[sampling.SamplingPolicy, dict]:
  """One gradient-descent iteration from the B = 1 state d0."""
  zero = torch.zeros((), dtype=policy.values.dtype,
                     device=policy.values.device)
  scfg = sampling.SamplingConfig(noise_std=zero, noise_std2=zero,
                                 timestep=cfg.timestep,
                                 horizon_time=cfg.horizon_time)
  nominal = sampling.resample_nominal(spec, policy, d0.time[0],
                                      horizon_steps, scfg, interp)
  actions = sampling.candidate_actions(nominal.times, nominal.values[None],
                                       horizon_steps, cfg.timestep,
                                       interp)[0]
  traj = derivatives.nominal_trajectory(spec, d0, actions, params)
  derivs = derivatives.compute(spec, d0, traj, params)
  qu, k, dv = adjoint_sweep(derivs)

  # the per-step improvement on the knots: update = M' k
  mapping = derivatives.spline_mapping(nominal.times, traj.time[:-1], interp)
  update = mapping.T @ k                                   # (P, nu)

  steps = linesearch_steps(num_candidates, update.dtype, update.device)
  r = spec.model.actuator_ctrlrange
  candidates = torch.clamp(
      nominal.values[None] + steps[:, None, None] * update[None], r[:, 0],
      r[:, 1])
  returns = sampling.rollout_candidates(spec, d0, nominal.times, candidates,
                                        params, horizon_steps, scfg, interp)
  winner = torch.argmin(returns)
  nominal_return = returns[-1]
  new_policy = sampling.SamplingPolicy(times=nominal.times,
                                       values=candidates[winner])
  info = {
      'returns': returns,
      'winner': winner,
      'best_return': returns[winner],
      'nominal_return': nominal_return,
      'improvement': torch.clamp(nominal_return - returns[winner], min=0.0),
      'action_step': steps[winner],
      'expected': -steps[winner] * dv - 1.0e-16,
      'qu_norm': torch.linalg.norm(qu),
  }
  return new_policy, info
