"""Cross-Entropy Method planner.

Port of mujoco_mpc_tpu/planners/cross_entropy.py (CEMState :28, CEMConfig
:34, default_config :42, default_state :52, optimize :60,
action_from_policy :103). Every candidate is noisy, drawn around the
resampled nominal with a per-knot std carried across iterations (floored
at std_min); the new nominal is the mean of the n_elite lowest returns and
the variance is refit from them.

`sample_noise` draws the standard normal noise (K, P, nu) from a
torch.Generator and `optimize` takes it, so both packages can be handed
the same draws. The elites are the first n_elite of a stable ascending
sort of the returns: lax.top_k puts the lower index first among equal
values, and torch.topk promises no order.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from mujoco_mpc_tpu_torch.physics.model import Data
from mujoco_mpc_tpu_torch.planners import sampling
from mujoco_mpc_tpu_torch.tasks.base import TaskParams, TaskSpec


@dataclasses.dataclass(frozen=True)
class CEMState:
  policy: sampling.SamplingPolicy
  variance: torch.Tensor   # (P, nu) per-knot sampling variance


@dataclasses.dataclass(frozen=True)
class CEMConfig:
  """0-d tensors."""
  std_initial: torch.Tensor   # initial sampling std
  std_min: torch.Tensor       # minimum std (reference default 0.1)
  timestep: torch.Tensor
  horizon_time: torch.Tensor


def default_config(spec: TaskSpec) -> CEMConfig:
  m = spec.model
  cfg = spec.config
  t = lambda v: torch.as_tensor(v, dtype=m.dtype, device=m.device)  # noqa: E731
  return CEMConfig(
      std_initial=t(cfg.get('sampling_exploration', 0.1)),
      std_min=t(cfg.get('std_min', 0.1)),
      timestep=(t(cfg['agent_timestep']) if 'agent_timestep' in cfg
                else m.opt.timestep),
      horizon_time=t(cfg.get('agent_horizon', 1.0)))


def default_state(spec: TaskSpec, num_points: int,
                  cfg: CEMConfig) -> CEMState:
  var = (cfg.std_initial ** 2).expand(num_points, spec.model.nu).clone()
  return CEMState(policy=sampling.default_policy(spec, num_points),
                  variance=var)


def sampling_config(cfg: CEMConfig) -> sampling.SamplingConfig:
  """The SamplingConfig CEM resamples and rolls out with."""
  return sampling.SamplingConfig(
      noise_std=cfg.std_initial, noise_std2=torch.zeros_like(cfg.std_initial),
      timestep=cfg.timestep, horizon_time=cfg.horizon_time)


def sample_noise(spec: TaskSpec, num_points: int, num_samples: int,
                 generator: torch.Generator) -> torch.Tensor:
  """eps (K, P, nu) standard normal, on the generator's device."""
  m = spec.model
  return torch.randn((num_samples, num_points, m.nu), generator=generator,
                     dtype=m.dtype, device=generator.device)


def candidates_from_noise(spec: TaskSpec, nominal: sampling.SamplingPolicy,
                          variance: torch.Tensor, eps: torch.Tensor,
                          cfg: CEMConfig) -> torch.Tensor:
  """(K, P, nu): the nominal plus eps times the floored per-knot std,
  clamped to ctrlrange."""
  r = spec.model.actuator_ctrlrange
  std = torch.maximum(torch.sqrt(variance), cfg.std_min)
  return torch.clamp(nominal.values[None] + eps * std[None], r[:, 0],
                     r[:, 1])


def elites(returns: torch.Tensor, n_elite: int):
  """(scores, indices) of the n_elite lowest returns, ascending, the lower
  index first among equal returns (lax.top_k of -returns)."""
  idx = torch.argsort(returns, stable=True)[:n_elite]
  return returns[idx], idx


def refit(candidates: torch.Tensor, idx: torch.Tensor):
  """(mean, variance with n - 1 in the denominator) of candidates[idx]."""
  chosen = candidates[idx]
  mean = torch.mean(chosen, dim=0)
  var = (torch.sum((chosen - mean[None]) ** 2, dim=0)
         / max(idx.shape[0] - 1, 1))
  return mean, var


def optimize(spec: TaskSpec, state: CEMState, d0: Data, params: TaskParams,
             cfg: CEMConfig, eps: torch.Tensor, n_elite: int,
             horizon_steps: int, interp: int) -> Tuple[CEMState, dict]:
  """One CEM iteration from the B = 1 state d0, with eps =
  sample_noise(...) or given noise (K = eps.shape[0] candidates)."""
  n_elite = min(n_elite, eps.shape[0])
  scfg = sampling_config(cfg)
  nominal = sampling.resample_nominal(spec, state.policy, d0.time[0],
                                      horizon_steps, scfg, interp)
  candidates = candidates_from_noise(spec, nominal, state.variance, eps, cfg)
  returns = sampling.rollout_candidates(spec, d0, nominal.times, candidates,
                                        params, horizon_steps, scfg, interp)
  scores, idx = elites(returns, n_elite)
  mean, var = refit(candidates, idx)
  avg_return = torch.mean(scores)
  new_state = CEMState(
      policy=sampling.SamplingPolicy(times=nominal.times, values=mean),
      variance=var)
  info = {
      'returns': returns,
      'best_return': scores[0],
      'elite_avg_return': avg_return,
      'improvement': torch.clamp(avg_return - scores[0], min=0.0),
  }
  return new_state, info


def action_from_policy(spec: TaskSpec, state: CEMState, time: torch.Tensor,
                       interp: int) -> torch.Tensor:
  """Actions (B, nu) of the mean plan at times (B,), clamped."""
  return sampling.action_from_policy(spec, state.policy, time, interp)
