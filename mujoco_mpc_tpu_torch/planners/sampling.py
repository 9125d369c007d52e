"""Predictive Sampling planner: batched noisy-spline search.

Port of mujoco_mpc_tpu/planners/sampling.py (SamplingPolicy :39,
SamplingConfig :46, default_policy :54, default_config :68,
action_from_policy :78, resample_nominal :87, sample_candidates :98,
candidate_actions :137, rollout_candidates :151, optimize :161).

sample_candidates is split in two: `sample_noise` draws the Gaussian noise
and the mixture choice from a torch.Generator, and `candidates_from_noise`
turns given noise into candidates. jax.random and torch draw different
streams, so tests and the card-vs-CPU golden check hand both sides the
same noise through the second half; `optimize` takes the noise as input.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from mujoco_mpc_tpu_torch.ops import spline
from mujoco_mpc_tpu_torch.physics.model import Data
from mujoco_mpc_tpu_torch.planners import rollout
from mujoco_mpc_tpu_torch.tasks.base import TaskParams, TaskSpec

# proportion of samples drawn with the second std (sampling/planner.cc:322)
STD2_PROPORTION = 0.2


@dataclasses.dataclass(frozen=True)
class SamplingPolicy:
  """Spline control plan with a fixed knot count."""
  times: torch.Tensor   # (P,)
  values: torch.Tensor  # (P, nu)


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
  """Planner hyperparameters, 0-d tensors."""
  noise_std: torch.Tensor
  noise_std2: torch.Tensor     # second std of the mixture (0 = off)
  timestep: torch.Tensor       # planning timestep
  horizon_time: torch.Tensor   # planning duration (seconds)


def default_policy(spec: TaskSpec, num_points: int) -> SamplingPolicy:
  """Initial plan: the home keyframe's ctrl if the model has one, else 0."""
  m = spec.model
  if 'home' in m.keyframe_names:
    u0 = m.key_ctrl[m.keyframe_names.index('home')]
  else:
    u0 = torch.zeros(m.nu, dtype=m.dtype, device=m.device)
  return SamplingPolicy(
      times=torch.linspace(0.0, 1.0, num_points, dtype=m.dtype,
                           device=m.device),
      values=u0.repeat(num_points, 1))


def default_config(spec: TaskSpec) -> SamplingConfig:
  m = spec.model
  cfg = spec.config
  t = lambda v: torch.as_tensor(v, dtype=m.dtype, device=m.device)  # noqa: E731
  return SamplingConfig(
      noise_std=t(cfg.get('sampling_exploration', 0.1)),
      noise_std2=t(0.0),
      timestep=(t(cfg['agent_timestep']) if 'agent_timestep' in cfg
                else m.opt.timestep),
      horizon_time=t(cfg.get('agent_horizon', 1.0)))


def _ctrl_bounds(spec: TaskSpec):
  r = spec.model.actuator_ctrlrange
  return r[:, 0], r[:, 1]


def action_from_policy(spec: TaskSpec, policy: SamplingPolicy,
                       time: torch.Tensor, interp: int) -> torch.Tensor:
  """Actions (B, nu) at times (B,), clamped (SamplingPolicy::Action)."""
  lo, hi = _ctrl_bounds(spec)
  u = spline.sample(policy.times, policy.values, time, interp)
  return torch.clamp(u, lo, hi)


def resample_nominal(spec: TaskSpec, policy: SamplingPolicy,
                     time: torch.Tensor, horizon_steps: int,
                     cfg: SamplingConfig, interp: int) -> SamplingPolicy:
  """The plan resampled onto fresh knots starting at `time` (0-d)."""
  num_points = policy.times.shape[0]
  horizon_time = (horizon_steps - 1) * cfg.timestep
  new_times = spline.knot_times(time, horizon_time, num_points, interp)
  new_values = spline.resample(policy.times, policy.values, new_times,
                               interp)
  return SamplingPolicy(times=new_times, values=new_values)


def sample_noise(spec: TaskSpec, num_points: int, num_samples: int,
                 cfg: SamplingConfig, generator: torch.Generator):
  """(eps (K, P, nu) standard normal, use2 (K,) bool: draw of the second
  std with probability STD2_PROPORTION), on the generator's device."""
  m = spec.model
  eps = torch.randn((num_samples, num_points, m.nu), generator=generator,
                    dtype=m.dtype, device=generator.device)
  use2 = torch.rand((num_samples,), generator=generator, dtype=m.dtype,
                    device=generator.device) < STD2_PROPORTION
  return eps, use2


def candidates_from_noise(spec: TaskSpec, nominal: SamplingPolicy,
                          eps: torch.Tensor, use2: torch.Tensor,
                          cfg: SamplingConfig) -> torch.Tensor:
  """(K+1, P, nu) candidate knot values, index 0 the nominal: noise scaled
  per actuator by half the ctrlrange width, clamped to ctrlrange."""
  lo, hi = _ctrl_bounds(spec)
  scale = 0.5 * (hi - lo)
  use2 = torch.logical_and(cfg.noise_std2 > 0, use2)
  std = torch.where(use2, cfg.noise_std2, cfg.noise_std)
  noise = eps * std[:, None, None] * scale
  candidates = torch.cat([nominal.values[None], nominal.values[None] + noise])
  return torch.clamp(candidates, lo, hi)


def candidate_actions(times: torch.Tensor, values: torch.Tensor,
                      horizon_steps: int, timestep: torch.Tensor,
                      interp: int) -> torch.Tensor:
  """Knots (K, P, nu) to actions (K, T, nu) on the rollout grid, the last
  action repeating the one before it (trajectory.cc:283-291)."""
  t0 = times[0]
  steps = torch.arange(horizon_steps, dtype=times.dtype, device=times.device)
  ts = t0 + steps * timestep
  acts = spline.sample_many(times, values, ts, interp)
  if horizon_steps > 1:
    acts = torch.cat([acts[:, :-1], acts[:, -2:-1]], dim=1)
  return acts


def rollout_candidates(spec: TaskSpec, d0: Data, times: torch.Tensor,
                       candidates: torch.Tensor, params: TaskParams,
                       horizon_steps: int, cfg: SamplingConfig,
                       interp: int) -> torch.Tensor:
  """(K+1,) total returns of all candidates."""
  acts = candidate_actions(times, candidates, horizon_steps, cfg.timestep,
                           interp)
  return rollout.batched_returns(spec, d0, acts, params)


def optimize(spec: TaskSpec, policy: SamplingPolicy, d0: Data,
             params: TaskParams, cfg: SamplingConfig,
             noise: Tuple[torch.Tensor, torch.Tensor], horizon_steps: int,
             interp: int) -> Tuple[SamplingPolicy, dict]:
  """One OptimizePolicy iteration (planner.cc:190-208) from the B = 1
  state d0, with noise = sample_noise(...) or given noise."""
  nominal = resample_nominal(spec, policy, d0.time[0], horizon_steps, cfg,
                             interp)
  candidates = candidates_from_noise(spec, nominal, *noise, cfg)
  returns = rollout_candidates(spec, d0, nominal.times, candidates, params,
                               horizon_steps, cfg, interp)
  winner = torch.argmin(returns)
  new_policy = SamplingPolicy(times=nominal.times, values=candidates[winner])
  info = {
      'returns': returns,
      'winner': winner,
      'best_return': returns[winner],
      'nominal_return': returns[0],
      'improvement': torch.clamp(returns[0] - returns[winner], min=0.0),
  }
  return new_policy, info
