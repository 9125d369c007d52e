"""Sample Gradient planner: random search and an NES-fitted gradient.

Port of mujoco_mpc_tpu/planners/sample_gradient.py (SGState :28, SGConfig
:35, default_config :45, default_state :58, _fitness_weights :64,
optimize :72). The candidates are the nominal, num_noisy - 1 noisy
candidates, then num_gradient candidates along the carried (filtered)
gradient with log-spaced steps; the winner is the argmin, the nominal
winning ties. The gradient is refit from the noisy candidates' ranks with
NES utility weights.

`sample_noise` draws the standard normal noise (num_noisy - 1, P, nu) from
a torch.Generator and `optimize` takes it. The ranks come from a stable
argsort, as jnp.argsort's are.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from mujoco_mpc_tpu_torch.physics.model import Data
from mujoco_mpc_tpu_torch.planners import sampling
from mujoco_mpc_tpu_torch.tasks.base import TaskParams, TaskSpec


@dataclasses.dataclass(frozen=True)
class SGState:
  policy: sampling.SamplingPolicy
  gradient: torch.Tensor        # (P, nu) fitted gradient
  gradient_prev: torch.Tensor   # (P, nu)


@dataclasses.dataclass(frozen=True)
class SGConfig:
  noise_std: torch.Tensor
  gradient_filter: torch.Tensor   # reference default 1.0
  timestep: torch.Tensor
  horizon_time: torch.Tensor
  max_step: float = 2.0           # reference
  min_step: float = 1.0e-3        # reference


def default_config(spec: TaskSpec) -> SGConfig:
  m = spec.model
  cfg = spec.config
  t = lambda v: torch.as_tensor(v, dtype=m.dtype, device=m.device)  # noqa: E731
  return SGConfig(
      noise_std=t(cfg.get('sampling_exploration', 0.1)),
      gradient_filter=t(cfg.get('sample_gradient_filter', 1.0)),
      timestep=(t(cfg['agent_timestep']) if 'agent_timestep' in cfg
                else m.opt.timestep),
      horizon_time=t(cfg.get('agent_horizon', 1.0)))


def default_state(spec: TaskSpec, num_points: int) -> SGState:
  m = spec.model
  z = torch.zeros((num_points, m.nu), dtype=m.dtype, device=m.device)
  return SGState(policy=sampling.default_policy(spec, num_points),
                 gradient=z, gradient_prev=z)


def sampling_config(cfg: SGConfig) -> sampling.SamplingConfig:
  return sampling.SamplingConfig(
      noise_std=cfg.noise_std, noise_std2=torch.zeros_like(cfg.noise_std),
      timestep=cfg.timestep, horizon_time=cfg.horizon_time)


def split(num_samples: int, num_gradient: int) -> Tuple[int, int]:
  """(num_noisy, num_gradient): at least the nominal is not a gradient
  candidate."""
  num_gradient = min(num_gradient, num_samples - 1)
  return num_samples - num_gradient, num_gradient


def _fitness_weights(num_noisy: int) -> np.ndarray:
  """NES utility weights by rank (lowest return = rank 0), float64."""
  f0 = np.log(0.5 * num_noisy + 1.0)
  u = np.maximum(0.0, f0 - np.log(np.arange(num_noisy) + 1.0))
  return u / u.sum() - 1.0 / num_noisy


def sample_noise(spec: TaskSpec, num_points: int, num_samples: int,
                 num_gradient: int,
                 generator: torch.Generator) -> torch.Tensor:
  """eps (num_noisy - 1, P, nu) standard normal, on the generator's
  device."""
  m = spec.model
  num_noisy, _ = split(num_samples, num_gradient)
  return torch.randn((num_noisy - 1, num_points, m.nu), generator=generator,
                     dtype=m.dtype, device=generator.device)


def candidates_from_noise(spec: TaskSpec, state: SGState,
                          nominal: sampling.SamplingPolicy,
                          eps: torch.Tensor, cfg: SGConfig,
                          num_gradient: int):
  """(candidates (num_noisy + num_gradient, P, nu) clamped to ctrlrange,
  noise (num_noisy - 1, P, nu)): the nominal, the noisy candidates (eps
  scaled by noise_std and half the ctrlrange width), then the steps along
  the filtered gradient, log-spaced from min_step to max_step."""
  r = spec.model.actuator_ctrlrange
  lo, hi = r[:, 0], r[:, 1]
  noise = eps * cfg.noise_std * (0.5 * (hi - lo))
  cands = [nominal.values[None], nominal.values[None] + noise]
  if num_gradient > 0:
    mixed = (cfg.gradient_filter * state.gradient
             + (1.0 - cfg.gradient_filter) * state.gradient_prev)
    exps = torch.linspace(math.log10(cfg.min_step), math.log10(cfg.max_step),
                          num_gradient, dtype=eps.dtype, device=eps.device)
    scaling = torch.pow(10.0, exps) / torch.clamp(cfg.noise_std, min=1e-8)
    cands.append(nominal.values[None] - scaling[:, None, None] * mixed[None])
  return torch.clamp(torch.cat(cands), lo, hi), noise


def fit_gradient(returns: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
  """(P, nu): the NES weights of the noisy candidates' ranks (stable
  argsort of returns[:num_noisy]) applied to their noise, the nominal's
  noise zero."""
  num_noisy = noise.shape[0] + 1
  noisy_noise = torch.cat([torch.zeros_like(noise[:1]), noise])
  order = torch.argsort(returns[:num_noisy], stable=True)
  w = torch.as_tensor(_fitness_weights(num_noisy), dtype=noise.dtype,
                      device=noise.device)
  return torch.einsum('i,ipk->pk', w, noisy_noise[order]) / num_noisy


def optimize(spec: TaskSpec, state: SGState, d0: Data, params: TaskParams,
             cfg: SGConfig, eps: torch.Tensor, num_samples: int,
             num_gradient: int, horizon_steps: int,
             interp: int) -> Tuple[SGState, dict]:
  """One Sample Gradient iteration from the B = 1 state d0 over
  num_samples candidates, with eps = sample_noise(...) or given noise."""
  num_noisy, num_gradient = split(num_samples, num_gradient)
  if eps.shape[0] != num_noisy - 1:
    raise ValueError(f'expected {num_noisy - 1} noise rows, got '
                     f'{eps.shape[0]}')
  scfg = sampling_config(cfg)
  nominal = sampling.resample_nominal(spec, state.policy, d0.time[0],
                                      horizon_steps, scfg, interp)
  candidates, noise = candidates_from_noise(spec, state, nominal, eps, cfg,
                                            num_gradient)
  returns = sampling.rollout_candidates(spec, d0, nominal.times, candidates,
                                        params, horizon_steps, scfg, interp)
  # the argmin, the nominal unless strictly better
  best = torch.argmin(returns)
  winner = torch.where(returns[best] < returns[0], best,
                       torch.zeros_like(best))
  new_state = SGState(
      policy=sampling.SamplingPolicy(times=nominal.times,
                                     values=candidates[winner]),
      gradient=fit_gradient(returns, noise), gradient_prev=state.gradient)
  info = {
      'returns': returns,
      'best_return': returns[winner],
      'nominal_return': returns[0],
      'winner': winner,
      'improvement': torch.clamp(returns[0] - returns[winner], min=0.0),
  }
  return new_state, info
