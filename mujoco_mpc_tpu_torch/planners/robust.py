"""Robust planner: re-score the top candidates under body-force noise.

Port of mujoco_mpc_tpu/planners/robust.py (DEFAULT_NCANDIDATES :33,
RobustConfig :37, default_config :43, optimize_ranked :51, optimize :94),
the reference's RobustPlanner (robust_planner.cc:91-155): a decorator
over any ranked planner (planners/ranked.py). The delegate returns its
top N candidates; each is rolled out R more times under
Ornstein-Uhlenbeck xfrc_applied perturbations, its score averaged with
those of the rollouts that did not fail, and the best average is promoted
through the delegate's select(). The N x R re-rollouts run as one batch of
B = N R.

`sample_noise` draws the delegate's noise and the perturbations
(N R, T, nbody, 6) from a torch.Generator; JAX splits one key into a
sample key and a noise key, then the noise key into N R keys, each into T.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from mujoco_mpc_tpu_torch.physics.model import Data
from mujoco_mpc_tpu_torch.planners import ranked, rollout, sampling
from mujoco_mpc_tpu_torch.tasks.base import TaskParams, TaskSpec

# reference defaults (robust_planner.h:67-72)
DEFAULT_NCANDIDATES = 12
DEFAULT_NREPETITIONS = 5


@dataclasses.dataclass(frozen=True)
class RobustConfig:
  xfrc_std: torch.Tensor
  xfrc_rate: torch.Tensor


def default_config(spec: TaskSpec) -> RobustConfig:
  m = spec.model
  cfg = spec.config
  t = lambda v: torch.as_tensor(v, dtype=m.dtype, device=m.device)  # noqa: E731
  return RobustConfig(xfrc_std=t(cfg.get('robust_xfrc', 0.2)),
                      xfrc_rate=t(cfg.get('robust_xfrc_rate', 0.1)))


def sample_noise(spec: TaskSpec, delegate: ranked.RankedDelegate,
                 ncandidates: int, nrepetitions: int, horizon_steps: int,
                 generator: torch.Generator):
  """(the delegate's noise, eps (N R, T, nbody, 6) standard normal)."""
  m = spec.model
  eps = torch.randn((ncandidates * nrepetitions, horizon_steps, m.nbody, 6),
                    generator=generator, dtype=m.dtype,
                    device=generator.device)
  return delegate.sample_noise(generator), eps


def optimize_ranked(spec: TaskSpec, delegate: ranked.RankedDelegate,
                    state: Any, d0: Data, params: TaskParams,
                    rcfg: RobustConfig, noise, ncandidates: int,
                    nrepetitions: int, horizon_steps: int,
                    interp: int) -> Tuple[Any, dict]:
  """One robust iteration over any ranked delegate from the B = 1 state
  d0, with noise = sample_noise(...) or given noise."""
  delegate_noise, eps = noise
  rc = delegate.optimize_candidates(state, d0, params, delegate_noise,
                                    ncandidates)
  values = torch.repeat_interleave(rc.values, nrepetitions, dim=0)
  acts = sampling.candidate_actions(rc.times, values, horizon_steps,
                                    delegate.timestep, interp)
  noisy = rollout.noisy_rollout_return(
      spec, d0, acts, params, eps, rcfg.xfrc_std, rcfg.xfrc_rate).reshape(
          ncandidates, nrepetitions)
  # average in the nominal score, leaving the failed rollouts out
  valid = noisy < rollout.MAX_RETURN_VALUE
  noisy_sum = torch.sum(torch.where(valid, noisy, torch.zeros_like(noisy)),
                        dim=1)
  nvalid = torch.sum(valid, dim=1).to(noisy.dtype)
  mean_return = (rc.scores + noisy_sum) / (1.0 + nvalid)
  winner = torch.argmin(mean_return)
  info = {
      'best_return': rc.scores[winner],
      'best_robust_score': mean_return[winner],
      'nominal_return': rc.scores[0],
      'winner': winner,
  }
  return delegate.select(rc, winner), info


def optimize(spec: TaskSpec, policy: sampling.SamplingPolicy, d0: Data,
             params: TaskParams, scfg: sampling.SamplingConfig,
             rcfg: RobustConfig, noise, num_samples: int, ncandidates: int,
             nrepetitions: int, horizon_steps: int,
             interp: int) -> Tuple[sampling.SamplingPolicy, dict]:
  """Robust over Sampling, the reference's instantiation."""
  delegate = ranked.make_sampling_delegate(
      spec, scfg, num_samples, policy.times.shape[0], horizon_steps, interp)
  return optimize_ranked(spec, delegate, policy, d0, params, rcfg, noise,
                         ncandidates, nrepetitions, horizon_steps, interp)
