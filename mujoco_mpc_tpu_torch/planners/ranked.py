"""Ranked planners: the sampling family behind one candidate surface.

Port of mujoco_mpc_tpu/planners/ranked.py (RankedCandidates :33,
RankedDelegate :41, _rank :54, make_sampling_delegate :59,
make_cem_delegate :93, make_sample_gradient_delegate :139), the
reference's RankedPlanner (planner.h:84-102): a planner that returns its
top-N candidates ranked best first and promotes any of them to its
nominal. The Robust decorator (planners/robust.py) wraps any of the
three.

A delegate draws its noise with `sample_noise(generator)` and takes it in
`optimize_candidates(state, d0, params, noise, ncandidates)`, so both
packages can be handed the same draws. `select` rebuilds the delegate's
whole state around the chosen candidate: CEM's refit variance and Sample
Gradient's gradient and previous gradient travel in `aux`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from mujoco_mpc_tpu_torch.planners import cross_entropy, sample_gradient
from mujoco_mpc_tpu_torch.planners import sampling
from mujoco_mpc_tpu_torch.tasks.base import TaskSpec


class RankedCandidates(NamedTuple):
  """Top-N candidates, best (lowest return) first."""
  times: torch.Tensor    # (P,) shared knot times
  values: torch.Tensor   # (N, P, nu) candidate knot values
  scores: torch.Tensor   # (N,) returns, ascending
  aux: Any               # what select() needs beside the winner


@dataclasses.dataclass(frozen=True)
class RankedDelegate:
  """The RankedPlanner surface as functions over an opaque state."""
  init: Callable[[], Any]
  # generator -> the noise optimize_candidates takes
  sample_noise: Callable[[torch.Generator], Any]
  # (state, d0, params, noise, ncandidates) -> RankedCandidates
  optimize_candidates: Callable[..., RankedCandidates]
  # (candidates, winner index) -> new planner state
  select: Callable[[RankedCandidates, torch.Tensor], Any]
  # (state, time (B,)) -> (B, nu)
  action: Callable[..., torch.Tensor]
  timestep: torch.Tensor


def _rank(returns: torch.Tensor, ncandidates: int):
  """(scores, indices) of the ncandidates lowest returns, ascending, the
  lower index first among equal returns (lax.top_k of -returns)."""
  return cross_entropy.elites(returns, ncandidates)


def make_sampling_delegate(spec: TaskSpec, cfg: sampling.SamplingConfig,
                           num_samples: int, num_points: int,
                           horizon_steps: int,
                           interp: int) -> RankedDelegate:
  """Predictive Sampling as a ranked planner (sampling/planner.cc:151-187
  OptimizePolicyCandidates)."""

  def init():
    return sampling.default_policy(spec, num_points)

  def sample_noise(generator):
    return sampling.sample_noise(spec, num_points, num_samples, cfg,
                                 generator)

  def optimize_candidates(state, d0, params, noise, ncandidates):
    nominal = sampling.resample_nominal(spec, state, d0.time[0],
                                        horizon_steps, cfg, interp)
    candidates = sampling.candidates_from_noise(spec, nominal, *noise, cfg)
    returns = sampling.rollout_candidates(
        spec, d0, nominal.times, candidates, params, horizon_steps, cfg,
        interp)
    scores, idx = _rank(returns, ncandidates)
    return RankedCandidates(times=nominal.times, values=candidates[idx],
                            scores=scores, aux=None)

  def select(rc, winner):
    return sampling.SamplingPolicy(times=rc.times, values=rc.values[winner])

  def action(state, time):
    return sampling.action_from_policy(spec, state, time, interp)

  return RankedDelegate(init=init, sample_noise=sample_noise,
                        optimize_candidates=optimize_candidates,
                        select=select, action=action, timestep=cfg.timestep)


def make_cem_delegate(spec: TaskSpec, cfg: cross_entropy.CEMConfig,
                      num_samples: int, num_points: int, horizon_steps: int,
                      interp: int) -> RankedDelegate:
  """CEM as a ranked planner: the ranked candidates are the elites, and
  the variance refit from them is carried through select()."""
  scfg = cross_entropy.sampling_config(cfg)

  def init():
    return cross_entropy.default_state(spec, num_points, cfg)

  def sample_noise(generator):
    return cross_entropy.sample_noise(spec, num_points, num_samples,
                                      generator)

  def optimize_candidates(state, d0, params, eps, ncandidates):
    nominal = sampling.resample_nominal(spec, state.policy, d0.time[0],
                                        horizon_steps, scfg, interp)
    candidates = cross_entropy.candidates_from_noise(
        spec, nominal, state.variance, eps, cfg)
    returns = sampling.rollout_candidates(
        spec, d0, nominal.times, candidates, params, horizon_steps, scfg,
        interp)
    scores, idx = _rank(returns, ncandidates)
    _, var = cross_entropy.refit(candidates, idx)
    return RankedCandidates(times=nominal.times, values=candidates[idx],
                            scores=scores, aux=var)

  def select(rc, winner):
    return cross_entropy.CEMState(
        policy=sampling.SamplingPolicy(times=rc.times,
                                       values=rc.values[winner]),
        variance=rc.aux)

  def action(state, time):
    return cross_entropy.action_from_policy(spec, state, time, interp)

  return RankedDelegate(init=init, sample_noise=sample_noise,
                        optimize_candidates=optimize_candidates,
                        select=select, action=action, timestep=cfg.timestep)


def make_sample_gradient_delegate(spec: TaskSpec,
                                  cfg: sample_gradient.SGConfig,
                                  num_samples: int, num_gradient: int,
                                  num_points: int, horizon_steps: int,
                                  interp: int) -> RankedDelegate:
  """Sample Gradient as a ranked planner: the noisy and the gradient
  candidates are ranked together, and the refit gradient is carried
  through select()."""
  scfg = sample_gradient.sampling_config(cfg)
  _, ng = sample_gradient.split(num_samples, num_gradient)

  def init():
    return sample_gradient.default_state(spec, num_points)

  def sample_noise(generator):
    return sample_gradient.sample_noise(spec, num_points, num_samples, ng,
                                        generator)

  def optimize_candidates(state, d0, params, eps, ncandidates):
    nominal = sampling.resample_nominal(spec, state.policy, d0.time[0],
                                        horizon_steps, scfg, interp)
    candidates, noise = sample_gradient.candidates_from_noise(
        spec, state, nominal, eps, cfg, ng)
    returns = sampling.rollout_candidates(
        spec, d0, nominal.times, candidates, params, horizon_steps, scfg,
        interp)
    gradient = sample_gradient.fit_gradient(returns, noise)
    scores, idx = _rank(returns, ncandidates)
    return RankedCandidates(times=nominal.times, values=candidates[idx],
                            scores=scores, aux=(gradient, state.gradient))

  def select(rc, winner):
    gradient, gradient_prev = rc.aux
    return sample_gradient.SGState(
        policy=sampling.SamplingPolicy(times=rc.times,
                                       values=rc.values[winner]),
        gradient=gradient, gradient_prev=gradient_prev)

  def action(state, time):
    return sampling.action_from_policy(spec, state.policy, time, interp)

  return RankedDelegate(init=init, sample_noise=sample_noise,
                        optimize_candidates=optimize_candidates,
                        select=select, action=action, timestep=cfg.timestep)
