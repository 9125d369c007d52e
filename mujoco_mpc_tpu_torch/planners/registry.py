"""Planner registry: one interface over the seven planners.

Port of mujoco_mpc_tpu/planners/registry.py (PLANNER_NAMES :25, the ids
:28, PlannerDef :31, make_planner :42), with the same ids and sizes. Each
planner is a set of functions over an opaque state:

    init() -> state
    optimize(state, d0, params, generator) -> (state, info)
    action(state, qpos, qvel, act, time) -> (B, nu)
    nominal_action(state, qpos, qvel, act, time) -> (B, nu)

with d0 the B = 1 state and `generator` the torch.Generator the planner
draws its noise from, on the model's device (JAX passes a key; iLQG and
Gradient draw nothing and take None).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from mujoco_mpc_tpu_torch.ops import spline
from mujoco_mpc_tpu_torch.planners import (cross_entropy, gradient_planner,
                                           ilqg, ilqs, ranked, robust,
                                           sample_gradient, sampling)
from mujoco_mpc_tpu_torch.tasks.base import TaskSpec

PLANNER_NAMES = ('Sampling', 'Gradient', 'iLQG', 'iLQS', 'Robust Sampling',
                 'Cross Entropy', 'Sample Gradient')

SAMPLING, GRADIENT, ILQG, ILQS, ROBUST, CEM, SAMPLE_GRADIENT = range(7)


def num_gradient_candidates(num_samples: int) -> int:
  """Sample Gradient's gradient candidates (registry.py:115, :165)."""
  return min(8, max(num_samples // 8, 1))


@dataclasses.dataclass(frozen=True)
class PlannerDef:
  init: Callable[..., Any]
  optimize: Callable[..., Tuple[Any, dict]]
  action: Callable[..., torch.Tensor]
  # the action without feedback terms (GetAction nominal_action); differs
  # from `action` only for the feedback planners
  nominal_action: Callable[..., torch.Tensor] = None


def make_planner(spec: TaskSpec, planner_id: int, num_samples: int,
                 horizon_steps: int, num_points: int,
                 interp: int = spline.Interp.ZERO) -> PlannerDef:
  """The interface of one planner on one task, in the task model's dtype
  and on its device."""
  interp = int(interp)

  if planner_id == SAMPLING:
    cfg = sampling.default_config(spec)

    def init():
      return sampling.default_policy(spec, num_points)

    def optimize(state, d0, params, generator):
      noise = sampling.sample_noise(spec, num_points, num_samples, cfg,
                                    generator)
      return sampling.optimize(spec, state, d0, params, cfg, noise,
                               horizon_steps, interp)

    def action(state, qpos, qvel, act, time):
      return sampling.action_from_policy(spec, state, time, interp)

  elif planner_id == GRADIENT:
    cfg = gradient_planner.default_config(spec)

    def init():
      return sampling.default_policy(spec, num_points)

    def optimize(state, d0, params, generator=None):
      return gradient_planner.optimize(spec, state, d0, params, cfg,
                                       num_samples, horizon_steps, interp)

    def action(state, qpos, qvel, act, time):
      return sampling.action_from_policy(spec, state, time, interp)

  elif planner_id == ILQG:
    cfg = ilqg.default_config(spec)

    def init():
      return ilqg.default_state(spec, horizon_steps)

    def optimize(state, d0, params, generator=None):
      return ilqg.optimize(spec, state, d0, params, cfg, num_samples,
                           horizon_steps)

    def action(state, qpos, qvel, act, time):
      return ilqg.action_from_policy(spec, state.policy, qpos, qvel, act,
                                     time)

    def nominal_action(state, qpos, qvel, act, time):
      return ilqg.nominal_action_from_policy(spec, state.policy, time)

  elif planner_id == ILQS:
    scfg = sampling.default_config(spec)
    icfg = ilqg.default_config(spec)

    def init():
      return ilqs.default_state(spec, num_points, horizon_steps)

    def optimize(state, d0, params, generator):
      noise = sampling.sample_noise(spec, num_points, num_samples, scfg,
                                    generator)
      return ilqs.optimize(spec, state, d0, params, scfg, icfg, noise,
                           max(num_samples // 4, 4), horizon_steps, interp)

    def action(state, qpos, qvel, act, time):
      return ilqs.action_from_policy(spec, state, qpos, qvel, act, time,
                                     interp)

    def nominal_action(state, qpos, qvel, act, time):
      return ilqs.nominal_action_from_policy(spec, state, time, interp)

  elif planner_id == ROBUST:
    # a decorator over any ranked planner (planner.h:84-102); the delegate
    # comes from the `robust_delegate` MJCF custom numeric (0 Sampling,
    # the reference's instantiation, include.cc:48-49; 5 Cross Entropy;
    # 6 Sample Gradient)
    rcfg = robust.default_config(spec)
    delegate_id = int(spec.config.get('robust_delegate', SAMPLING))
    if delegate_id == CEM:
      delegate = ranked.make_cem_delegate(
          spec, cross_entropy.default_config(spec), num_samples, num_points,
          horizon_steps, interp)
    elif delegate_id == SAMPLE_GRADIENT:
      delegate = ranked.make_sample_gradient_delegate(
          spec, sample_gradient.default_config(spec), num_samples,
          num_gradient_candidates(num_samples), num_points, horizon_steps,
          interp)
    else:
      delegate = ranked.make_sampling_delegate(
          spec, sampling.default_config(spec), num_samples, num_points,
          horizon_steps, interp)
    ncandidates = min(robust.DEFAULT_NCANDIDATES, num_samples)

    def init():
      return delegate.init()

    def optimize(state, d0, params, generator):
      noise = robust.sample_noise(spec, delegate, ncandidates,
                                  robust.DEFAULT_NREPETITIONS, horizon_steps,
                                  generator)
      return robust.optimize_ranked(
          spec, delegate, state, d0, params, rcfg, noise, ncandidates,
          robust.DEFAULT_NREPETITIONS, horizon_steps, interp)

    def action(state, qpos, qvel, act, time):
      return delegate.action(state, time)

  elif planner_id == CEM:
    cfg = cross_entropy.default_config(spec)

    def init():
      return cross_entropy.default_state(spec, num_points, cfg)

    def optimize(state, d0, params, generator):
      eps = cross_entropy.sample_noise(spec, num_points, num_samples,
                                       generator)
      return cross_entropy.optimize(spec, state, d0, params, cfg, eps,
                                    max(num_samples // 10, 2), horizon_steps,
                                    interp)

    def action(state, qpos, qvel, act, time):
      return cross_entropy.action_from_policy(spec, state, time, interp)

  elif planner_id == SAMPLE_GRADIENT:
    cfg = sample_gradient.default_config(spec)
    num_gradient = num_gradient_candidates(num_samples)

    def init():
      return sample_gradient.default_state(spec, num_points)

    def optimize(state, d0, params, generator):
      eps = sample_gradient.sample_noise(spec, num_points, num_samples,
                                         num_gradient, generator)
      return sample_gradient.optimize(spec, state, d0, params, cfg, eps,
                                      num_samples, num_gradient,
                                      horizon_steps, interp)

    def action(state, qpos, qvel, act, time):
      return sampling.action_from_policy(spec, state.policy, time, interp)

  else:
    raise ValueError(f'unknown planner id {planner_id}')

  if planner_id not in (ILQG, ILQS):
    nominal_action = action
  return PlannerDef(init=init, optimize=optimize, action=action,
                    nominal_action=nominal_action)
