"""Planner registry: one interface over the planners.

Port of mujoco_mpc_tpu/planners/registry.py (PLANNER_NAMES :25, the ids
:28, PlannerDef :31, make_planner :42) for the planners the port has:
Sampling and iLQG. Each planner is a set of functions over an opaque
state:

    init() -> state
    optimize(state, d0, params, generator) -> (state, info)
    action(state, qpos, qvel, act, time) -> (B, nu)
    nominal_action(state, qpos, qvel, act, time) -> (B, nu)

with d0 the B = 1 state and `generator` the torch.Generator that
Predictive Sampling draws its noise from (JAX passes a key; iLQG draws
nothing). The other planner ids raise NotImplementedError naming their
queue item.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from mujoco_mpc_tpu_torch.ops import spline
from mujoco_mpc_tpu_torch.planners import ilqg
from mujoco_mpc_tpu_torch.planners import sampling
from mujoco_mpc_tpu_torch.tasks.base import TaskSpec

PLANNER_NAMES = ('Sampling', 'Gradient', 'iLQG', 'iLQS', 'Robust Sampling',
                 'Cross Entropy', 'Sample Gradient')

SAMPLING, GRADIENT, ILQG, ILQS, ROBUST, CEM, SAMPLE_GRADIENT = range(7)

# planner id -> the ROADMAP queue item that ports it
_NOT_PORTED = {GRADIENT: 'A9', ILQS: 'A9', ROBUST: 'A10', CEM: 'A10',
               SAMPLE_GRADIENT: 'A10'}


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
  if planner_id in _NOT_PORTED:
    raise NotImplementedError(
        f'planner {PLANNER_NAMES[planner_id]} is not ported yet (ROADMAP '
        f'{_NOT_PORTED[planner_id]})')

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

    nominal_action = action

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

  else:
    raise ValueError(f'unknown planner id {planner_id}')

  return PlannerDef(init=init, optimize=optimize, action=action,
                    nominal_action=nominal_action)
