"""iLQS planner: the Predictive Sampling / iLQG hybrid.

Port of mujoco_mpc_tpu/planners/ilqs.py (ILQSState :34, default_state :40,
_trajectory_to_spline :49, optimize :67, action_from_policy :141,
nominal_action_from_policy :150), the reference's iLQSPlanner
(ilqs/planner.cc:87-240). Each iteration tries Predictive Sampling first
from the active plan; if a noisy candidate beat the nominal, sampling wins
and iLQG is skipped; otherwise eager iLQG runs, seeded with the active
plan.

* iLQG's plan -> spline: a least-squares fit of the knot values through
  the spline mapping, (M'M + 1e-8 I)^-1 M' a, with torch.linalg.solve (JAX
  solves it with jnp.linalg.solve, outside any kernel).
* spline -> iLQG: the knots expanded to the action grid and rolled out
  open loop, zero feedback gains.
* As in JAX, both conversions and the seeded iLQG state are computed every
  iteration whichever plan is active, so the state after an iteration is
  the same in both packages; the selections over `active` are
  torch.where, as JAX's jnp.where.
* JAX's lax.cond on `sampling_improved` is a host branch here: one host
  read an iteration, counted in `host_reads`. Only the iLQG run sits
  behind it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from mujoco_mpc_tpu_torch.ops import spline
from mujoco_mpc_tpu_torch.physics.model import Data
from mujoco_mpc_tpu_torch.planners import derivatives, ilqg, sampling
from mujoco_mpc_tpu_torch.tasks.base import TaskParams, TaskSpec

ACTIVE_SAMPLING = 0
ACTIVE_ILQG = 1

# host reads of `sampling_improved` by optimize's branch, counted
host_reads = 0


@dataclasses.dataclass(frozen=True)
class ILQSState:
  sampling_policy: sampling.SamplingPolicy
  ilqg_state: ilqg.ILQGState
  active: torch.Tensor   # () int32: 0 sampling, 1 iLQG


def default_state(spec: TaskSpec, num_points: int,
                  horizon_steps: int) -> ILQSState:
  return ILQSState(
      sampling_policy=sampling.default_policy(spec, num_points),
      ilqg_state=ilqg.default_state(spec, horizon_steps),
      active=torch.tensor(ACTIVE_SAMPLING, dtype=torch.int32,
                          device=spec.model.device))


def _where(cond: torch.Tensor, a, b):
  """torch.where(cond, a, b) over every tensor of two dataclasses of the
  same type (None fields stay None)."""
  if dataclasses.is_dataclass(a):
    return type(a)(**{f.name: _where(cond, getattr(a, f.name),
                                     getattr(b, f.name))
                      for f in dataclasses.fields(a)})
  if a is None:
    return None
  return torch.where(cond, a, b)


def _trajectory_to_spline(spec: TaskSpec, policy: ilqg.ILQGPolicy,
                          num_points: int, horizon_steps: int,
                          timestep: torch.Tensor,
                          interp: int) -> sampling.SamplingPolicy:
  """The least-squares spline fit of iLQG's nominal actions, clamped."""
  horizon_time = (horizon_steps - 1) * timestep
  knot_t = spline.knot_times(policy.times[0], horizon_time, num_points,
                             interp)
  mapping = derivatives.spline_mapping(knot_t, policy.times[:-1], interp)
  mtm = mapping.T @ mapping + 1e-8 * torch.eye(
      num_points, dtype=mapping.dtype, device=mapping.device)
  values = torch.linalg.solve(mtm, mapping.T @ policy.actions[:-1])
  r = spec.model.actuator_ctrlrange
  return sampling.SamplingPolicy(times=knot_t,
                                 values=torch.clamp(values, r[:, 0], r[:, 1]))


def _seeded_ilqg_state(spec: TaskSpec, state: ilqg.ILQGState,
                       nominal: sampling.SamplingPolicy, d0: Data,
                       params: TaskParams, horizon_steps: int,
                       timestep: torch.Tensor, interp: int) -> ilqg.ILQGState:
  """iLQG's state with its plan replaced by the spline nominal rolled out
  open loop (zero gains and improvement)."""
  acts = sampling.candidate_actions(nominal.times, nominal.values[None],
                                    horizon_steps, timestep, interp)[0]
  traj = derivatives.nominal_trajectory(spec, d0, acts, params)
  pol = dataclasses.replace(
      state.policy, times=traj.time, qpos=traj.qpos, qvel=traj.qvel,
      act=traj.act, actions=acts,
      feedback_gain=torch.zeros_like(state.policy.feedback_gain),
      action_improvement=torch.zeros_like(state.policy.action_improvement))
  return dataclasses.replace(state, policy=pol)


def optimize(spec: TaskSpec, state: ILQSState, d0: Data, params: TaskParams,
             scfg: sampling.SamplingConfig, icfg: ilqg.ILQGConfig, noise,
             num_ilqg_candidates: int, horizon_steps: int,
             interp: int) -> Tuple[ILQSState, dict]:
  """One iLQS iteration from the B = 1 state d0, with noise =
  sampling.sample_noise(...) or given noise."""
  global host_reads
  num_points = state.sampling_policy.times.shape[0]
  on_sampling = state.active == ACTIVE_SAMPLING

  # the sampling nominal: the active plan, converted from iLQG's if needed
  converted = _trajectory_to_spline(spec, state.ilqg_state.policy,
                                    num_points, horizon_steps, scfg.timestep,
                                    interp)
  nominal = _where(on_sampling, state.sampling_policy, converted)
  pol_s, info_s = sampling.optimize(spec, nominal, d0, params, scfg, noise,
                                    horizon_steps, interp)
  sampling_improved = torch.logical_and(
      info_s['winner'] > 0, info_s['best_return'] < info_s['nominal_return'])

  # iLQG seeded with the active plan
  ilqg_seed = _where(on_sampling, _seeded_ilqg_state(
      spec, state.ilqg_state, nominal, d0, params, horizon_steps,
      scfg.timestep, interp), state.ilqg_state)

  host_reads += 1
  if bool(sampling_improved):
    ilqg_state, ilqg_ret = ilqg_seed, info_s['best_return']
    ilqg_better = torch.zeros_like(sampling_improved)
  else:
    # eager order: the arbitration compares the improvement applied within
    # this call against sampling's (ilqs/planner.cc:87-240)
    ilqg_state, info = ilqg.optimize(spec, ilqg_seed, d0, params, icfg,
                                     num_ilqg_candidates, horizon_steps,
                                     pipelined=False)
    ilqg_ret = info['best_return']
    ilqg_better = ilqg_ret < info_s['best_return']

  active = torch.where(
      sampling_improved, ACTIVE_SAMPLING,
      torch.where(ilqg_better, ACTIVE_ILQG, state.active)).to(torch.int32)
  new_state = ILQSState(sampling_policy=pol_s, ilqg_state=ilqg_state,
                        active=active)
  info = {
      'best_return': torch.where(
          sampling_improved, info_s['best_return'],
          torch.minimum(info_s['best_return'], ilqg_ret)),
      'sampling_return': info_s['best_return'],
      'nominal_return': info_s['nominal_return'],
      'ilqg_return': ilqg_ret,
      'sampling_improved': sampling_improved,
      'active': active,
  }
  return new_state, info


def action_from_policy(spec: TaskSpec, state: ILQSState, qpos, qvel, act,
                       time, interp: int) -> torch.Tensor:
  """The active plan's actions (B, nu), iLQG's with its feedback."""
  u_s = sampling.action_from_policy(spec, state.sampling_policy, time,
                                    interp)
  u_i = ilqg.action_from_policy(spec, state.ilqg_state.policy, qpos, qvel,
                                act, time)
  return torch.where(state.active == ACTIVE_SAMPLING, u_s, u_i)


def nominal_action_from_policy(spec: TaskSpec, state: ILQSState, time,
                               interp: int) -> torch.Tensor:
  """The active plan's actions without feedback terms (GetAction
  nominal_action)."""
  u_s = sampling.action_from_policy(spec, state.sampling_policy, time,
                                    interp)
  u_i = ilqg.nominal_action_from_policy(spec, state.ilqg_state.policy, time)
  return torch.where(state.active == ACTIVE_SAMPLING, u_s, u_i)
