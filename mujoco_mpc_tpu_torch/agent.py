"""Plan-act orchestration: the synchronous MPC loop.

Port of mujoco_mpc_tpu/agent.py (horizon_steps :38, plan_model :47,
plan_spec :57, sync_plan_state :68, MpcCarry :77, make_mpc_step :84,
synchronous_mpc :152). JAX runs the loop as one jitted lax.scan; here it is
a Python loop of plan iterations, each followed by `steps_per_plan`
simulation steps of the batch-1 state under the frozen plan. The TPU's
128-lane broadcast of the simulation step (agent.py:114-136) is not
carried over: on the card the batch-1 step calls the same functions with
B = 1. The task's transition runs once per plan, before planning
(:96-100), on the simulation state whose derived fields come from the
last step's forward; a state that has none yet (a fresh make_data) gets
zeros there, as JAX's make_data gives them. The host-driven Agent class
(:179) is still to come (ROADMAP A13).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from mujoco_mpc_tpu_torch.ops import spline
from mujoco_mpc_tpu_torch.physics import forward as fwd
from mujoco_mpc_tpu_torch.physics.model import (Data, Model, make_data,
                                                zero_filled)
from mujoco_mpc_tpu_torch.planners import sampling
from mujoco_mpc_tpu_torch.tasks.base import TaskParams, TaskSpec

# reference: trajectory.h:27
MAX_TRAJECTORY_HORIZON = 512


def _model_timestep(spec: TaskSpec) -> float:
  return float(spec.model.opt.timestep)


def horizon_steps(spec: TaskSpec) -> int:
  """Planning horizon in steps (reference: agent.cc:279-280)."""
  cfg = spec.config
  horizon = float(cfg.get('agent_horizon', 1.0))
  timestep = float(cfg.get('agent_timestep', _model_timestep(spec)))
  return min(int(horizon / timestep + 1), MAX_TRAJECTORY_HORIZON)


def plan_model(spec: TaskSpec) -> Model:
  """The task model integrating at agent_timestep."""
  ts = spec.config.get('agent_timestep', None)
  m = spec.model
  if ts is None or float(ts) == _model_timestep(spec):
    return m
  return m.replace(opt=m.opt.replace(
      timestep=torch.as_tensor(ts, dtype=m.dtype, device=m.device)))


def plan_spec(spec: TaskSpec) -> TaskSpec:
  """Spec whose model integrates at agent_timestep: planner rollouts use
  it, the simulation uses spec.model (agent.cc:279-280)."""
  pm = plan_model(spec)
  if pm is spec.model:
    return spec
  return dataclasses.replace(spec, model=pm)


def sync_plan_state(plan_d: Data, sim_d: Data) -> Data:
  """Snapshot the simulation state into planning Data (State::Set)."""
  return plan_d.replace(
      time=sim_d.time, qpos=sim_d.qpos, qvel=sim_d.qvel, act=sim_d.act,
      ctrl=sim_d.ctrl, mocap_pos=sim_d.mocap_pos,
      mocap_quat=sim_d.mocap_quat, userdata=sim_d.userdata)


@dataclasses.dataclass(frozen=True)
class MpcCarry:
  sim: Data
  policy: sampling.SamplingPolicy
  params: TaskParams
  generator: torch.Generator


def make_mpc_step(spec: TaskSpec, num_samples: int, steps_per_plan: int,
                  interp: int = spline.Interp.ZERO,
                  planner_iterations: int = 1):
  """The plan-and-step body of synchronous MPC: carry -> (carry, out)."""
  t_steps = horizon_steps(spec)
  pspec = plan_spec(spec)
  sim_model = spec.model
  cfg = sampling.default_config(pspec)
  plan_d0 = make_data(pspec.model)

  def plan_and_step(carry: MpcCarry) -> Tuple[MpcCarry, dict]:
    sim, policy, params = carry.sim, carry.policy, carry.params
    if spec.transition_fn is not None:
      sim, params = spec.transition_fn(sim_model, zero_filled(sim_model, sim),
                                       params, carry.generator)
    plan_d = sync_plan_state(plan_d0, sim)
    for _ in range(planner_iterations):
      noise = sampling.sample_noise(pspec, policy.times.shape[0],
                                    num_samples, cfg, carry.generator)
      policy, info = sampling.optimize(pspec, policy, plan_d, params, cfg,
                                       noise, t_steps, interp)
    costs = []
    for _ in range(steps_per_plan):
      u = sampling.action_from_policy(spec, policy, sim.time, interp)
      d = fwd.forward(sim_model, sim.replace(ctrl=u))
      res = spec.residual_fn(sim_model, d, params.residual_params)
      costs.append(spec.cost(res, params))
      sim = fwd.integrate(sim_model, d)
    out = {'costs': torch.cat(costs), 'best_return': info['best_return']}
    return dataclasses.replace(carry, sim=sim, policy=policy,
                               params=params), out

  return plan_and_step


def synchronous_mpc(spec: TaskSpec, num_samples: int, total_steps: int,
                    steps_per_plan: int, generator: torch.Generator,
                    interp: int = spline.Interp.ZERO,
                    num_spline_points: Optional[int] = None,
                    sim0: Optional[Data] = None,
                    params: Optional[TaskParams] = None,
                    planner_iterations: int = 1):
  """Synchronous plan-act loop (reference: testspeed.cc:44-129).

  Returns (final carry, per-step costs (nplans * steps_per_plan,))."""
  if num_spline_points is None:
    num_spline_points = int(spec.config.get('sampling_spline_points', 10))
  if sim0 is None:
    sim0 = make_data(spec.model)
  if params is None:
    params = spec.default_params
  policy = sampling.default_policy(spec, num_spline_points)
  body = make_mpc_step(spec, num_samples, steps_per_plan, interp,
                       planner_iterations)
  carry = MpcCarry(sim=sim0, policy=policy, params=params,
                   generator=generator)
  costs = []
  for _ in range(total_steps // steps_per_plan):
    carry, out = body(carry)
    costs.append(out['costs'])
  return carry, torch.cat(costs)
