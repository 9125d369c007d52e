"""Plan-act orchestration: the synchronous MPC loop and the Agent.

Port of mujoco_mpc_tpu/agent.py (horizon_steps :38, plan_model :47,
plan_spec :57, sync_plan_state :68, MpcCarry :77, make_mpc_step :84,
synchronous_mpc :152, Agent :179). JAX runs the loop as one jitted
lax.scan; here it is a Python loop of plan iterations, each followed by
`steps_per_plan` simulation steps of the batch-1 state under the frozen
plan. The TPU's 128-lane broadcast of the simulation step
(agent.py:114-136) is not carried over: on the card the batch-1 step
calls the same functions with B = 1. The task's transition runs once per
plan, before planning (:96-100), on the simulation state whose derived
fields come from the last step's forward; a state that has none yet (a
fresh make_data) gets zeros there, as JAX's make_data gives them.

`Agent` is the host-driven surface (plan iteration, action, step, cost
introspection) over any of the seven planners of planners/registry.py.
It draws its planners' noise and the task transitions' from one
torch.Generator on the model's device, seeded by `seed`, in place of
JAX's key.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
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


class Agent:
  """Host-driven agent mirroring the reference Agent API (agent.h:62-166):
  a task, a planner from the registry by `planner_id` (default: the task's
  `agent_planner`), the simulation state, and plan-iteration / action /
  step / cost introspection. States are B = 1, on the model's device.

  JAX's Agent serves spline actions from its native C++ runtime when it
  can (agent.py:228-241); the port has no native act path yet, so every
  `action` here goes through the planner's action function."""

  def __init__(self, spec: TaskSpec, num_samples: Optional[int] = None,
               interp: int = spline.Interp.ZERO,
               num_spline_points: Optional[int] = None, seed: int = 0,
               planner_id: Optional[int] = None):
    from mujoco_mpc_tpu_torch.planners import registry as planner_registry
    m = spec.model
    self.spec = spec
    self.interp = int(interp)
    if planner_id is None:
      planner_id = int(spec.config.get('agent_planner', 0))
    if num_samples is None:
      num_samples = int(spec.config.get('sampling_trajectories', 128))
    self.planner_id = planner_id
    self.num_samples = num_samples
    p = num_spline_points or int(spec.config.get('sampling_spline_points',
                                                 10))
    self.horizon_steps = horizon_steps(spec)
    self.planner = planner_registry.make_planner(
        plan_spec(spec), planner_id, num_samples, self.horizon_steps, p,
        interp=self.interp)
    self.policy = self.planner.init()
    # the policy from before the last install (Step use_previous_policy,
    # agent.proto:142-146: a simulated planning delay)
    self.prev_policy = self.policy
    self.params = spec.default_params
    self.plan_data = make_data(plan_model(spec))
    self.sim_data = make_data(m)
    if 'home' in m.keyframe_names:
      self.sim_data = self.sim_data.replace(
          qpos=m.keyframe_qpos('home')[None].clone())
    self.generator = torch.Generator(device=m.device).manual_seed(seed)
    self._plots = {'time': [], 'cost_terms': [], 'total_cost': [],
                   'action': []}

  def _tensor(self, x, shape):
    """x (a tensor on any device, an array or numbers) as a B = 1 tensor
    of the model's dtype on its device."""
    m = self.spec.model
    if not torch.is_tensor(x):
      x = np.asarray(x)
    return torch.as_tensor(x, dtype=m.dtype,
                           device=m.device).reshape((1,) + shape)

  # -- Agent::SetState -----------------------------------------------------
  def set_state(self, qpos=None, qvel=None, time=None, act=None,
                mocap_pos=None, ctrl=None, xfrc_applied=None):
    m = self.spec.model
    shapes = dict(qpos=(m.nq,), qvel=(m.nv,), time=(), act=(m.na,),
                  mocap_pos=(m.nmocap, 3), ctrl=(m.nu,),
                  xfrc_applied=(m.nbody, 6))
    given = dict(qpos=qpos, qvel=qvel, time=time, act=act,
                 mocap_pos=mocap_pos, ctrl=ctrl, xfrc_applied=xfrc_applied)
    self.sim_data = self.sim_data.replace(**{
        k: self._tensor(v, shapes[k]) for k, v in given.items()
        if v is not None})

  # -- Agent::PlanIteration, split so that a caller with a physics thread
  # holds its lock only around the snapshot and the install
  # (agent.cc:283-290) ------------------------------------------------------
  def snapshot_plan_inputs(self):
    """(policy, plan state, params, generator) for one plan iteration."""
    plan_d = sync_plan_state(self.plan_data, self.sim_data)
    return self.policy, plan_d, self.params, self.generator

  def plan_from(self, policy, plan_d, params, generator):
    """The planner's iteration on a snapshot (no agent state touched)."""
    return self.planner.optimize(policy, plan_d, params, generator)

  def install_policy(self, policy):
    """Install a newly optimized policy (sampling/planner.cc:525-534)."""
    self.prev_policy = self.policy
    self.policy = policy

  def plan_iteration(self):
    policy, info = self.plan_from(*self.snapshot_plan_inputs())
    self.install_policy(policy)
    return info

  # -- Task::Transition ------------------------------------------------------
  def transition(self):
    if self.spec.transition_fn is not None:
      m = self.spec.model
      self.sim_data, self.params = self.spec.transition_fn(
          m, zero_filled(m, self.sim_data), self.params, self.generator)

  # -- Agent::ActionFromPolicy ------------------------------------------------
  def action(self, time=None, nominal: bool = False,
             use_previous_policy: bool = False) -> torch.Tensor:
    """The policy's action (nu,) at `time` (the simulation's when None).
    nominal=True drops the feedback terms (iLQG, iLQS; agent.proto:108-111),
    use_previous_policy=True asks the policy from before the last install
    (agent.proto:142-146)."""
    d = self.sim_data
    t = d.time if time is None else self._tensor(time, ())
    pol = self.prev_policy if use_previous_policy else self.policy
    fn = self.planner.nominal_action if nominal else self.planner.action
    return fn(pol, d.qpos, d.qvel, d.act, t)[0]

  def step(self, ctrl=None, use_previous_policy: bool = False) -> Data:
    """Step the simulation under the policy's action, or under `ctrl`
    (app.cc:292-304 injects control noise so)."""
    u = (self.action(use_previous_policy=use_previous_policy)
         if ctrl is None else ctrl)
    u = self._tensor(u, (self.spec.model.nu,))
    self.sim_data = fwd.step(self.spec.model, self.sim_data.replace(ctrl=u))
    return self.sim_data

  # -- Planner::BestTrajectory -------------------------------------------------
  def best_trajectory(self):
    """The current policy rolled out from the current state: (states
    (T, nq + nv + na), actions (T, nu), costs (T,))."""
    m, spec = self.spec.model, self.spec
    d = self.sim_data
    states, actions, costs = [], [], []
    for _ in range(self.horizon_steps):
      u = self.planner.action(self.policy, d.qpos, d.qvel, d.act, d.time)
      d = fwd.forward(m, d.replace(ctrl=u))
      res = spec.residual_fn(m, d, self.params.residual_params)
      costs.append(spec.cost(res, self.params)[0])
      states.append(torch.cat([d.qpos, d.qvel, d.act], -1)[0])
      actions.append(u[0])
      d = fwd.integrate(m, d)
    return torch.stack(states), torch.stack(actions), torch.stack(costs)

  def cost_terms(self) -> torch.Tensor:
    """The weighted cost terms (num_term,) at the current state."""
    m = self.spec.model
    d = fwd.forward(m, self.sim_data)
    res = self.spec.residual_fn(m, d, self.params.residual_params)
    return self.spec.cost_terms(res, self.params)[0]

  # -- plot traces (AgentPlots, agent.h:38-43): a bounded host history -------
  def record_plots(self, max_len: int = 512):
    terms = self.cost_terms().cpu().numpy()
    self._plots['time'].append(float(self.sim_data.time[0]))
    self._plots['cost_terms'].append(terms)
    self._plots['total_cost'].append(float(terms.sum()))
    self._plots['action'].append(self.action().cpu().numpy())
    for k in self._plots:
      if len(self._plots[k]) > max_len:
        del self._plots[k][:-max_len]

  def plots(self):
    return {
        'term_names': self.spec.term_names,
        'time': list(self._plots['time']),
        'cost_terms': [t.tolist() for t in self._plots['cost_terms']],
        'total_cost': list(self._plots['total_cost']),
        'action': [a.tolist() for a in self._plots['action']],
    }

  def set_cost_weights(self, weights_by_name):
    w = self.params.weights.clone()
    for name, val in weights_by_name.items():
      w[self.spec.term_names.index(name)] = val
    self.params = self.params.replace(weights=w)

  def set_task_parameter(self, name, value):
    rp = self.params.residual_params.clone()
    rp[self.spec.residual_param_names.index(name)] = value
    self.params = self.params.replace(residual_params=rp)

  # -- task modes (Agent::SetModeByName, agent.cc:421-448): the task's
  # first `select_*` residual parameter --------------------------------------
  def _mode_param(self):
    for name in self.spec.residual_param_names:
      if name.startswith('select_'):
        return name
    return None

  def set_mode(self, mode: int):
    name = self._mode_param()
    if name is None:
      if mode != 0:
        raise ValueError(f'task {self.spec.name!r} has no modes')
      return
    self.set_task_parameter(name, float(mode))

  def mode(self) -> int:
    name = self._mode_param()
    if name is None:
      return 0
    idx = self.spec.residual_param_names.index(name)
    return int(round(float(self.params.residual_params[idx])))
