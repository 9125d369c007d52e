"""iLQG planner: Riccati backward pass, boxQP control limits, feedback
policy.

Port of mujoco_mpc_tpu/planners/ilqg.py (ILQGPolicy :51, ILQGState :64,
ILQGConfig :77, default_config :85, default_state :96, boxqp :124,
riccati :177, _feedback_rollout :279, action_from_policy :322,
nominal_action_from_policy :342, _backward_with_escalation :361,
_linesearch_steps :393, _reg_update :402, optimize :411), both the
pipelined and the eager order.

* The line search is one batched feedback rollout: the candidates (one
  per improvement scale) are the batch, the horizon a Python loop, as in
  planners/rollout.py; both kernels run in its step.
* The derivative pass is planners/derivatives.compute on the winner.
* The Riccati pass is a Python loop over the T - 1 knots (JAX: a reverse
  lax.scan) of small nu x nu and ndx x ndx products. Its SPD solves and
  factors use ops/linalg, the unrolled plain solve, because that is the
  reference's own path here (ilqg.py:143, :224-235 call ops/linalg, not
  the Pallas kernel): these are single unbatched systems, not the
  kernel's batched ones.
* The escalation loop (JAX: a lax.while_loop) reads the backward pass's
  `ok` on the host once per check: once an iteration when the first pass
  succeeds, and at most MAX_REGULARIZATION_ITERATIONS times. Nothing
  else in `optimize` waits on the device.

As in JAX, the policy acts zero-hold only (representation is carried and
ignored).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from mujoco_mpc_tpu_torch.ops import linalg
from mujoco_mpc_tpu_torch.physics import forward as fwd
from mujoco_mpc_tpu_torch.physics import support
from mujoco_mpc_tpu_torch.physics.model import Data
from mujoco_mpc_tpu_torch.planners import derivatives
from mujoco_mpc_tpu_torch.planners import rollout as rollout_mod
from mujoco_mpc_tpu_torch.tasks.base import TaskParams, TaskSpec

# reference: ilqg/settings.h
MIN_LINESEARCH_STEP = 1.0e-3
MIN_REGULARIZATION = 1.0e-6
MAX_REGULARIZATION = 1.0e6
MAX_REGULARIZATION_ITERATIONS = 5

# host reads of the backward pass's `ok` by the escalation loop, counted
host_reads = 0

# regularization types (backward_pass.h:28-32)
REG_CONTROL = 0
REG_STATE_CONTROL = 1
REG_VALUE = 2
REG_NONE = 3


@dataclasses.dataclass(frozen=True)
class ILQGPolicy:
  """Time-indexed affine feedback policy."""
  times: torch.Tensor               # (T,)
  qpos: torch.Tensor                # (T, nq) nominal states
  qvel: torch.Tensor                # (T, nv)
  act: torch.Tensor                 # (T, na)
  actions: torch.Tensor             # (T, nu) nominal actions
  feedback_gain: torch.Tensor       # (T, nu, ndx)
  action_improvement: torch.Tensor  # (T, nu)
  feedback_scaling: torch.Tensor    # ()


@dataclasses.dataclass(frozen=True)
class ILQGState:
  policy: ILQGPolicy
  regularization: torch.Tensor
  regularization_factor: torch.Tensor
  previous_return: torch.Tensor
  # expected-improvement coefficients (dV) of the backward pass whose
  # action_improvement is stored in `policy`, read by the next pipelined
  # call's surprise
  expected_dv: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class ILQGConfig:
  timestep: torch.Tensor
  horizon_time: torch.Tensor
  regularization_type: int = REG_CONTROL
  action_limits: bool = True
  representation: int = 0   # 0 = zero-hold


def default_config(spec: TaskSpec) -> ILQGConfig:
  m = spec.model
  cfg = spec.config
  t = lambda v: torch.as_tensor(v, dtype=m.dtype, device=m.device)  # noqa: E731
  return ILQGConfig(
      timestep=(t(cfg['agent_timestep']) if 'agent_timestep' in cfg
                else m.opt.timestep),
      horizon_time=t(cfg.get('agent_horizon', 1.0)),
      regularization_type=int(cfg.get('ilqg_regularization_type', 0)),
      action_limits=True,
      representation=int(cfg.get('ilqg_representation', 0)))


def default_state(spec: TaskSpec, horizon_steps: int) -> ILQGState:
  m = spec.model
  nd = derivatives.ndx(m)
  t = horizon_steps
  kw = dict(dtype=m.dtype, device=m.device)
  policy = ILQGPolicy(
      times=torch.arange(t, **kw) * float(m.opt.timestep),
      qpos=m.qpos0.repeat(t, 1),
      qvel=torch.zeros((t, m.nv), **kw),
      act=torch.zeros((t, m.na), **kw),
      actions=torch.zeros((t, m.nu), **kw),
      feedback_gain=torch.zeros((t, m.nu, nd), **kw),
      action_improvement=torch.zeros((t, m.nu), **kw),
      feedback_scaling=torch.ones((), **kw))
  return ILQGState(
      policy=policy,
      regularization=torch.ones((), **kw),
      regularization_factor=torch.full((), 2.0, **kw),
      previous_return=torch.full((), rollout_mod.MAX_RETURN_VALUE, **kw),
      expected_dv=torch.zeros(2, **kw))


# ---------------------------------------------------------------------------
# boxQP: masked projected Newton (mju_boxQP)
# ---------------------------------------------------------------------------

_BOXQP_ALPHAS = (1.0, 0.5, 0.25, 0.125, 0.0625)


def boxqp(h: torch.Tensor, g: torch.Tensor, lower: torch.Tensor,
          upper: torch.Tensor, iterations: int = 8):
  """min_x 0.5 x'Hx + g'x subject to lower <= x <= upper, for one (nu,)
  problem. Returns (x, free_mask, ok). A fixed number of iterations,
  branch-free."""
  nu = g.shape[0]
  eye = torch.eye(nu, dtype=h.dtype, device=h.device)
  alphas = torch.tensor(_BOXQP_ALPHAS, dtype=h.dtype, device=h.device)

  def obj(x):   # x (..., nu)
    return (0.5 * torch.sum(x * (x @ h.T), -1)
            + torch.sum(g * x, -1))

  x = torch.clamp(torch.zeros_like(g), lower, upper)
  free = torch.ones(nu, dtype=torch.bool, device=h.device)
  for _ in range(iterations):
    grad = g + h @ x
    at_lo = torch.logical_and(x <= lower + 1e-10, grad > 0)
    at_hi = torch.logical_and(x >= upper - 1e-10, grad < 0)
    free = torch.logical_not(torch.logical_or(at_lo, at_hi))
    fm = free.to(h.dtype)
    hm = h * torch.outer(fm, fm) + eye * (1.0 - fm)
    dx = linalg.solve_spd(hm + 1e-12 * eye, grad * fm)
    # projected backtracking line search
    cands = torch.clamp(x[None] - alphas[:, None] * dx[None], lower, upper)
    objs = obj(cands)
    best = torch.argmin(objs)
    x = torch.where(objs[best] < obj(x), cands[best], x)
  return x, free, torch.all(torch.isfinite(x))


# ---------------------------------------------------------------------------
# Riccati backward pass
# ---------------------------------------------------------------------------


def _chol_diag(a: torch.Tensor) -> torch.Tensor:
  col = linalg.chol_factor(a)
  return torch.stack([col[i][i] for i in range(a.shape[-1])], -1)


def riccati(derivs: derivatives.Derivatives, mu: torch.Tensor,
            actions: torch.Tensor, ctrlrange: torch.Tensor, reg_type: int,
            action_limits: bool):
  """Backward recursion. Returns (k (T, nu), K (T, nu, ndx), dV (2,), ok);
  the last knot copies T - 2's (reference planner.cc:493-506)."""
  a, b = derivs.a, derivs.b
  cx, cu, cxx, cxu, cuu = (derivs.cx, derivs.cu, derivs.cxx, derivs.cxu,
                           derivs.cuu)
  tm1, nd, nu = a.shape[0], a.shape[1], b.shape[2]
  kw = dict(dtype=a.dtype, device=a.device)
  eye_u = torch.eye(nu, **kw)
  vx, vxx = cx[-1], cxx[-1]
  dv0 = dv1 = torch.zeros((), **kw)
  ok = torch.ones((), dtype=torch.bool, device=a.device)
  ks, gains = [None] * tm1, [None] * tm1
  for t in reversed(range(tm1)):
    at, bt, ut = a[t], b[t], actions[t]
    at_vxx = at.T @ vxx
    qx = cx[t] + at.T @ vx
    qxx = cxx[t] + at_vxx @ at
    qu = cu[t] + bt.T @ vx
    qxu = cxu[t] + at_vxx @ bt
    quu = cuu[t] + (bt.T @ vxx) @ bt

    if reg_type == REG_VALUE:
      vxx_reg = vxx + mu * torch.eye(nd, **kw)
      qxu_reg = cxu[t] + (at.T @ vxx_reg) @ bt
      quu_reg = cuu[t] + (bt.T @ vxx_reg) @ bt
    elif reg_type == REG_CONTROL:
      qxu_reg = qxu
      quu_reg = quu + mu * eye_u
    elif reg_type == REG_STATE_CONTROL:
      qxu_reg = qxu + mu * (at.T @ bt)
      quu_reg = quu + mu * (bt.T @ bt)
    else:
      qxu_reg = qxu
      quu_reg = quu

    if action_limits:
      # active-set rounds scale with nu, as in JAX (ilqg.py:212-220)
      du, free, step_ok = boxqp(quu_reg, qu, ctrlrange[:, 0] - ut,
                                ctrlrange[:, 1] - ut,
                                iterations=min(4, max(2, nu)))
      fm = free.to(a.dtype)
      hm = quu_reg * torch.outer(fm, fm) + eye_u * (1.0 - fm)
      # K = -H_free^-1 Qxu_free' with clamped rows zero; the solve runs
      # along the last axis, so pass (nd, nu) and transpose
      kt = -linalg.solve_spd(hm + 1e-12 * eye_u, qxu_reg * fm[None, :]).T
    else:
      chol = linalg.chol_factor(quu_reg)
      du = -linalg.chol_solve(chol, qu)
      kt = -linalg.chol_solve(chol, qxu_reg).T
      diag = torch.stack([chol[i][i] for i in range(nu)])
      step_ok = torch.logical_and(torch.all(torch.isfinite(diag)),
                                  torch.all(diag > 0))

    # PD sanity: the Cholesky factor of quu_reg must be finite
    diag_q = _chol_diag(quu_reg)
    step_ok = torch.logical_and(step_ok, torch.logical_and(
        torch.all(torch.isfinite(diag_q)), torch.all(diag_q > 1e-15)))

    quu_du = quu @ du
    dv0 = dv0 + du @ qu
    dv1 = dv1 + 0.5 * du @ quu_du
    vx = qx + kt.T @ (quu_du + qu) + qxu @ du
    vxx = qxx + kt.T @ quu @ kt + qxu @ kt + kt.T @ qxu.T
    vxx = 0.5 * (vxx + vxx.T)
    ok = torch.logical_and(ok, step_ok)
    ks[t], gains[t] = du, kt

  k = torch.stack(ks + ks[-1:])
  gain = torch.stack(gains + gains[-1:])
  return k, gain, torch.stack([dv0, dv1]), ok


# ---------------------------------------------------------------------------
# feedback rollouts and the policy's action
# ---------------------------------------------------------------------------


def _time_index(policy: ILQGPolicy, time: torch.Tensor) -> torch.Tensor:
  """The knot at or before each time (FindInterval, zero-hold)."""
  idx = torch.searchsorted(policy.times, time.contiguous(), right=True) - 1
  return torch.clamp(idx, 0, policy.times.shape[0] - 1)


def _state_dx(m, policy: ILQGPolicy, t, qpos, qvel, act) -> torch.Tensor:
  """x - x̄_t in tangent coordinates (B, ndx)."""
  parts = [support.state_diff(m, policy.qpos[t], qpos),
           qvel - policy.qvel[t]]
  if m.na:
    parts.append(act - policy.act[t])
  return torch.cat(parts, -1)


def _feedback_rollout(spec: TaskSpec, d0: Data, policy: ILQGPolicy,
                      scale: torch.Tensor, params: TaskParams,
                      horizon_steps: int, index_by_time: bool = False):
  """Roll out u_t = clamp(ū_t + scale k_t + K_t (x - x̄_t)) from the B = 1
  state d0, one candidate per entry of scale (B,). Returns (returns (B,),
  actions (B, T, nu), qpos, qvel, act, times, residuals, costs), each
  with leading (B, T).

  index_by_time looks the nominal up by absolute time (FindInterval; the
  stored plan may start before d0.time); otherwise by step, exact for a
  plan just recorded from d0."""
  m = spec.model
  lo, hi = m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1]
  bsz = scale.shape[0]
  d0 = d0.expand(bsz)
  tm_, qpos, qvel, act = d0.time, d0.qpos, d0.qvel, d0.act
  rec = []
  for step in range(horizon_steps):
    if index_by_time:
      t = _time_index(policy, tm_)
    else:
      t = torch.full((bsz,), step, dtype=torch.long, device=qpos.device)
    dx = _state_dx(m, policy, t, qpos, qvel, act)
    u = (policy.actions[t] + scale[:, None] * policy.action_improvement[t]
         + (policy.feedback_gain[t] @ dx[..., None])[..., 0])
    u = torch.clamp(u, lo, hi)
    d = d0.replace(time=tm_, qpos=qpos, qvel=qvel, act=act, ctrl=u)
    df = fwd.forward(m, d)
    res = spec.residual_fn(m, df, params.residual_params)
    d = fwd.integrate(m, df)
    rec.append((u, res, df.qpos, df.qvel, df.act, df.time))
    tm_, qpos, qvel, act = d.time, d.qpos, d.qvel, d.act
  actions, residuals, qpos, qvel, act, times = (
      torch.stack(x, 1) for x in zip(*rec))
  costs = spec.cost(residuals, params)
  ret = rollout_mod.total_return(costs)
  return ret, actions, qpos, qvel, act, times, residuals, costs


def action_from_policy(spec: TaskSpec, policy: ILQGPolicy,
                       qpos: torch.Tensor, qvel: torch.Tensor,
                       act: torch.Tensor, time: torch.Tensor) -> torch.Tensor:
  """u = ū(t) + feedback_scaling K(t) (x - x̄(t)), zero-hold (reference
  policy.cc:82-150, representation 0), for states (B, ...) at times
  (B,)."""
  m = spec.model
  t = _time_index(policy, time)
  dx = _state_dx(m, policy, t, qpos, qvel, act)
  u = (policy.actions[t] + policy.feedback_scaling
       * (policy.feedback_gain[t] @ dx[..., None])[..., 0])
  return torch.clamp(u, m.actuator_ctrlrange[:, 0],
                     m.actuator_ctrlrange[:, 1])


def nominal_action_from_policy(spec: TaskSpec, policy: ILQGPolicy,
                               time: torch.Tensor) -> torch.Tensor:
  """ū(t) without the feedback term, at times (B,)."""
  m = spec.model
  return torch.clamp(policy.actions[_time_index(policy, time)],
                     m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1])


# ---------------------------------------------------------------------------
# optimize
# ---------------------------------------------------------------------------


def _backward_with_escalation(spec: TaskSpec, derivs, traj,
                              cfg: ILQGConfig, mu0: torch.Tensor,
                              factor: torch.Tensor):
  """The backward pass, escalating the regularization on failure: one
  pass on the happy path. Reads `ok` on the host once per check
  (`host_reads` counts them). Returns (k, gain, dv, ok, mu)."""
  global host_reads
  m = spec.model

  def bp(mu):
    return riccati(derivs, mu, traj.actions, m.actuator_ctrlrange,
                   cfg.regularization_type, cfg.action_limits)

  k, gain, dv, ok = bp(mu0)
  mu = mu0
  for _ in range(MAX_REGULARIZATION_ITERATIONS):
    host_reads += 1
    if bool(ok):
      break
    mu = torch.clamp(mu * factor, MIN_REGULARIZATION, MAX_REGULARIZATION)
    k, gain, dv, ok = bp(mu)
  return k, gain, dv, ok, mu



def _linesearch_steps(num_candidates: int, dtype,
                      device=None) -> torch.Tensor:
  """Log-spaced improvement scales from 1 to MIN_LINESEARCH_STEP, then 0
  (a pure replay of the nominal) (planner.cc:618-667)."""
  exps = torch.linspace(0.0, math.log10(MIN_LINESEARCH_STEP),
                        num_candidates - 1, dtype=dtype, device=device)
  return torch.cat([torch.pow(10.0, exps),
                    torch.zeros(1, dtype=dtype, device=device)])


def _reg_update(state: ILQGState, surprise, action_step):
  """Surprise-based regularization scale (backward_pass.cc:341-356)."""
  factor = state.regularization_factor
  good = torch.logical_or(surprise > 0.5, action_step > 0.3)
  bad = torch.logical_or(surprise < 0.1, action_step < 0.06)
  return torch.where(good, 1.0 / factor,
                     torch.where(bad, factor, torch.ones_like(factor)))


def _trajectory(outs, i) -> derivatives.Trajectory:
  """Candidate i's records from a _feedback_rollout."""
  _, acts, qpos, qvel, act, times, res, costs = outs
  return derivatives.Trajectory(qpos=qpos[i], qvel=qvel[i], act=act[i],
                                time=times[i], actions=acts[i],
                                residuals=res[i], costs=costs[i])


def _policy(traj, gain, k) -> ILQGPolicy:
  return ILQGPolicy(times=traj.time, qpos=traj.qpos, qvel=traj.qvel,
                    act=traj.act, actions=traj.actions, feedback_gain=gain,
                    action_improvement=k,
                    feedback_scaling=torch.ones_like(traj.time[0]))


def optimize(spec: TaskSpec, state: ILQGState, d0: Data, params: TaskParams,
             cfg: ILQGConfig, num_candidates: int, horizon_steps: int,
             pipelined: bool = True) -> Tuple[ILQGState, dict]:
  """One iLQG planning iteration from the B = 1 state d0 (planner.cc
  Iteration).

  pipelined=True (JAX's default): one batched feedback-rollout line search
  applies the improvement computed by the previous call (its scale-0
  candidate is the nominal re-record), the winner becomes the nominal,
  then the derivatives and the backward pass produce the improvement the
  next call applies. pipelined=False: the reference's eager order
  (nominal rollout, backward pass, line search with the fresh
  improvement)."""
  m = spec.model
  dtype = d0.qpos.dtype
  steps = _linesearch_steps(num_candidates, dtype, d0.qpos.device)

  if pipelined:
    outs = _feedback_rollout(spec, d0, state.policy, steps, params,
                             horizon_steps, index_by_time=True)
    rets = outs[0]
    winner = torch.argmin(rets)
    prev_ret = rets[-1]                      # scale 0 = nominal re-record
    traj = _trajectory(outs, winner)
    # surprise uses the dV of the backward pass that produced the applied
    # improvement (state.expected_dv)
    action_step = steps[winner]
    dv_prev = (state.expected_dv if state.expected_dv is not None
               else torch.zeros(2, dtype=dtype, device=steps.device))
    expected = (-action_step * (dv_prev[0] + action_step * dv_prev[1])
                + 1.0e-16)
    improvement = prev_ret - rets[winner]
    surprise = torch.clamp(improvement / expected, 0.0, 2.0)
    mu_start = torch.clamp(
        state.regularization * _reg_update(state, surprise, action_step),
        MIN_REGULARIZATION, MAX_REGULARIZATION)
    derivs = derivatives.compute(spec, d0, traj, params)
    k, gain, dv, bp_ok, mu = _backward_with_escalation(
        spec, derivs, traj, cfg, mu_start, state.regularization_factor)
    new_state = ILQGState(
        policy=_policy(traj, gain, k), regularization=mu,
        regularization_factor=state.regularization_factor,
        previous_return=rets[winner], expected_dv=dv)
    return new_state, {
        'best_return': rets[winner], 'nominal_return': prev_ret,
        'improvement': torch.clamp(improvement, min=0.0),
        'action_step': action_step, 'surprise': surprise,
        'regularization': mu, 'backward_pass_ok': bp_ok}

  # eager (reference) order: the nominal rollout under the current policy
  # records everything the Trajectory needs
  zero = torch.zeros(1, dtype=dtype, device=steps.device)
  nominal = _feedback_rollout(spec, d0, state.policy, zero, params,
                              horizon_steps, index_by_time=True)
  prev_ret = nominal[0][0]
  traj = _trajectory(nominal, 0)
  derivs = derivatives.compute(spec, d0, traj, params)
  k, gain, dv, bp_ok, mu = _backward_with_escalation(
      spec, derivs, traj, cfg, state.regularization,
      state.regularization_factor)
  outs = _feedback_rollout(spec, d0, _policy(traj, gain, k), steps, params,
                           horizon_steps)
  rets = outs[0]
  winner = torch.argmin(rets)
  best = _trajectory(outs, winner)
  action_step = steps[winner]
  expected = -action_step * (dv[0] + action_step * dv[1]) + 1.0e-16
  improvement = prev_ret - rets[winner]
  surprise = torch.clamp(improvement / expected, 0.0, 2.0)
  mu_next = torch.clamp(mu * _reg_update(state, surprise, action_step),
                        MIN_REGULARIZATION, MAX_REGULARIZATION)
  new_state = ILQGState(
      policy=_policy(best, gain, k), regularization=mu_next,
      regularization_factor=state.regularization_factor,
      previous_return=rets[winner], expected_dv=dv)
  return new_state, {
      'best_return': rets[winner], 'nominal_return': prev_ret,
      'improvement': torch.clamp(improvement, min=0.0),
      'action_step': action_step, 'surprise': surprise,
      'regularization': mu_next, 'backward_pass_ok': bp_ok}
