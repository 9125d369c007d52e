"""Forward dynamics pipeline and the integrators, batch-first.

Port of mujoco_mpc_tpu/physics/forward.py (_solve_m :25, fwd_position
:39, fwd_velocity :47, fwd_actuation :55, fwd_acceleration :59, forward
:69, integrate_pos :86, _euler :107, _rk4 :126, _implicit :157, integrate
:187, step :196). Both mass-matrix solves (qacc_smooth and the
implicit-damping Euler system) go through ops/spd_solve.SpdSolve: the
kernel B1 on the card, and its implicit-function tangent
(custom_linear_solve) under torch.func. The
constraint solve goes through ops/newton.NewtonSolve: the kernel B2 on the
card, and its frozen-active-set tangent.

Ported integrators: Euler (with implicit joint damping), RK4 (four
forward passes a step, each with its B1 solve and, where there are rows,
its B2 solve) and the implicit and implicitfast integrators (2 and 3),
whose system M - h dF/dqvel is not symmetric and is solved by
torch.linalg.solve, as JAX solves it by jnp.linalg.solve outside any
kernel. Forces: passive springs and dampers (joints and tendons), gravity
compensation, actuation, and the inertia-box fluid drag
(physics/fluid.py). Not ported yet, and refused: the noslip post-pass
(ROADMAP A8).
"""

from __future__ import annotations

import torch

from mujoco_mpc_tpu_torch.ops import spd_solve
from mujoco_mpc_tpu_torch.physics import constraint
from mujoco_mpc_tpu_torch.physics import fluid as fluid_mod
from mujoco_mpc_tpu_torch.physics import kinematics as kin
from mujoco_mpc_tpu_torch.physics import smooth
from mujoco_mpc_tpu_torch.physics.model import Data, IntegratorType, Model
from mujoco_mpc_tpu_torch.utils import math as tm


def _solve_m(qm: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
  """Solve M x = rhs for batched SPD M (B, nv, nv), with the
  implicit-function tangent dx = M^-1 (drhs - dM x)."""
  return spd_solve.solve_spd(qm.contiguous(), rhs.contiguous())


def fwd_position(m: Model, d: Data) -> Data:
  d = kin.kinematics(m, d)
  d = kin.com_pos(m, d)
  d = smooth.tendon(m, d)
  d = smooth.transmission(m, d)
  return d


def fwd_velocity(m: Model, d: Data) -> Data:
  d = kin.com_vel(m, d)
  d = smooth.rne(m, d)
  d = smooth.passive(m, d)
  d = fluid_mod.fluid(m, d)
  return d


def fwd_actuation(m: Model, d: Data) -> Data:
  return smooth.actuation(m, d)


def fwd_acceleration(m: Model, d: Data) -> Data:
  if m.nv == 0:   # a static scene: nothing to solve
    return d
  qfrc_smooth = (d.qfrc_passive - d.qfrc_bias + d.qfrc_actuator
                 + d.qfrc_applied + smooth.xfrc_accumulate(m, d))
  qfrc = qfrc_smooth + d.qfrc_constraint
  return d.replace(qfrc_smooth=qfrc_smooth, qacc=_solve_m(d.qM, qfrc))


def forward(m: Model, d: Data) -> Data:
  """Positions -> velocities -> forces -> constrained qacc (mj_forward)."""
  if m.opt.noslip_iterations > 0:
    raise NotImplementedError('noslip is not ported yet (ROADMAP A8)')
  d = fwd_position(m, d)
  d = fwd_velocity(m, d)
  d = fwd_actuation(m, d)
  d = smooth.crb(m, d)
  d = d.replace(qfrc_constraint=torch.zeros_like(d.qvel))
  d = fwd_acceleration(m, d)   # qacc_smooth
  return constraint.solve(m, d, *constraint.make_rows_split(m, d))


def integrate_pos(m: Model, qpos: torch.Tensor, qvel: torch.Tensor,
                  dt) -> torch.Tensor:
  """qpos <- qpos + qvel dt on the configuration manifold."""
  idx = m.idx
  out = qpos
  if len(idx.sq):
    out = out.index_add(1, idx.sq, qvel[:, idx.sd] * dt)
  if len(idx.qj):
    newq = tm.quat_integrate(qpos[:, idx.quat_q], qvel[:, idx.quat_d], dt)
    out = out.index_copy(1, idx.quat_q.reshape(-1),
                         newq.reshape(qpos.shape[0], -1))
  return out


def _clamp_act(m: Model, act: torch.Tensor) -> torch.Tensor:
  return torch.clamp(act, m.act_range[:, 0], m.act_range[:, 1])


def _euler(m: Model, d: Data) -> Data:
  """Semi-implicit Euler with implicit joint damping (mj_Euler)."""
  h = m.opt.timestep
  qm_h = d.qM + h * torch.diag(m.dof_damping)
  qacc = _solve_m(qm_h, d.qfrc_smooth + d.qfrc_constraint)
  qvel = d.qvel + h * qacc
  qpos = integrate_pos(m, d.qpos, qvel, h)
  act = _clamp_act(m, d.act + h * d.act_dot) if m.na else d.act
  return d.replace(qpos=qpos, qvel=qvel, act=act, time=d.time + h)


def _rk4(m: Model, d: Data) -> Data:
  """Explicit Runge-Kutta 4 (mj_RungeKutta with its default tableau) from
  post-forward Data: three more forward passes at the midpoints and the
  end, then the weighted velocity and acceleration."""
  h = m.opt.timestep
  coefs = (0.5, 0.5, 1.0)
  weights = (1.0 / 6, 1.0 / 3, 1.0 / 3, 1.0 / 6)
  qpos0, qvel0, act0 = d.qpos, d.qvel, d.act
  kq, kv, ka = [d.qacc], [d.qvel], [d.act_dot]
  for c in coefs:
    di = forward(m, d.replace(
        qpos=integrate_pos(m, qpos0, kv[-1], c * h),
        qvel=qvel0 + c * h * kq[-1],
        act=act0 + c * h * ka[-1] if m.na else act0))
    kq.append(di.qacc)
    kv.append(di.qvel)
    ka.append(di.act_dot)
  qvel_avg = sum(w * v for w, v in zip(weights, kv))
  qacc_avg = sum(w * a for w, a in zip(weights, kq))
  act_avg = sum(w * a for w, a in zip(weights, ka))
  qpos = integrate_pos(m, qpos0, qvel_avg, h)
  qvel = qvel0 + h * qacc_avg
  act = _clamp_act(m, act0 + h * act_avg) if m.na else act0
  return d.replace(qpos=qpos, qvel=qvel, act=act, time=d.time + h)


def _implicit(m: Model, d: Data) -> Data:
  """Implicit-in-velocity integration (mj_implicit / implicitfast).

  Solves (M - h dF/dqvel) qacc = qfrc_total, with dF/dqvel the derivative
  of the passive, fluid and actuator forces and the bias with respect to
  qvel, taken per sample by forward-mode AD (tm.jacfwd_batched) over
  com_vel -> rne -> passive -> fluid -> actuation, as JAX takes it with
  jax.jacfwd. Under the derivative pass's own torch.func transform the
  two nest."""
  h = m.opt.timestep

  def qfrc_of_qvel(qvel):
    di = d.replace(qvel=qvel)
    di = kin.com_vel(m, di)
    di = smooth.rne(m, di)
    di = smooth.passive(m, di)
    di = fluid_mod.fluid(m, di)
    if m.nu:   # velocity-dependent actuator force (affine gain and bias)
      di = di.replace(
          actuator_velocity=(di.actuator_moment @ qvel[..., None])[..., 0])
    di = smooth.actuation(m, di)
    return di.qfrc_passive - di.qfrc_bias + di.qfrc_actuator

  deriv = tm.jacfwd_batched(qfrc_of_qvel, d.qvel)       # (B, nv, nv)
  qfrc = d.qfrc_smooth + d.qfrc_constraint
  qacc = torch.linalg.solve(d.qM - h * deriv, qfrc)
  qvel = d.qvel + h * qacc
  qpos = integrate_pos(m, d.qpos, qvel, h)
  act = _clamp_act(m, d.act + h * d.act_dot) if m.na else d.act
  return d.replace(qpos=qpos, qvel=qvel, act=act, time=d.time + h)


def integrate(m: Model, d: Data) -> Data:
  """Advance post-forward Data by one timestep with the model's
  integrator."""
  if m.opt.integrator == IntegratorType.RK4:
    return _rk4(m, d)
  if m.opt.integrator in (2, 3):   # implicit / implicitfast
    return _implicit(m, d)
  return _euler(m, d)


def step(m: Model, d: Data) -> Data:
  """forward + integrate (mj_step)."""
  return integrate(m, forward(m, d))
