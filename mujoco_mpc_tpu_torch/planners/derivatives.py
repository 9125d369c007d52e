"""Trajectory derivatives: exact dynamics and residual Jacobians, and the
Gauss-Newton cost expansion.

Port of mujoco_mpc_tpu/planners/derivatives.py (Trajectory :30,
Derivatives :41, ndx :51, nominal_trajectory :55, _perturbed_data :77,
transition_derivs :86, _risk_chain :115, cost_derivs :157, compute :183,
spline_mapping :190).
The tangent state is dx = (dq (nv), dqvel (nv), dact (na)), dq on the
configuration manifold (support.integrate_state / state_diff).

JAX takes jax.jacfwd of one knot's step and vmaps it over the knots. Here
the knots are the batch: the T - 1 transitions are one batch-first step,
and one tangent direction applied to every knot at once gives column k of
every knot's Jacobian (utils/math.jacfwd_batched), so the derivative pass
is one step with D = ndx + nu tangent directions, not (T - 1) * D. The
step's two kernels carry their tangents (ops/spd_solve.SpdSolve,
ops/newton.NewtonSolve): on the card the primal solves run at B = T - 1
and the tangent SPD solves at B = (T - 1) * D, one launch each.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from mujoco_mpc_tpu_torch.ops import norms
from mujoco_mpc_tpu_torch.ops import spline
from mujoco_mpc_tpu_torch.physics import forward as fwd
from mujoco_mpc_tpu_torch.physics import support
from mujoco_mpc_tpu_torch.physics.model import Data, Model
from mujoco_mpc_tpu_torch.tasks.base import (RISK_NEUTRAL_TOLERANCE,
                                             TaskParams, TaskSpec)
from mujoco_mpc_tpu_torch.utils import math as tm


@dataclasses.dataclass(frozen=True)
class Trajectory:
  """Nominal trajectory records, leading time axis T."""
  qpos: torch.Tensor       # (T, nq)
  qvel: torch.Tensor       # (T, nv)
  act: torch.Tensor        # (T, na)
  time: torch.Tensor       # (T,)
  actions: torch.Tensor    # (T, nu)
  residuals: torch.Tensor  # (T, nres)
  costs: torch.Tensor      # (T,)


@dataclasses.dataclass(frozen=True)
class Derivatives:
  a: torch.Tensor     # (T-1, ndx, ndx) dynamics state Jacobians
  b: torch.Tensor     # (T-1, ndx, nu) dynamics action Jacobians
  cx: torch.Tensor    # (T, ndx) cost state gradients
  cu: torch.Tensor    # (T, nu) cost action gradients
  cxx: torch.Tensor   # (T, ndx, ndx) Gauss-Newton cost state Hessians
  cxu: torch.Tensor   # (T, ndx, nu)
  cuu: torch.Tensor   # (T, nu, nu)


def ndx(m: Model) -> int:
  return 2 * m.nv + m.na


def nominal_trajectory(spec: TaskSpec, d0: Data, actions: torch.Tensor,
                       params: TaskParams) -> Trajectory:
  """Roll actions (T, nu) out from the B = 1 state d0, recording states,
  residuals and costs."""
  m = spec.model
  t, qpos, qvel, act = d0.time, d0.qpos, d0.qvel, d0.act
  rec = []
  for k in range(actions.shape[0]):
    d = d0.replace(time=t, qpos=qpos, qvel=qvel, act=act,
                   ctrl=actions[k][None])
    df = fwd.forward(m, d)
    rec.append((qpos, qvel, act, t,
                spec.residual_fn(m, df, params.residual_params)))
    d = fwd.integrate(m, df)
    t, qpos, qvel, act = d.time, d.qpos, d.qvel, d.act
  qpos, qvel, act, time, residuals = (torch.cat(x) for x in zip(*rec))
  return Trajectory(qpos=qpos, qvel=qvel, act=act, time=time,
                    actions=actions, residuals=residuals,
                    costs=spec.cost(residuals, params))


def _perturbed_data(m: Model, template: Data, qpos, qvel, act, time, dx, du,
                    u) -> Data:
  """The knots (K of them, batch-first) moved by dx (K, ndx), du (K, nu);
  template is the B = 1 state the other fields come from."""
  qp = support.integrate_state(m, qpos, dx[:, :m.nv], 1.0)
  qv = qvel + dx[:, m.nv:2 * m.nv]
  a = act + dx[:, 2 * m.nv:] if m.na else act
  return template.expand(qpos.shape[0]).replace(
      qpos=qp, qvel=qv, act=a, time=time, ctrl=u + du)


def transition_derivs(spec: TaskSpec, template: Data,
                      traj: Trajectory) -> Tuple[torch.Tensor, torch.Tensor]:
  """Exact A (T-1, ndx, ndx) and B (T-1, ndx, nu) along the trajectory:
  one step of the T - 1 knots under ndx + nu tangent directions."""
  m = spec.model
  nd = ndx(m)

  def step_tangent(z):
    d = _perturbed_data(m, template, traj.qpos[:-1], traj.qvel[:-1],
                        traj.act[:-1], traj.time[:-1], z[:, :nd], z[:, nd:],
                        traj.actions[:-1])
    d = fwd.step(m, d)
    out = [support.state_diff(m, traj.qpos[1:], d.qpos),
           d.qvel - traj.qvel[1:]]
    if m.na:
      out.append(d.act - traj.act[1:])
    return torch.cat(out, -1)

  z = torch.zeros((traj.qpos.shape[0] - 1, nd + m.nu),
                  dtype=traj.qpos.dtype, device=traj.qpos.device)
  jac = tm.jacfwd_batched(step_tangent, z)
  return jac[:, :, :nd], jac[:, :, nd:]


def _risk_chain(spec: TaskSpec, params: TaskParams, residual: torch.Tensor,
                rx: torch.Tensor, ru: torch.Tensor):
  """Gauss-Newton cost expansion with the exact risk-transform chain rule;
  residual (K, nres), rx (K, nres, ndx), ru (K, nres, nu)."""
  sx = su = sxx = sxu = suu = s = 0.0
  offset = 0
  for k in range(spec.num_term):
    dim = spec.term_dims[k]
    r = residual[:, offset:offset + dim]
    jrx = rx[:, offset:offset + dim]
    jru = ru[:, offset:offset + dim]
    w = params.weights[k]
    p = params.norm_params[k]
    t = spec.norm_types[k]
    s = s + w * norms.norm_value(r, p, t)
    g = w * norms.norm_grad(r, p, t)             # (K, dim)
    h = w * norms.norm_hess(r, p, t)             # (K, dim, dim)
    jrx_t, jru_t = jrx.transpose(1, 2), jru.transpose(1, 2)
    sx = sx + (jrx_t @ g[..., None])[..., 0]
    su = su + (jru_t @ g[..., None])[..., 0]
    sxx = sxx + jrx_t @ (h @ jrx)
    sxu = sxu + jrx_t @ (h @ jru)
    suu = suu + jru_t @ (h @ jru)
    offset += dim

  risk = params.risk
  neutral = torch.abs(risk) < RISK_NEUTRAL_TOLERANCE
  rho = torch.where(neutral, torch.zeros_like(risk), risk)
  phi1 = torch.exp(rho * s)             # phi'; 1 when neutral
  phi2 = rho * phi1                      # phi''; 0 when neutral
  p1, p2 = phi1[:, None], phi2[:, None, None]

  def outer(a, b):
    return a[:, :, None] * b[:, None, :]
  return (p1 * sx, p1 * su, p1[..., None] * sxx + p2 * outer(sx, sx),
          p1[..., None] * sxu + p2 * outer(sx, su),
          p1[..., None] * suu + p2 * outer(su, su))


def cost_derivs(spec: TaskSpec, template: Data, traj: Trajectory,
                params: TaskParams):
  """(cx, cu, cxx, cxu, cuu) along the trajectory, leading axis T."""
  m = spec.model
  nd = ndx(m)

  def residual_tangent(z):
    d = _perturbed_data(m, template, traj.qpos, traj.qvel, traj.act,
                        traj.time, z[:, :nd], z[:, nd:], traj.actions)
    d = fwd.forward(m, d)
    return spec.residual_fn(m, d, params.residual_params)

  z = torch.zeros((traj.qpos.shape[0], nd + m.nu), dtype=traj.qpos.dtype,
                  device=traj.qpos.device)
  jr = tm.jacfwd_batched(residual_tangent, z)
  return _risk_chain(spec, params, traj.residuals, jr[:, :, :nd],
                     jr[:, :, nd:])


def compute(spec: TaskSpec, template: Data, traj: Trajectory,
            params: TaskParams) -> Derivatives:
  a, b = transition_derivs(spec, template, traj)
  cx, cu, cxx, cxu, cuu = cost_derivs(spec, template, traj, params)
  return Derivatives(a=a, b=b, cx=cx, cu=cu, cxx=cxx, cxu=cxu, cuu=cuu)


def spline_mapping(times: torch.Tensor, rollout_times: torch.Tensor,
                   interp: int) -> torch.Tensor:
  """The linear operator M (T, P) of the spline sampler: actions(t_j) =
  sum_p M[j, p] values[p], per control channel (gradient/spline_mapping.cc).
  JAX takes jacfwd of the sampler; the sampler is linear in the values, so
  here it is the sampler evaluated on the P unit knot vectors."""
  p = times.shape[0]
  basis = torch.eye(p, dtype=times.dtype, device=times.device)[..., None]
  return spline.sample_many(times, basis, rollout_times, interp)[..., 0].T
