"""Direct trajectory optimizer: estimation over a window of configurations.

Port of mujoco_mpc_tpu/estimators/direct.py (DirectProblem :38,
DirectData :47, DirectSettings :56, default_settings :65, _configs :72,
_vel_acc :78, residuals :88, cost :116, _residual_triple :137,
_banded_normal_equations :161, optimize :206, make_problem :279,
ParameterModel :302, damping_parameter_model :308,
site_offset_parameter_model :315, optimize_joint :322), the reference's
Direct optimizer (mjpc/direct/direct.{h,cc}). The decision variables are
tangent displacements z_{0:T-1} of the window's configurations,
minimizing

    sum_t || s(q_t, v_t, a_t) - y_t ||^2_{W_s}   (sensors)
  + sum_t || g(q_t, v_t, a_t) - tau_t ||^2_{W_f} (forces, mj_inverse)
  [+ 0.5 || z - z_prior ||^2_P ]                 (the batch prior)

with v and a finite differences on the manifold (direct.cc:1863) and g
inverse dynamics (physics/inverse.py). One window a call: the window's
interior steps are the physics batch (JAX vmaps over them), the
stencil's Jacobian blocks one jacfwd_batched over 3 nv directions, the
line search's candidate windows one batch, and the damped Gauss-Newton
system a block-pentadiagonal Cholesky (ops/banded.py). The host loops
over the iterations where JAX scans. Inverse dynamics solves nothing, so
nothing here launches a kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from mujoco_mpc_tpu_torch.ops import banded
from mujoco_mpc_tpu_torch.physics import forward as fwd
from mujoco_mpc_tpu_torch.physics import inverse as inv_mod
from mujoco_mpc_tpu_torch.physics import sensors as sensors_mod
from mujoco_mpc_tpu_torch.physics import support
from mujoco_mpc_tpu_torch.physics.model import Data, Model
from mujoco_mpc_tpu_torch.utils import math as tm

ALPHAS = (1.0, 0.5, 0.25, 0.0625, 0.0)   # the line search's step scales


class DirectProblem(NamedTuple):
  """The problem's static definition."""
  model: Model
  template: Data           # batch 1
  horizon: int             # T
  sensor_start: int        # first sensordata column
  sensor_dim: int


@dataclasses.dataclass(frozen=True)
class DirectData:
  """The window's measurements, time-major."""
  qpos_ref: torch.Tensor     # (T, nq) reference configurations
  sensor_meas: torch.Tensor  # (T, ns)
  force_meas: torch.Tensor   # (T, nv) applied generalized forces tau
  times: torch.Tensor        # (T,)

  def replace(self, **changes) -> 'DirectData':
    return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class DirectSettings:
  sensor_weight: torch.Tensor   # (ns,) 1 / sigma^2
  force_weight: torch.Tensor    # (nv,)
  prior_weight: torch.Tensor    # 0-d (0 disables the batch prior)
  max_iterations: int = 10
  regularization: float = 1e-6

  def replace(self, **changes) -> 'DirectSettings':
    return dataclasses.replace(self, **changes)


def default_settings(p: DirectProblem,
                     dtype: Optional[torch.dtype] = None) -> DirectSettings:
  kw = dict(dtype=dtype or p.model.dtype, device=p.model.device)
  return DirectSettings(sensor_weight=torch.ones(p.sensor_dim, **kw),
                        force_weight=torch.ones(p.model.nv, **kw),
                        prior_weight=torch.zeros((), **kw))


def make_problem(model: Model, template: Data, horizon: int,
                 sensor_start_index: int = 0,
                 sensor_count: Optional[int] = None) -> DirectProblem:
  """A problem over a range of the model's sensors (the task XMLs'
  estimator_sensor_start convention)."""
  if sensor_count is None:
    sensor_count = len(model.sensor_type) - sensor_start_index
  adr0 = model.sensor_adr[sensor_start_index]
  last = sensor_start_index + sensor_count - 1
  return DirectProblem(model=model, template=template, horizon=horizon,
                       sensor_start=adr0,
                       sensor_dim=model.sensor_adr[last]
                       + model.sensor_dim[last] - adr0)


def _configs(p: DirectProblem, qpos_ref: torch.Tensor,
             z: torch.Tensor) -> torch.Tensor:
  """Configurations (..., nq) from reference ones (..., nq) and tangent
  displacements (..., nv)."""
  lead = qpos_ref.shape[:-1]
  return fwd.integrate_pos(p.model, qpos_ref.reshape(-1, p.model.nq),
                           z.reshape(-1, p.model.nv), 1.0).reshape(
                               *lead, p.model.nq)


def _step_residuals(p: DirectProblem, q_prev, q, q_next, y, tau, h,
                    settings: DirectSettings) -> torch.Tensor:
  """Weighted residuals (B, ns + nv) at B interior steps from their
  configuration stencils (q_{t-1}, q_t, q_{t+1}), each (B, nq):
  v_t = (q_t - q_{t-1}) / h, a_t = (v_{t+1} - v_t) / h, then inverse
  dynamics and the sensors at (q_t, v_t, a_t)."""
  m = p.model
  v_t = support.state_diff(m, q_prev, q) / h
  v_n = support.state_diff(m, q, q_next) / h
  d = p.template.expand(q.shape[0]).replace(qpos=q, qvel=v_t,
                                            qacc=(v_n - v_t) / h)
  d = inv_mod.inverse(m, d)
  s = sensors_mod.sensordata(m, d)[:, p.sensor_start:p.sensor_start
                                   + p.sensor_dim]
  return torch.cat([torch.sqrt(settings.sensor_weight) * (s - y),
                    torch.sqrt(settings.force_weight)
                    * (d.qfrc_smooth - tau)], -1)


def _window_residuals(p: DirectProblem, data: DirectData, zs: torch.Tensor,
                      settings: DirectSettings) -> torch.Tensor:
  """Residuals (K, (T-2)(ns + nv)) of K windows' displacements zs
  (K, T nv), all K (T - 2) interior steps as one batch."""
  k, t = zs.shape[0], p.horizon
  qpos = _configs(p, data.qpos_ref.expand(k, t, p.model.nq),
                  zs.reshape(k, t, p.model.nv))
  h = data.times[1] - data.times[0]
  flat = lambda x: x.reshape(-1, x.shape[-1])  # noqa: E731
  rep = lambda x: flat(x[None].expand(k, *x.shape))  # noqa: E731
  r = _step_residuals(p, flat(qpos[:, :-2]), flat(qpos[:, 1:-1]),
                      flat(qpos[:, 2:]), rep(data.sensor_meas[1:-1]),
                      rep(data.force_meas[1:-1]), h, settings)
  return r.reshape(k, -1)


def residuals(p: DirectProblem, data: DirectData, z: torch.Tensor,
              settings: DirectSettings) -> torch.Tensor:
  """The stacked weighted residual vector over the window's interior
  t = 1..T-2, where both v and a are defined."""
  return _window_residuals(p, data, z[None], settings)[0]


def _costs(p: DirectProblem, data: DirectData, zs: torch.Tensor,
           settings: DirectSettings, z_prior=None, prior_diag=None,
           prior_off1=None) -> torch.Tensor:
  """Costs (K,) of K windows' displacements zs (K, T nv)."""
  r = _window_residuals(p, data, zs, settings)
  c = 0.5 * torch.sum(r * r, -1)
  if z_prior is not None:
    dz = zs - z_prior
    if prior_diag is not None:
      # the band prior 0.5 dz' P dz, P block-tridiagonal (batch.h:162)
      dzb = dz.reshape(zs.shape[0], p.horizon, p.model.nv)
      c = c + 0.5 * torch.einsum('kti,tij,ktj->k', dzb, prior_diag, dzb)
      c = c + torch.einsum('kti,tij,ktj->k', dzb[:, 1:], prior_off1,
                           dzb[:, :-1])
    else:
      c = c + 0.5 * settings.prior_weight * torch.sum(dz * dz, -1)
  return c


def cost(p: DirectProblem, data: DirectData, z: torch.Tensor,
         settings: DirectSettings, z_prior: Optional[torch.Tensor] = None,
         prior_diag: Optional[torch.Tensor] = None,
         prior_off1: Optional[torch.Tensor] = None) -> torch.Tensor:
  return _costs(p, data, z[None], settings, z_prior, prior_diag,
                prior_off1)[0]


def _stencils(p: DirectProblem, data: DirectData, z: torch.Tensor):
  """The interior steps' stencils: z3 (T-2, 3 nv) and qref3 (T-2, 3, nq)."""
  zb = z.reshape(p.horizon, p.model.nv)
  z3 = torch.stack([zb[:-2], zb[1:-1], zb[2:]], 1).reshape(p.horizon - 2, -1)
  q = data.qpos_ref
  return z3, torch.stack([q[:-2], q[1:-1], q[2:]], 1)


def _residual_triple(p: DirectProblem, z3: torch.Tensor, qref3: torch.Tensor,
                     y: torch.Tensor, tau: torch.Tensor, h,
                     settings: DirectSettings) -> torch.Tensor:
  """Residuals (B, ns + nv) at B interior steps from their
  3-configuration stencils z3 (B, 3 nv) around qref3 (B, 3, nq): the
  locality that makes the Hessian banded (direct.cc band assembly, nband
  3 nv)."""
  qs = _configs(p, qref3, z3.reshape(-1, 3, p.model.nv))
  return _step_residuals(p, qs[:, 0], qs[:, 1], qs[:, 2], y, tau, h,
                         settings)


def _assemble(p: DirectProblem, jb: torch.Tensor, r: torch.Tensor):
  """Stencil Jacobian blocks jb (Ti, nr, 3, nv) and residuals r (Ti, nr)
  -> the block-pentadiagonal J'J (diag, off1, off2) and J'r (T, nv)."""
  nv, t = p.model.nv, p.horizon
  ti = t - 2
  prod = torch.einsum('tikm,tiln->tklmn', jb, jb)
  gt = torch.einsum('tikm,ti->tkm', jb, r)
  kw = dict(dtype=r.dtype, device=r.device)
  diag = torch.zeros((t, nv, nv), **kw)
  off1 = torch.zeros((t - 1, nv, nv), **kw)
  off2 = torch.zeros((t - 2, nv, nv), **kw)
  g = torch.zeros((t, nv), **kw)
  for k in range(3):   # stencil offset k lands on block i + k
    diag[k:k + ti] += prod[:, k, k]
    g[k:k + ti] += gt[:, k]
  # off1[j] (block j+1, j): (k 2, l 1) at j = i + 1, (k 1, l 0) at j = i
  off1[1:1 + ti] += prod[:, 2, 1]
  off1[0:ti] += prod[:, 1, 0]
  off2[0:ti] += prod[:, 2, 0]     # off2[j] (block j+2, j): (k 2, l 0)
  return diag, off1, off2, g


def _banded_normal_equations(p: DirectProblem, data: DirectData,
                             z: torch.Tensor, settings: DirectSettings):
  """Per-step Jacobian blocks -> the block-pentadiagonal Gauss-Newton
  system (diag (T, nv, nv), off1, off2, g (T, nv)): each interior
  residual touches only (z_{t-1}, z_t, z_{t+1}), so the Jacobian is over
  a 3 nv stencil, all steps at once (mju_cholFactorBand's structure,
  direct.cc:2372)."""
  h = data.times[1] - data.times[0]
  z3, qref3 = _stencils(p, data, z)
  y, tau = data.sensor_meas[1:-1], data.force_meas[1:-1]

  def r_of(zz):
    return _residual_triple(p, zz, qref3, y, tau, h, settings)

  r = r_of(z3)
  jac = tm.jacfwd_batched(r_of, z3)                 # (Ti, nr, 3 nv)
  return _assemble(p, jac.reshape(p.horizon - 2, -1, 3, p.model.nv), r)


def _pad_even(diag, off1, off2, *vecs):
  """Pad the window to an even block count for superblocking: an identity
  block, zero couplings and zero right-hand sides."""
  eye = torch.eye(diag.shape[-1], dtype=diag.dtype, device=diag.device)
  pad = lambda x: torch.cat([x, torch.zeros_like(x[:1])], 0)  # noqa: E731
  return (torch.cat([diag, eye[None]], 0), pad(off1), pad(off2),
          *(pad(v) for v in vecs))


def _line_search(costs_of, z, step, lam, extra=None):
  """Damped Gauss-Newton's step choice: the candidates z - alpha step
  (ALPHAS), a NaN cost (a failed factor) read as infinite; an improvement
  takes the best and halves the damping, none keeps z and multiplies it
  by 10 (direct.cc:2210). Returns (z, extra, lam, cost)."""
  alphas = torch.tensor(ALPHAS, dtype=z.dtype, device=z.device)
  cands = z[None] - alphas[:, None] * step[None]
  ecands = (None if extra is None
            else extra[0][None] - alphas[:, None] * extra[1][None])
  both = costs_of(torch.cat([z[None], cands]),
                  None if extra is None else torch.cat([extra[0][None],
                                                        ecands]))
  c0 = both[0]
  costs = torch.nan_to_num(both[1:], nan=float('inf'))
  best = torch.argmin(costs)
  improved = costs[best] < c0
  z_new = torch.where(improved, cands[best], z)
  e_new = None if extra is None else torch.where(improved, ecands[best],
                                                 extra[0])
  lam_new = torch.where(improved, torch.clamp(lam * 0.5, min=1e-10),
                        lam * 10.0)
  return z_new, e_new, lam_new, torch.where(improved, costs[best], c0)


def optimize(p: DirectProblem, data: DirectData, settings: DirectSettings,
             z0: Optional[torch.Tensor] = None,
             z_prior: Optional[torch.Tensor] = None,
             prior_diag: Optional[torch.Tensor] = None,
             prior_off1: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, dict]:
  """Damped Gauss-Newton over the window (Direct::Optimize): returns z
  (T nv) and {'final_cost', 'cost_trace', 'qpos' (T, nq)}."""
  nv, t = p.model.nv, p.horizon
  dtype, device = data.qpos_ref.dtype, data.qpos_ref.device
  z = torch.zeros(t * nv, dtype=dtype, device=device) if z0 is None else z0
  eye = torch.eye(nv, dtype=dtype, device=device)
  lam = torch.tensor(settings.regularization, dtype=dtype, device=device)

  def costs_of(zs, _):
    return _costs(p, data, zs, settings, z_prior, prior_diag, prior_off1)

  trace = []
  for _ in range(settings.max_iterations):
    diag, off1, off2, g = _banded_normal_equations(p, data, z, settings)
    if z_prior is not None:
      dzb = (z - z_prior).reshape(t, nv)
      if prior_diag is not None:
        g = g + torch.einsum('tij,tj->ti', prior_diag, dzb)
        g[1:] += torch.einsum('tij,tj->ti', prior_off1, dzb[:-1])
        g[:-1] += torch.einsum('tji,tj->ti', prior_off1, dzb[1:])
        diag = diag + prior_diag
        off1 = off1 + prior_off1
      else:
        g = g + settings.prior_weight * dzb
        diag = diag + settings.prior_weight * eye
    diag = diag + lam * eye
    if t % 2:
      step = banded.block_pentadiag_solve(*_pad_even(diag, off1, off2, g)
                                          )[:-1].reshape(-1)
    else:
      step = banded.block_pentadiag_solve(diag, off1, off2, g).reshape(-1)
    z, _, lam, c = _line_search(costs_of, z, step, lam)
    trace.append(c)
  cost_trace = torch.stack(trace)
  return z, {'final_cost': cost_trace[-1], 'cost_trace': cost_trace,
             'qpos': _configs(p, data.qpos_ref, z.reshape(t, nv))}


# ---------------------------------------------------------------------------
# Model-parameter estimation (the reference's pluggable ModelParameters,
# mjpc/direct/model_parameters.{h,cc}; direct.cc ntotal = nv T + nparam,
# the parameter columns a dense border of the band matrix).
# ---------------------------------------------------------------------------


class ParameterModel(NamedTuple):
  """A parameter hook: theta (nparam,) -> the modified Model."""
  apply: Callable[[Model, torch.Tensor], Model]
  nparam: int


def damping_parameter_model(nv: int) -> ParameterModel:
  """theta scales the joint damping by exp(theta[0])."""
  def apply(m: Model, theta: torch.Tensor) -> Model:
    return m.replace(dof_damping=m.dof_damping * torch.exp(theta[0]))
  return ParameterModel(apply=apply, nparam=1)


def site_offset_parameter_model(site_id: int) -> ParameterModel:
  """theta (3,) offsets one site's position."""
  def apply(m: Model, theta: torch.Tensor) -> Model:
    return m.replace(site_pos=m.site_pos.index_add(
        0, torch.tensor([site_id], device=m.device), theta[None]))
  return ParameterModel(apply=apply, nparam=3)


def optimize_joint(p: DirectProblem, data: DirectData,
                   settings: DirectSettings, pmodel: ParameterModel,
                   theta0: torch.Tensor, z0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
  """Joint Gauss-Newton over (configurations z, model parameters theta).

  The system is bordered-banded: the banded configuration block goes
  through the block-pentadiagonal Cholesky and the dense parameter
  border is eliminated by a Schur complement (the reference folds the
  border into one band of width 3 nv + nparam, direct.cc:135-136). The
  parameter Jacobian is one more jacfwd_batched, over nparam directions;
  the line search's candidates are one batch a parameter vector, since
  each candidate has its own model."""
  nv, t = p.model.nv, p.horizon
  npar = pmodel.nparam
  dtype, device = data.qpos_ref.dtype, data.qpos_ref.device
  z = torch.zeros(t * nv, dtype=dtype, device=device) if z0 is None else z0
  theta = theta0
  eye = torch.eye(nv, dtype=dtype, device=device)
  lam = torch.tensor(settings.regularization, dtype=dtype, device=device)
  h = data.times[1] - data.times[0]
  y, tau = data.sensor_meas[1:-1], data.force_meas[1:-1]

  def r_of(zz, th, qref3):
    pt = p._replace(model=pmodel.apply(p.model, th))
    return _residual_triple(pt, zz, qref3, y, tau, h, settings)

  def costs_of(zs, thetas):
    return torch.stack([
        _costs(p._replace(model=pmodel.apply(p.model, th)), data, zz[None],
               settings)[0] for zz, th in zip(zs, thetas)])

  trace = []
  for _ in range(settings.max_iterations):
    z3, qref3 = _stencils(p, data, z)
    r = r_of(z3, theta, qref3)
    jz = tm.jacfwd_batched(lambda zz: r_of(zz, theta, qref3), z3)
    # d r / d theta for every step: theta's directions, the steps unmapped
    basis = torch.eye(npar, dtype=dtype, device=device)
    jt = torch.func.vmap(lambda v: torch.func.jvp(
        lambda th: r_of(z3, th, qref3), (theta,), (v,))[1])(basis)
    jt = jt.permute(1, 2, 0)                        # (Ti, nr, np)
    jb = jz.reshape(t - 2, -1, 3, nv)
    diag, off1, off2, g = _assemble(p, jb, r)
    ub = torch.einsum('tikm,tip->tkmp', jb, jt)
    u = torch.zeros((t, nv, npar), dtype=dtype, device=device)
    for k in range(3):
      u[k:k + t - 2] += ub[:, k]
    c_mat = (torch.einsum('tip,tiq->pq', jt, jt)
             + lam * torch.eye(npar, dtype=dtype, device=device))
    g_theta = torch.einsum('tip,ti->p', jt, r)
    diag = diag + lam * eye
    if t % 2:
      diag, off1, off2, g, u = _pad_even(diag, off1, off2, g, u)
    tp = diag.shape[0]
    ld, ll = banded.block_tridiag_cholesky(
        *banded.pentadiag_to_superblocks(diag, off1, off2))

    def band_solve(rhs):   # (Tp, nv)
      return banded.block_tridiag_solve(
          ld, ll, rhs.reshape(tp // 2, 2 * nv)).reshape(tp, nv)

    y_sol = band_solve(g)
    w_sol = torch.stack([band_solve(u[..., i]) for i in range(npar)], -1)
    schur = c_mat - torch.einsum('tnp,tnq->pq', u, w_sol)
    rhs_theta = g_theta - torch.einsum('tnp,tn->p', u, y_sol)
    dtheta = torch.linalg.solve(schur, rhs_theta)
    dz = (y_sol - w_sol @ dtheta)[:t].reshape(-1)
    z, theta, lam, c = _line_search(costs_of, z, dz, lam, (theta, dtheta))
    trace.append(c)
  cost_trace = torch.stack(trace)
  return z, theta, {'final_cost': cost_trace[-1], 'cost_trace': cost_trace}
