"""Soft-constraint rows and the primal Newton solve, batch-first.

Port of mujoco_mpc_tpu/physics/constraint.py: impedance :77, kbi :97,
ScalarRows :37, Rows :66, _limit_rows_scalar :115, make_rows_split :1213
and solve :1240, for dense rows plus one-hot joint-limit rows. The solve
itself is ops/newton.py (the fused Newton kernel B2 on CUDA, its plain
PyTorch version on the CPU).

Not ported yet, and refused where a model needs them: equality rows and
tendon limits (ROADMAP A8), contacts of every kind (A6), joint
frictionloss rows and elliptic cones (A8).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mujoco_mpc_tpu_torch.ops import newton as newton_op
from mujoco_mpc_tpu_torch.physics.model import Data, Model

_MIN_IMP, _MAX_IMP = 0.0001, 0.9999


class ScalarRows(NamedTuple):
  """One-hot rows (joint limits): J row = sign * e_dof. dof (R,) int32 and
  sign (R,) float are model constants; the rest are (B, R)."""
  dof: torch.Tensor
  sign: torch.Tensor
  pos: torch.Tensor
  margin: torch.Tensor
  aref: torch.Tensor
  d: torch.Tensor
  active: torch.Tensor


class Rows(NamedTuple):
  """A dense block of constraint rows: j (B, n, nv), the rest (B, n)."""
  j: torch.Tensor
  pos: torch.Tensor
  margin: torch.Tensor
  aref: torch.Tensor
  d: torch.Tensor
  active: torch.Tensor
  equality: torch.Tensor


def impedance(solimp: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
  """MuJoCo constraint impedance d(pos) in (0, 1), endpoints clamped
  before interpolation (mj_assignImpedance)."""
  d0, dw, width, mid, power = solimp.unbind(-1)
  d0 = torch.clamp(d0, _MIN_IMP, _MAX_IMP)
  dw = torch.clamp(dw, _MIN_IMP, _MAX_IMP)
  x = torch.clamp(torch.abs(pos) / torch.clamp(width, min=1e-12), 0.0, 1.0)
  mid = torch.clamp(mid, 1e-6, 1 - 1e-6)
  power = torch.clamp(power, min=1.0)
  y_lo = (x / mid) ** power * mid
  y_hi = 1.0 - ((1.0 - x) / (1.0 - mid)) ** power * (1.0 - mid)
  y = torch.where(x <= mid, y_lo, y_hi)
  return torch.clamp(d0 + y * (dw - d0), _MIN_IMP, _MAX_IMP)


def kbi(solref: torch.Tensor, solimp: torch.Tensor, pos: torch.Tensor):
  """Stiffness K, damping B and impedance I of a constraint row."""
  imp = impedance(solimp, pos)
  dmax = torch.clamp(torch.maximum(solimp[..., 0], solimp[..., 1]),
                     _MIN_IMP, _MAX_IMP)
  timeconst, dampratio = solref[..., 0], solref[..., 1]
  k_std = 1.0 / torch.clamp(
      dmax * dmax * timeconst * timeconst * dampratio * dampratio, min=1e-12)
  b_std = 2.0 / torch.clamp(dmax * timeconst, min=1e-12)
  k_dir = -solref[..., 0] / torch.clamp(dmax * dmax, min=1e-12)
  b_dir = -solref[..., 1] / torch.clamp(dmax, min=1e-12)
  direct = torch.logical_and(solref[..., 0] <= 0, solref[..., 1] <= 0)
  return (torch.where(direct, k_dir, k_std),
          torch.where(direct, b_dir, b_std), imp)


def _limit_rows_scalar(m: Model, d: Data) -> Optional[ScalarRows]:
  """Joint-limit rows in one-hot form: [all lower sides; all upper]."""
  idx = m.idx
  if len(idx.lim_ids) == 0:
    return None
  q = d.qpos[:, idx.lim_qadr]
  v = d.qvel[:, idx.lim_dof]
  rng = m.jnt_range[idx.lim_ids]
  margin = m.jnt_margin[idx.lim_ids]
  margin2 = torch.cat([margin, margin])
  pos = torch.cat([q - rng[:, 0], rng[:, 1] - q], -1) - margin2
  vv = torch.cat([v, -v], -1)
  solref = m.jnt_solref[idx.lim_ids].repeat(2, 1)
  solimp = m.jnt_solimp[idx.lim_ids].repeat(2, 1)
  k, b, imp = kbi(solref, solimp, pos)
  aref = -b * vv - k * imp * pos
  iw = m.dof_invweight0[idx.lim_dof].repeat(2)
  dd = imp / (1.0 - imp) / torch.clamp(iw, min=1e-12)
  return ScalarRows(idx.lim_dof2, idx.lim_sign, pos,
                    margin2.expand_as(pos), aref, dd, pos < 0.0)


def make_rows_split(m: Model, d: Data):
  """(dense Rows | None, ScalarRows | None) for the model (JAX returns
  cone, friction and contact-point blocks too; the port refuses models
  that have them)."""
  if m.neq:
    raise NotImplementedError('equality rows are not ported yet (ROADMAP A8)')
  if any(m.tendon_limited):
    raise NotImplementedError('tendon limits are not ported yet (ROADMAP A8)')
  if m.collision_pairs:
    raise NotImplementedError('contacts are not ported yet (ROADMAP A6)')
  if m.friction_dof:
    raise NotImplementedError(
        'frictionloss rows are not ported yet (ROADMAP A8)')
  return None, _limit_rows_scalar(m, d)


def solve(m: Model, d: Data, rows: Optional[Rows],
          scalar: Optional[ScalarRows] = None,
          max_iterations: Optional[int] = None,
          tolerance: Optional[float] = None) -> Data:
  """Primal Newton solve for qacc given constraint rows; d.qacc holds
  qacc_smooth on entry. Returns Data with the constrained qacc and
  qfrc_constraint."""
  if max_iterations is None:
    max_iterations = m.opt.iterations
  if tolerance is None:
    tolerance = 1e-5 if d.qpos.dtype == torch.float32 else 1e-8
  if rows is None and scalar is None:
    return d.replace(qfrc_constraint=torch.zeros_like(d.qvel))

  bsz = d.qpos.shape[0]
  kw = dict(dtype=d.qpos.dtype, device=d.qpos.device)
  if rows is not None:
    j_mat = rows.j
    aref_d = rows.aref
    dvec_d = torch.where(rows.active, rows.d, torch.zeros_like(rows.d))
    eqf = rows.equality.to(d.qpos.dtype)
  else:
    j_mat = torch.zeros((bsz, 0, m.nv), **kw)
    aref_d = dvec_d = eqf = torch.zeros((bsz, 0), **kw)
  if scalar is not None:
    dof, sign = scalar.dof, scalar.sign
    aref_s = scalar.aref
    dvec_s = torch.where(scalar.active, scalar.d, torch.zeros_like(scalar.d))
  else:
    dof = torch.zeros(0, dtype=torch.int32, device=d.qpos.device)
    sign = torch.zeros(0, **kw)
    aref_s = dvec_s = torch.zeros((bsz, 0), **kw)

  qacc, jar_d, jar_s = newton_op.newton(
      d.qM, d.qacc, j_mat, aref_d, dvec_d, eqf, aref_s, dvec_s, dof, sign,
      cap=int(max_iterations), tol=float(tolerance))

  qfrc_constraint = torch.zeros_like(d.qvel)
  if rows is not None:
    act = torch.logical_or(jar_d < 0, rows.equality)
    f_d = torch.where(act, -dvec_d * jar_d, torch.zeros_like(jar_d))
    qfrc_constraint = qfrc_constraint + (f_d[:, None, :] @ j_mat)[:, 0]
  if scalar is not None:
    f_s = torch.where(jar_s < 0, -dvec_s * jar_s, torch.zeros_like(jar_s))
    qfrc_constraint = qfrc_constraint.index_add(1, dof, sign * f_s)
  return d.replace(qacc=qacc, qfrc_constraint=qfrc_constraint)
