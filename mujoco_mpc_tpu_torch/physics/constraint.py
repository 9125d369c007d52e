"""Soft-constraint rows and the primal Newton solve, batch-first.

Port of mujoco_mpc_tpu/physics/constraint.py: impedance :77, kbi :97,
ScalarRows :37, FrictionRows :53, Rows :66, _limit_rows_scalar :115,
_friction_rows :143, _tendon_limit_rows :194, _equality_rows :229
(connect, weld with its torquescale, joint and fixed-tendon couplings),
the pyramidal contacts (ContactBlock :452, PointRows
:465, _contact_capacity :485, _pair_param_arrays :496, _contact_groups
:516 with the batched hull clusters and the mesh-mesh clusters' top-k
selection :575-594, _Stacked :631, contact_blocks :648, _dyn_contact_rows
:750, dof_anchored_axes :793, _capped_point_rows :808,
contact_point_groups :890, point_rows_jd :970, expand_point_rows :977),
ContactForces :1104 and contact_forces :1117 (pyramidal), _concat_rows
:1205, make_rows_split :1213 and solve :1240. The solve
itself is ops/newton.py (the fused Newton kernel B2 on CUDA, its plain
PyTorch version on the CPU); uncapped contacts reach it in the factored
point form, so the facet rows are built inside the kernel, and the
dynamically selected rows (the mesh-mesh clusters' and the capped
groups') as dense rows.

What JAX computes from model constants at trace time (the pair
parameters, body ids and ancestor-mask differences of each condim group,
the mesh-mesh clusters' pair parameters) the port computes once per
model, in `contact_table` and `dyn_table`, which physics/model.py
from_arrays stores as Model.contact and Model.contact_dyn.

The equality rows and the tendon-limit rows are dense rows, in JAX's
order (equality, tendon limits, then the dynamically selected contact
rows); the equality rows carry `equality`, which reaches B2 as eqf = 1
(two-sided, and always active in its tangent).

Not ported yet, and refused where a model needs them: elliptic cones
(ROADMAP A8).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mujoco_mpc_tpu_torch.ops import newton as newton_op
from mujoco_mpc_tpu_torch.physics import collision, smooth
from mujoco_mpc_tpu_torch.physics.model import Data, Model
from mujoco_mpc_tpu_torch.utils import math as tm

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


class FrictionRows(NamedTuple):
  """Joint-dof frictionloss rows: J row = e_dof, pos 0, a two-sided Huber
  cost (quadratic while |d jar| <= loss, linear beyond). dof (F,) int32
  and loss (F,) are model constants; aref and d are (B, F)."""
  dof: torch.Tensor
  aref: torch.Tensor
  d: torch.Tensor
  loss: torch.Tensor


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


def _friction_rows(m: Model, d: Data) -> Optional[FrictionRows]:
  """Frictionloss rows: D from the dof's solimpfriction impedance at pos 0
  over dof_invweight0, aref = -B v (no position term)."""
  if not m.friction_dof:
    return None
  dofs = m.idx.friction_dof
  v = d.qvel[:, dofs]
  _, b, imp = kbi(m.dof_friction_solref, m.dof_friction_solimp,
                  torch.zeros_like(v))
  iw = m.dof_invweight0[dofs]
  dd = imp / (1.0 - imp) / torch.clamp(iw, min=1e-12)
  return FrictionRows(dofs, -b * v, dd, m.dof_frictionloss)


def _tendon_limit_rows(m: Model, d: Data) -> Optional[Rows]:
  """Tendon-limit rows, 2 per limited tendon (lower side, then upper),
  as joint limits on ten_length with the rows +-ten_J."""
  limited = [ti for ti in range(m.ntendon) if m.tendon_limited[ti]]
  if not limited:
    return None
  kw = dict(dtype=d.qpos.dtype, device=d.qpos.device)
  tix = torch.tensor([ti for ti in limited for _ in (0, 1)],
                     device=d.qpos.device)
  lower = torch.tensor([side == 0 for _ in limited for side in (0, 1)],
                       device=d.qpos.device)
  length = d.ten_length[:, tix]
  rng = m.tendon_range[tix]
  margin = m.tendon_margin[tix]
  pos = torch.where(lower, length - rng[:, 0], rng[:, 1] - length) - margin
  sign = torch.where(lower, 1.0, -1.0).to(**kw)
  jac = sign[:, None] * d.ten_J[:, tix]
  vel = sign * d.ten_velocity[:, tix]
  k, b, imp = kbi(m.tendon_solref_lim[tix], m.tendon_solimp_lim[tix], pos)
  dd = imp / (1.0 - imp) / torch.clamp(m.tendon_invweight0[tix], min=1e-12)
  return Rows(jac, pos, margin.expand_as(pos), -b * vel - k * imp * pos, dd,
              pos < 0.0, torch.zeros_like(pos, dtype=torch.bool))


def _poly(poly, dif):
  """The coupling polynomial and its derivative at dif."""
  p = (poly[0] + poly[1] * dif + poly[2] * dif ** 2 + poly[3] * dif ** 3
       + poly[4] * dif ** 4)
  dp = (poly[1] + 2 * poly[2] * dif + 3 * poly[3] * dif ** 2
        + 4 * poly[4] * dif ** 3)
  return p, dp


def _point_acc(m: Model, d: Data, cacc, body: int, point):
  """The classical acceleration at zero qacc (B, 3) of world points (B, 3)
  fixed on a body, from com_vel's cvel and the velocity-product spatial
  accelerations cacc (B, nbody, 6) (the accelerometer's formula,
  sensors.py)."""
  rel = point - d.subtree_com[:, m.body_rootid[body]]
  w = d.cvel[:, body, :3]
  v = d.cvel[:, body, 3:] + tm.cross(w, rel)
  return cacc[:, body, 3:] + tm.cross(cacc[:, body, :3], rel) + tm.cross(w, v)


def _equality_rows(m: Model, d: Data) -> Optional[Rows]:
  """Equality rows (mjEQ_CONNECT, WELD, JOINT, TENDON) of the active
  equalities: two-sided soft rows, each equality's impedance from the norm
  of its whole residual. Connect and weld rows subtract the velocity bias
  Jdot qvel, the residual's second derivative along the constant-qvel
  path (JAX takes it by nested jvps through kinematics, :415-437; here
  in closed form from the bodies' velocities and their accelerations at
  zero qacc: the anchors' classical accelerations and the error
  quaternion's second derivative, dq/dt = 0.5 (0, w) q in the world
  frame); the joint and tendon couplings carry none, as in MuJoCo."""
  if m.neq == 0:
    return None
  kw = dict(dtype=d.qpos.dtype, device=d.qpos.device)
  eye = torch.eye(m.nv, **kw)
  js, poss, arefs, ds = [], [], [], []
  cacc = None

  def add(e, rows):
    """rows: [(jac (B, nv), pos (B,), invweight, bias (B,) or None)] of
    equality e."""
    pos_norm = torch.sqrt(sum(r[1] * r[1] for r in rows))
    k, b, imp = kbi(m.eq_solref[e], m.eq_solimp[e], pos_norm)
    for jac, pos, invweight, bias in rows:
      vel = torch.sum(jac * d.qvel, -1)
      aref = -b * vel - k * imp * pos
      js.append(jac)
      poss.append(pos)
      arefs.append(aref if bias is None else aref - bias)
      ds.append(imp / (1.0 - imp) / torch.clamp(invweight, min=1e-12))

  def quat(w):
    return torch.cat([torch.zeros_like(w[..., :1]), w], -1)

  for e in range(m.neq):
    if not m.eq_active0[e]:
      continue
    etype, data = m.eq_type[e], m.eq_data[e]
    b1, b2 = m.eq_obj1id[e], m.eq_obj2id[e]
    if etype in (0, 1):   # connect, weld: body1's anchor against body2's
      if cacc is None:    # the bodies' spatial accelerations at qacc = 0
        cacc = m.idx.a_body @ (d.cdof_dot * d.qvel[..., None])
      a1, a2 = data[0:3], data[3:6]
      if etype == 1:      # a weld anchors the other way round
        a1, a2 = a2, a1
      pos1 = d.xpos[:, b1] + d.xmat[:, b1] @ a1
      pos2 = d.xpos[:, b2] + d.xmat[:, b2] @ a2
      jacp1, jacr1 = smooth._body_jac(m, d, b1, pos1)
      jacp2, jacr2 = smooth._body_jac(m, d, b2, pos2)
      cpos = pos1 - pos2
      jac = jacp1 - jacp2                                     # (B, nv, 3)
      bias = (_point_acc(m, d, cacc, b1, pos1)
              - _point_acc(m, d, cacc, b2, pos2))
      iw = m.body_invweight0[b1, 0] + m.body_invweight0[b2, 0]
      rows = [(jac[..., r], cpos[:, r], iw, bias[:, r]) for r in range(3)]
      if etype == 1:
        # orientation: torquescale vec(conj(q2 relpose) q1), its rows the
        # derivative in the world angular velocities through 0.5 (0, w) q
        relpose, torquescale = data[6:10], data[10]
        quat1 = d.xquat[:, b1]
        quat2 = tm.quat_mul(d.xquat[:, b2], relpose.expand_as(quat1))
        crot = tm.quat_mul(tm.quat_conj(quat2), quat1)        # error quat
        cpos_rot = torquescale * crot[:, 1:]
        dv1, dv2 = [], []
        for k in range(3):
          w = torch.eye(4, **kw)[k + 1].expand_as(quat1)
          dq1 = 0.5 * tm.quat_mul(w, quat1)
          dv1.append(tm.quat_mul(tm.quat_conj(quat2), dq1)[:, 1:])
          dq2 = 0.5 * tm.quat_mul(w, quat2)
          dv2.append(tm.quat_mul(tm.quat_conj(dq2), quat1)[:, 1:])
        jrot = torquescale * (jacr1 @ torch.stack(dv1, 1)
                              + jacr2 @ torch.stack(dv2, 1))  # (B, nv, 3)
        # the error quaternion's second derivative
        w1, w2 = d.cvel[:, b1, :3], d.cvel[:, b2, :3]
        dq1 = 0.5 * tm.quat_mul(quat(w1), quat1)
        dq2 = 0.5 * tm.quat_mul(quat(w2), quat2)
        ddq1 = 0.5 * (tm.quat_mul(quat(cacc[:, b1, :3]), quat1)
                      + tm.quat_mul(quat(w1), dq1))
        ddq2 = 0.5 * (tm.quat_mul(quat(cacc[:, b2, :3]), quat2)
                      + tm.quat_mul(quat(w2), dq2))
        ddcrot = (tm.quat_mul(tm.quat_conj(ddq2), quat1)
                  + 2.0 * tm.quat_mul(tm.quat_conj(dq2), dq1)
                  + tm.quat_mul(tm.quat_conj(quat2), ddq1))
        bias_rot = torquescale * ddcrot[:, 1:]
        iwr = m.body_invweight0[b1, 1] + m.body_invweight0[b2, 1]
        rows += [(jrot[..., r], cpos_rot[:, r], iwr, bias_rot[:, r])
                 for r in range(3)]
      add(e, rows)
    elif etype in (2, 3):   # joint or fixed-tendon coupling:
      poly = data[0:5]      # x1 - x1_0 = poly(x2 - x2_0)
      if etype == 2:
        def coord(j):
          return d.qpos[:, m.jnt_qposadr[j]] - m.qpos0[m.jnt_qposadr[j]]
        x1, row1 = coord(b1), eye[m.jnt_dofadr[b1]].expand_as(d.qvel)
        iw = m.dof_invweight0[m.jnt_dofadr[b1]]
      else:
        x1 = d.ten_length[:, b1] - m.ten_length0[b1]
        row1, iw = d.ten_J[:, b1], m.tendon_invweight0[b1]
      if b2 >= 0:
        if etype == 2:
          x2, row2 = coord(b2), eye[m.jnt_dofadr[b2]]
          iw = iw + m.dof_invweight0[m.jnt_dofadr[b2]]
        else:
          x2 = d.ten_length[:, b2] - m.ten_length0[b2]
          row2 = d.ten_J[:, b2]
          iw = iw + m.tendon_invweight0[b2]
        p, dp = _poly(poly, x2)
        add(e, [(row1 - dp[:, None] * row2, x1 - p, iw, None)])
      else:
        add(e, [(row1, x1 - poly[0], iw, None)])
    else:
      raise NotImplementedError(f'equality type {etype}')

  if not js:
    return None
  n = len(js)
  ones = torch.ones((d.qpos.shape[0], n), dtype=torch.bool,
                    device=d.qpos.device)
  pos = torch.stack(poss, 1)
  return Rows(torch.stack(js, 1), pos, torch.zeros_like(pos),
              torch.stack(arefs, 1), torch.stack(ds, 1), ones, ones)


class ContactBlock(NamedTuple):
  """One condim group of contact points as dense rows, with what decodes
  the facet forces back to contact wrenches."""
  rows: Rows
  condim: int
  nrep: int              # facet rows per point
  pos: torch.Tensor      # (B, P, 3) world contact points
  frame: torch.Tensor    # (B, P, 3, 3) rows (normal, t1, t2)
  mu: torch.Tensor       # (P, 3) (sliding, torsional, rolling)
  b1: np.ndarray         # (P,) body ids
  b2: np.ndarray


class PointRows(NamedTuple):
  """Pyramidal contact rows in factored point-direction form:
  jd[b, p, d, n] = (g[b, p, d] . cdofc[b, n]) * dmask[p, n]. Neither the
  direction Jacobians nor the facet rows are materialized on the hot
  path: the kernel builds each facet row from (g, cdofc, dmask)."""
  g: torch.Tensor       # (B, P, ndirs, 6): [pos x dir, dir] translational,
                        # [dir, 0] rotational directions
  cdofc: torch.Tensor   # (B, nv, 6) origin-anchored dof axes (shared)
  dmask: torch.Tensor   # (P, nv) float32 in {-1, 0, 1}, a model constant
  aref: torch.Tensor    # (B, nrep, P) per-facet reference acceleration
  dvec: torch.Tensor    # (B, P) penalty weight, 0 when inactive
  mu: torch.Tensor      # (B, 3, P) (sliding, torsional, rolling)
  condim: int


# The batched hull clusters, in the order JAX stacks them (constraint.py
# :583-594): kind -> (narrowphase over a cluster, points a pair, halves).
# box-mesh emits two pair-major halves (corners in the hull, then hull
# vertices in the box), each repeating the pair parameters 4 times.
CLUSTERS = {'sm': (collision.sphere_mesh_batched, 1, 1),
            'cm': (collision.capsule_mesh_batched, 2, 1),
            'pm': (collision.plane_mesh_batched, 4, 1),
            'bm': (collision.box_mesh_batched, 4, 2)}


@dataclasses.dataclass(frozen=True)
class Source:
  """Where a run of a group's points comes from: a batched hull cluster
  (`kind` in CLUSTERS) or one pair on the unrolled path (kind 'pair')."""
  kind: str
  pairs: Tuple[Tuple[int, int], ...]
  cluster: Optional[collision.HullCluster] = None


@dataclasses.dataclass(frozen=True)
class GroupConsts:
  """The model constants of one condim group: its sources, in JAX's
  stacking order (the clusters sm, cm, pm, bm, then the unclustered pairs
  in collision_pairs order), and its per-point parameters."""
  condim: int
  sources: Tuple[Source, ...]
  margin: torch.Tensor   # (P,)
  solref: torch.Tensor   # (P, 2)
  solimp: torch.Tensor   # (P, 5)
  mu: torch.Tensor       # (P, 3)
  invw: torch.Tensor     # (P,)
  b1: np.ndarray         # (P,) body ids
  b2: np.ndarray
  dmask: torch.Tensor    # (P, nv) float32: ancestor mask of b2 minus b1
  bodies: torch.Tensor   # (2, P) long: b1 and b2 on the device


@dataclasses.dataclass(frozen=True)
class DynConsts:
  """A mesh-mesh cluster's model constants for the dynamically selected
  condim-1 rows: the cluster and its pairs' parameters, (K, ...)."""
  cluster: collision.MeshCluster
  margin: torch.Tensor   # (K,)
  solref: torch.Tensor   # (K, 2)
  solimp: torch.Tensor   # (K, 5)
  invw: torch.Tensor     # (K,)
  bodies: torch.Tensor   # (2, K) long: b1 and b2


def _contact_capacity(m: Model, total: int) -> int:
  """The cap on a mesh-mesh cluster's selected rows: the model's
  `contact_cap` numeric when set, else JAX's default of 256."""
  return min(m.contact_cap or 256, total)


def _pair_param_arrays(m: Model, pairs, dtype):
  """Per-pair contact parameters stacked to (K, ...) constants."""
  params = [collision.pair_params(m, g1, g2) for (g1, g2) in pairs]
  return {
      'solref': torch.stack([p.solref for p in params]),
      'solimp': torch.stack([p.solimp for p in params]),
      'mu': torch.stack([p.friction for p in params]),
      'invw': torch.stack([p.invweight.to(dtype) for p in params]),
      'margin': torch.stack([p.includemargin.to(dtype) for p in params]),
      'b1': np.asarray([m.geom_bodyid[g1] for (g1, _) in pairs],
                       dtype=np.int64),
      'b2': np.asarray([m.geom_bodyid[g2] for (_, g2) in pairs],
                       dtype=np.int64),
  }


def _condim(m: Model, pair) -> int:
  condim = collision.pair_params(m, *pair).condim
  if condim not in newton_op.PYRAMID_FACETS:
    raise NotImplementedError(f'contact condim {condim}')
  return condim


def contact_table(m: Model) -> Tuple[GroupConsts, ...]:
  """The per-condim groups of the model's collision pairs (condim order
  1, 3, 4, 6), each with its sources in JAX's order and each pair's
  parameters repeated over the candidate points it emits
  (_contact_groups :541-628)."""
  _, sm, pm, bm, cm, clustered = collision.contact_clusters(m)
  by_condim = {}      # condim -> ([Source], [pair of each point])
  for kind, clusters in (('sm', sm), ('cm', cm), ('pm', pm), ('bm', bm)):
    _, reps, halves = CLUSTERS[kind]
    for cl in clusters:
      srcs, owner = by_condim.setdefault(_condim(m, cl[0]), ([], []))
      srcs.append(Source(kind, tuple(cl), collision.hull_cluster(m, cl)))
      owner += [p for _ in range(halves) for p in cl for _ in range(reps)]
  for pair in m.collision_pairs:
    if pair in clustered:
      continue
    srcs, owner = by_condim.setdefault(_condim(m, pair), ([], []))
    srcs.append(Source('pair', (pair,)))
    owner += [pair] * collision.points_per_pair(m, *pair)
  a_body = m.idx.a_body
  out = []
  for condim in sorted(by_condim):
    srcs, owner = by_condim[condim]
    pairs = sorted(set(owner), key=owner.index)
    pp = _pair_param_arrays(m, pairs, m.dtype)
    at = np.asarray([pairs.index(p) for p in owner])
    idx = torch.as_tensor(at, device=m.device)
    b1, b2 = pp['b1'][at], pp['b2'][at]
    out.append(GroupConsts(
        condim=condim, sources=tuple(srcs), margin=pp['margin'][idx],
        solref=pp['solref'][idx], solimp=pp['solimp'][idx],
        mu=pp['mu'][idx], invw=pp['invw'][idx], b1=b1, b2=b2,
        dmask=(a_body[b2] - a_body[b1]).to(torch.float32).contiguous(),
        bodies=torch.as_tensor(np.stack([b1, b2]), device=m.device)))
  return tuple(out)


def dyn_table(m: Model) -> Tuple[DynConsts, ...]:
  """The mesh-mesh clusters (condim 1) with their pairs' parameters
  (_contact_groups :575-594)."""
  mm = collision.contact_clusters(m)[0]
  out = []
  for cl in mm:
    pp = _pair_param_arrays(m, cl, m.dtype)
    out.append(DynConsts(
        collision.mesh_cluster(m, cl), pp['margin'], pp['solref'],
        pp['solimp'], pp['invw'],
        torch.as_tensor(np.stack([pp['b1'], pp['b2']]), device=m.device)))
  return tuple(out)


class _Stacked:
  """One condim group's narrowphase output, stacked over its points in
  the order of its sources, and the group's constants."""

  def __init__(self, consts: GroupConsts, parts):
    """parts: per source, a list of ContactPoints (B,) or a cluster's
    (dist (B, n), pos (B, n, 3), normal (B, n, 3))."""
    dist, pos, normal, tangent = [], [], [], []
    zero = None
    for part in parts:
      if isinstance(part, list):
        dist += [cp.dist[:, None] for cp in part]
        pos += [cp.pos[:, None] for cp in part]
        normal += [cp.normal[:, None] for cp in part]
        if zero is None:
          zero = torch.zeros_like(part[0].normal[:, None])
        tangent += [zero if cp.tangent is None else cp.tangent[:, None]
                    for cp in part]
      else:
        dist.append(part[0])
        pos.append(part[1])
        normal.append(part[2])
        tangent.append(torch.zeros_like(part[2]))
    self.pos3 = torch.cat(pos, 1)                             # (B, P, 3)
    self.normal = torch.cat(normal, 1)
    self.tangent = torch.cat(tangent, 1)
    self.dist = torch.cat(dist, 1)                            # (B, P)
    self.margin, self.solref, self.solimp = (consts.margin, consts.solref,
                                             consts.solimp)
    self.mu, self.invw = consts.mu, consts.invw
    self.b1, self.b2, self.dmask = consts.b1, consts.b2, consts.dmask
    self.bodies = consts.bodies


def _contact_groups(m: Model, d: Data):
  """Narrowphase output stacked per condim, {condim: _Stacked} (JAX also
  returns the mesh-mesh clusters' selected points: `_dyn_contacts`)."""
  groups = {}
  for consts in m.contact:
    parts = [collision.narrowphase(m, d, *src.pairs[0])
             if src.kind == 'pair'
             else CLUSTERS[src.kind][0](m, d, src.cluster)
             for src in consts.sources]
    groups[consts.condim] = _Stacked(consts, parts)
  return groups


def _dapprox(s: _Stacked, condim: int) -> torch.Tensor:
  if condim == 1:
    return s.invw
  return s.invw * 2.0 * s.mu[:, 0] ** 2 * (1.0 + s.mu[:, 0] ** 2)


def _dyn_contacts(m: Model, d: Data):
  """Each mesh-mesh cluster's `_contact_capacity` deepest candidates
  (dist - margin, the lower index first among equals), with their pairs'
  parameters and body ids gathered per sample: a list of dicts of
  (B, cap, ...) tensors (_contact_groups :575-594)."""
  out = []
  for dc in m.contact_dyn:
    dist, pos, normal, pair_idx = collision.mesh_mesh_batched(
        m, d, dc.cluster)
    cap = _contact_capacity(m, dist.shape[1])
    sel = collision._deepest(dist - dc.margin[pair_idx], cap)  # (B, cap)
    pidx = torch.gather(pair_idx, 1, sel)
    out.append({
        'pos3': collision._take(pos, sel),
        'normal': collision._take(normal, sel),
        'dist': torch.gather(dist, 1, sel), 'margin': dc.margin[pidx],
        'solref': dc.solref[pidx], 'solimp': dc.solimp[pidx],
        'invw': dc.invw[pidx], 'b1': dc.bodies[0][pidx],
        'b2': dc.bodies[1][pidx]})
  return out


def _dyn_contact_rows(m: Model, d: Data) -> Optional[Rows]:
  """Dense condim-1 normal rows of the mesh-mesh clusters' selected
  contacts, `_contact_capacity` of them a cluster (_dyn_contact_rows
  :750-790)."""
  if not m.collision_pairs or not m.contact_dyn:
    return None
  parts = []
  for g in _dyn_contacts(m, d):
    pos = g['dist'] - g['margin']
    k, b, imp = kbi(g['solref'], g['solimp'], pos)
    jp2, _ = smooth.point_jac(m, d, g['pos3'], g['b2'])
    jp1, _ = smooth.point_jac(m, d, g['pos3'], g['b1'])
    jn = torch.einsum('bpns,bps->bpn', jp2 - jp1, g['normal'])
    vel = (jn @ d.qvel[..., None])[..., 0]
    parts.append(Rows(
        jn, pos, g['margin'], -b * vel - k * imp * pos,
        imp / (1.0 - imp) / torch.clamp(g['invw'], min=1e-12), pos < 0.0,
        torch.zeros_like(pos, dtype=torch.bool)))
  return _concat_rows(parts)


def _capped_point_rows(m: Model, d: Data, s: _Stacked, condim: int,
                       cap: int) -> Rows:
  """Dense facet rows of the `cap` deepest points of a stacked condim
  group (dist - margin, the lower index first among equals), chosen per
  sample (_capped_point_rows :808-887)."""
  sel = collision._deepest(s.dist - s.margin, cap)            # (B, cap)
  pos3 = collision._take(s.pos3, sel)
  normal = collision._take(s.normal, sel)
  tan_hint = collision._take(s.tangent, sel)
  margin = s.margin[sel]
  solref, solimp = s.solref[sel], s.solimp[sel]
  mu, invw = s.mu[sel], s.invw[sel]                           # (B, cap, 3)
  pos = torch.gather(s.dist, 1, sel) - margin
  k, b, imp = kbi(solref, solimp, pos)
  if condim == 1:
    dapprox = invw
  else:
    dapprox = invw * 2.0 * mu[..., 0] ** 2 * (1.0 + mu[..., 0] ** 2)
  jp2, jr2 = smooth.point_jac(m, d, pos3, s.bodies[1][sel])
  jp1, jr1 = smooth.point_jac(m, d, pos3, s.bodies[0][sel])
  jp = jp2 - jp1
  proj = lambda jac, v: torch.einsum('bpns,bps->bpn', jac, v)  # noqa: E731
  jn = proj(jp, normal)
  t1, t2 = collision._make_frames(normal, tan_hint)
  if condim == 1:
    jmat = jn
  else:
    mus = mu[..., 0:1]
    jt1, jt2 = proj(jp, t1), proj(jp, t2)
    facets = [jn + mus * jt1, jn - mus * jt1, jn + mus * jt2, jn - mus * jt2]
    if condim >= 4:
      jr = jr2 - jr1
      mut = mu[..., 1:2]
      jrn = proj(jr, normal)
      facets += [jn + mut * jrn, jn - mut * jrn]
      if condim == 6:
        mur = mu[..., 2:3]
        jrt1, jrt2 = proj(jr, t1), proj(jr, t2)
        facets += [jn + mur * jrt1, jn - mur * jrt1, jn + mur * jrt2,
                   jn - mur * jrt2]
    jmat = torch.cat(facets, 1)                       # (B, nrep*cap, nv)
  nrep = jmat.shape[1] // cap
  posr = pos.repeat(1, nrep)
  vel = (jmat @ d.qvel[..., None])[..., 0]
  return Rows(
      jmat, posr, margin.repeat(1, nrep),
      -b.repeat(1, nrep) * vel - (k * imp).repeat(1, nrep) * posr,
      (imp / (1.0 - imp) / torch.clamp(dapprox, min=1e-12)).repeat(1, nrep),
      posr < 0.0, torch.zeros_like(posr, dtype=torch.bool))


def contact_blocks(m: Model, d: Data, condims=(1, 3, 4, 6)):
  """Contact constraint rows as dense facet rows, one ContactBlock per
  condim group: the dense twin of contact_point_groups, for tests and the
  plain path. A condim-c contact contributes 2(c-1) one-sided facet rows
  J = Jn +- mu_i J_i (condim 1: the normal row), with diagApprox
  invweight * 2 mu1^2 (1 + mu1^2) (condim 1: invweight)."""
  if not m.collision_pairs:
    return []
  groups = _contact_groups(m, d)
  a_body = m.idx.a_body
  rootid = m.idx.body_rootid
  blocks = []
  for condim, s in groups.items():
    if condim not in condims:
      continue
    pos = s.dist - s.margin
    k, b, imp = kbi(s.solref, s.solimp, pos)
    dapprox = _dapprox(s, condim)

    def batch_jac(bodies):
      off = s.pos3 - d.subtree_com[:, rootid[bodies]]          # (B, P, 3)
      jp = (d.cdof[:, None, :, 3:]
            + tm.cross(d.cdof[:, None, :, :3], off[:, :, None, :]))
      mask = a_body[bodies][None, :, :, None]
      return jp * mask, d.cdof[:, None, :, :3] * mask         # (B, P, nv, 3)

    jp1, jr1 = batch_jac(s.b1)
    jp2, jr2 = batch_jac(s.b2)
    jp = jp2 - jp1
    proj = lambda jac, v: torch.einsum('bpns,bps->bpn', jac, v)  # noqa: E731
    jn = proj(jp, s.normal)
    t1, t2 = collision._make_frames(s.normal, s.tangent)
    if condim == 1:
      jmat = jn
    else:
      mus = s.mu[:, 0:1]
      jt1, jt2 = proj(jp, t1), proj(jp, t2)
      facets = [jn + mus * jt1, jn - mus * jt1, jn + mus * jt2,
                jn - mus * jt2]
      if condim >= 4:
        jr = jr2 - jr1
        mut = s.mu[:, 1:2]
        jrn = proj(jr, s.normal)
        facets += [jn + mut * jrn, jn - mut * jrn]
        if condim == 6:
          mur = s.mu[:, 2:3]
          jrt1, jrt2 = proj(jr, t1), proj(jr, t2)
          facets += [jn + mur * jrt1, jn - mur * jrt1, jn + mur * jrt2,
                     jn - mur * jrt2]
      jmat = torch.cat(facets, 1)                              # (B, nrep*P, nv)
    nrep = jmat.shape[1] // pos.shape[1]
    posr = pos.repeat(1, nrep)
    vel = (jmat @ d.qvel[..., None])[..., 0]
    rows = Rows(
        jmat, posr, s.margin.repeat(nrep).expand_as(posr),
        -b.repeat(nrep) * vel - (k * imp).repeat(1, nrep) * posr,
        (imp / (1.0 - imp) / torch.clamp(dapprox, min=1e-12)).repeat(1, nrep),
        posr < 0.0, torch.zeros_like(posr, dtype=torch.bool))
    blocks.append(ContactBlock(
        rows=rows, condim=condim, nrep=nrep, pos=s.pos3,
        frame=torch.stack([s.normal, t1, t2], 2), mu=s.mu, b1=s.b1,
        b2=s.b2))
  return blocks


class ContactForces(NamedTuple):
  """Decoded contact wrenches a point (mj_contactForce). force6 columns:
  (normal, t1, t2) forces, then (normal, t1, t2) torques, in the contact
  frame, acting on body b2 (the reaction on b1); the normal points from
  geom1 to geom2."""
  pos: torch.Tensor      # (B, P, 3)
  frame: torch.Tensor    # (B, P, 3, 3) rows (normal, t1, t2)
  force6: torch.Tensor   # (B, P, 6)
  b1: np.ndarray         # (P,) body ids
  b2: np.ndarray


def contact_forces(m: Model, d: Data) -> Optional[ContactForces]:
  """Contact wrenches from the converged qacc, over contact_blocks' dense
  facet rows in their stacking order: an active row's force is
  f = -D jar (jar = J qacc - aref < 0), and a pyramid's facet forces fold
  back to fn = sum of facets, f_i = mu_i (f_i+ - f_i-) (the inverse of
  the facet expansion). For the force, torque and touch sensors; None
  without contacts."""
  if m.collision_pairs and m.opt.cone == 1:
    raise NotImplementedError(
        'contact forces over elliptic friction cones are not ported yet '
        '(ROADMAP A8)')
  blocks = contact_blocks(m, d)
  if not blocks:
    return None
  pos_l, frame_l, f6_l, b1_l, b2_l = [], [], [], [], []
  for blk in blocks:
    rows = blk.rows
    p = blk.pos.shape[1]
    jar = torch.einsum('brn,bn->br', rows.j, d.qacc) - rows.aref
    dvec = torch.where(rows.active, rows.d, torch.zeros_like(rows.d))
    f = torch.where(jar < 0, -dvec * jar, torch.zeros_like(jar))
    f = f.reshape(f.shape[0], blk.nrep, p)
    zero = torch.zeros_like(f[:, 0])
    mu = blk.mu
    if blk.condim == 1:
      parts = [f[:, 0], zero, zero, zero, zero, zero]
    else:
      parts = [torch.sum(f, 1), mu[:, 0] * (f[:, 0] - f[:, 1]),
               mu[:, 0] * (f[:, 2] - f[:, 3]),
               mu[:, 1] * (f[:, 4] - f[:, 5]) if blk.condim >= 4 else zero]
      parts += ([mu[:, 2] * (f[:, 6] - f[:, 7]),
                 mu[:, 2] * (f[:, 8] - f[:, 9])] if blk.condim == 6
                else [zero, zero])
    pos_l.append(blk.pos)
    frame_l.append(blk.frame)
    f6_l.append(torch.stack(parts, -1))
    b1_l.append(blk.b1)
    b2_l.append(blk.b2)
  return ContactForces(
      pos=torch.cat(pos_l, 1), frame=torch.cat(frame_l, 1),
      force6=torch.cat(f6_l, 1), b1=np.concatenate(b1_l),
      b2=np.concatenate(b2_l))


def dof_anchored_axes(m: Model, d: Data) -> torch.Tensor:
  """cdofc (B, nv, 6): each dof's motion axis re-anchored at the world
  origin, [ang, lin - cross(ang, subtree_com[root_of_dof])]."""
  ang = d.cdof[..., :3]
  lin = d.cdof[..., 3:] - tm.cross(ang, d.subtree_com[:, m.idx.dof_rootid])
  return torch.cat([ang, lin], -1)


def contact_point_groups(m: Model, d: Data):
  """Pyramidal contacts in factored point-direction form, one PointRows
  per condim group (the dense twin is contact_blocks), and the dense
  facet rows of the groups over m.contact_point_cap (_capped_point_rows),
  or None. Direction velocities for aref come from the masked projection
  cw[p] = sum_n cdofc[n] dmask[p, n] qvel[n], so nothing here is
  (P, ndirs, nv) wide."""
  if not m.collision_pairs:
    return [], None
  groups = _contact_groups(m, d)
  cdofc = dof_anchored_axes(m, d)
  out, capped = [], []
  for condim, s in groups.items():
    cap = m.contact_point_cap
    if cap and s.dist.shape[1] > cap:
      capped.append(_capped_point_rows(m, d, s, condim, cap))
      continue
    pos = s.dist - s.margin
    k, b, imp = kbi(s.solref, s.solimp, pos)
    dvec = imp / (1.0 - imp) / torch.clamp(_dapprox(s, condim), min=1e-12)
    dvec = torch.where(pos < 0.0, dvec, torch.zeros_like(dvec))

    t1, t2 = collision._make_frames(s.normal, s.tangent)
    if condim == 1:
      dirs_t = s.normal[:, :, None, :]                         # (B, P, 1, 3)
    else:
      dirs_t = torch.stack([s.normal, t1, t2], 2)              # (B, P, 3, 3)
    gfac = torch.cat([tm.cross(s.pos3[:, :, None, :], dirs_t), dirs_t], -1)
    if condim >= 4:
      dirs_r = (s.normal[:, :, None, :] if condim == 4
                else torch.stack([s.normal, t1, t2], 2))
      gfac = torch.cat(
          [gfac, torch.cat([dirs_r, torch.zeros_like(dirs_r)], -1)], 2)

    dmask = s.dmask.to(d.qpos.dtype)
    cw = torch.einsum('bnj,pn->bpj', cdofc * d.qvel[..., None], dmask)
    vd = torch.einsum('bpdj,bpj->bpd', gfac, cw)               # (B, P, ndirs)
    base = -b * vd[..., 0] - k * imp * pos
    aref = torch.stack(
        [base - b * sgn * s.mu[:, col] * vd[..., di] if sgn else base
         for (di, col, sgn) in newton_op.PYRAMID_FACETS[condim]], 1)
    out.append(PointRows(
        g=gfac, cdofc=cdofc, dmask=s.dmask, aref=aref, dvec=dvec,
        mu=s.mu.T.expand(d.qpos.shape[0], 3, -1), condim=condim))
  return out, _concat_rows(capped)


def point_rows_jd(pr: PointRows) -> torch.Tensor:
  """The (B, P, ndirs, nv) direction Jacobians of a factored group (tests
  and the plain path)."""
  return newton_op.materialize_jd(pr.g, pr.cdofc, pr.dmask)


def expand_point_rows(pr: PointRows):
  """Facet-expand a PointRows group to dense rows in contact_blocks'
  facet-major order: (j (B, nrep*P, nv), aref (B, nrep*P),
  dvec (B, nrep*P))."""
  return newton_op.expand_group(point_rows_jd(pr), pr.aref, pr.dvec, pr.mu,
                                pr.condim)


def _concat_rows(blocks) -> Optional[Rows]:
  blocks = [b for b in blocks if b is not None]
  if not blocks:
    return None
  return Rows(*(torch.cat(parts, 1) for parts in zip(*blocks)))


def make_rows_split(m: Model, d: Data):
  """(dense Rows | None, ScalarRows | None, list[PointRows],
  FrictionRows | None): the dense rows are the equality rows, the tendon
  limits' rows, the mesh-mesh clusters' selected rows, then the capped
  groups' facet rows; joint limits and frictionloss rows one-hot; the
  other pyramidal contacts in point-direction form (JAX also returns the
  elliptic-cone block, which the port refuses)."""
  if m.collision_pairs and m.opt.cone == 1:
    raise NotImplementedError(
        'elliptic friction cones are not ported yet (ROADMAP A8)')
  dyn = _dyn_contact_rows(m, d)
  points, capped = contact_point_groups(m, d)
  return (_concat_rows([_equality_rows(m, d), _tendon_limit_rows(m, d),
                        dyn, capped]), _limit_rows_scalar(m, d), points,
          _friction_rows(m, d))


def newton_operands(m: Model, d: Data, rows: Optional[Rows],
                    scalar: Optional[ScalarRows],
                    points: List[PointRows] = (),
                    friction: Optional[FrictionRows] = None):
  """The operands solve hands ops/newton.newton: (the ten dense and
  one-hot operands, the group operands, condims, dmasks, the frictionloss
  operands (aref, d, loss, dof) or None)."""
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
  group_args = [points[0].cdofc.contiguous()] if points else []
  for p in points:
    group_args += [p.g.contiguous(), p.aref.contiguous(),
                   p.dvec.contiguous(), p.mu.contiguous()]
  fric = (None if friction is None else
          (friction.aref, friction.d, friction.loss, friction.dof))
  return ((d.qM, d.qacc, j_mat, aref_d, dvec_d, eqf, aref_s, dvec_s, dof,
           sign), tuple(group_args), tuple(p.condim for p in points),
          tuple(p.dmask for p in points), fric)


def solve(m: Model, d: Data, rows: Optional[Rows],
          scalar: Optional[ScalarRows] = None,
          points: List[PointRows] = (),
          friction: Optional[FrictionRows] = None,
          max_iterations: Optional[int] = None,
          tolerance: Optional[float] = None) -> Data:
  """Primal Newton solve for qacc given constraint rows; d.qacc holds
  qacc_smooth on entry. Returns Data with the constrained qacc and
  qfrc_constraint."""
  if max_iterations is None:
    max_iterations = m.opt.iterations
  if tolerance is None:
    tolerance = 1e-5 if d.qpos.dtype == torch.float32 else 1e-8
  if rows is None and scalar is None and not points and friction is None:
    return d.replace(qfrc_constraint=torch.zeros_like(d.qvel))

  args, group_args, condims, dmasks, fric = newton_operands(
      m, d, rows, scalar, points, friction)
  out = newton_op.newton(
      *args, *group_args, cap=int(max_iterations), tol=float(tolerance),
      condims=condims, dmasks=dmasks, friction=fric)
  qacc, jar_d, jar_s = out[:3]
  jar_f = out[3] if fric is not None else None
  jar_pts = out[3 + (fric is not None):]
  _, _, j_mat, _, dvec_d, _, _, dvec_s, dof, sign = args

  qfrc_constraint = torch.zeros_like(d.qvel)
  if rows is not None:
    act = torch.logical_or(jar_d < 0, rows.equality)
    f_d = torch.where(act, -dvec_d * jar_d, torch.zeros_like(jar_d))
    qfrc_constraint = qfrc_constraint + (f_d[:, None, :] @ j_mat)[:, 0]
  if scalar is not None:
    f_s = torch.where(jar_s < 0, -dvec_s * jar_s, torch.zeros_like(jar_s))
    qfrc_constraint = qfrc_constraint.index_add(1, dof, sign * f_s)
  if friction is not None:
    f_f = -torch.clamp(friction.d * jar_f, -friction.loss, friction.loss)
    qfrc_constraint = qfrc_constraint.index_add(1, friction.dof, f_f)
  for p, jar_g in zip(points, jar_pts):
    # facet force f = max(0, -D jar), folded back through the facet table
    # into per-direction coefficients (the transpose of the expansion),
    # then through the rank-6 factors:
    # J^T f = sum_p dmask[p] * (cdofc . gw[p]), gw[p] = sum_d G[p, d] coef[p, d]
    f_g = torch.where(jar_g < 0, -p.dvec[:, None, :] * jar_g,
                      torch.zeros_like(jar_g))                 # (B, nrep, P)
    coef = [0.0] * p.g.shape[2]
    for fi, (di, col, sgn) in enumerate(newton_op.PYRAMID_FACETS[p.condim]):
      coef[0] = coef[0] + f_g[:, fi]
      if sgn:
        coef[di] = coef[di] + sgn * p.mu[:, col] * f_g[:, fi]
    gw = torch.einsum('bpdj,bpd->bpj', p.g, torch.stack(coef, -1))
    qfrc_constraint = qfrc_constraint + torch.einsum(
        'bpj,bnj,pn->bn', gw, p.cdofc, p.dmask.to(gw.dtype))
  return d.replace(qacc=qacc, qfrc_constraint=qfrc_constraint)
