"""Soft-constraint rows and the primal Newton solve, batch-first.

Port of mujoco_mpc_tpu/physics/constraint.py: impedance :77, kbi :97,
ScalarRows :37, Rows :66, _limit_rows_scalar :115, the pyramidal contacts
(ContactBlock :452, PointRows :465, _pair_param_arrays :496,
_contact_groups :516 with the batched hull clusters, _Stacked :631,
contact_blocks :648, dof_anchored_axes :793, contact_point_groups :890,
point_rows_jd :970, expand_point_rows :977), make_rows_split :1213 and
solve :1240. The solve itself is ops/newton.py (the fused Newton kernel
B2 on CUDA, its plain PyTorch version on the CPU); contacts reach it in
the factored point form, so the facet rows are built inside the kernel.

What JAX computes from model constants at trace time (the pair
parameters, body ids and ancestor-mask differences of each condim group)
the port computes once per model, in `contact_table`, which
physics/model.py from_arrays stores as Model.contact.

Not ported yet, and refused where a model needs them: equality rows and
tendon limits (ROADMAP A8), contact groups over contact_point_cap
(_capped_point_rows, A6), the mesh-mesh clusters and their dynamic rows
(A7),
joint frictionloss rows and elliptic cones (A8).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mujoco_mpc_tpu_torch.ops import newton as newton_op
from mujoco_mpc_tpu_torch.physics import collision
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
  mm, sm, pm, bm, cm, clustered = collision.contact_clusters(m)
  if mm:
    raise NotImplementedError(
        'mesh-mesh contacts are not ported yet (ROADMAP A7)')
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
        dmask=(a_body[b2] - a_body[b1]).to(torch.float32).contiguous()))
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


def _contact_groups(m: Model, d: Data):
  """Narrowphase output stacked per condim, {condim: _Stacked} (JAX also
  returns the dynamically selected mesh-mesh rows, which the port
  refuses)."""
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


def dof_anchored_axes(m: Model, d: Data) -> torch.Tensor:
  """cdofc (B, nv, 6): each dof's motion axis re-anchored at the world
  origin, [ang, lin - cross(ang, subtree_com[root_of_dof])]."""
  ang = d.cdof[..., :3]
  lin = d.cdof[..., 3:] - tm.cross(ang, d.subtree_com[:, m.idx.dof_rootid])
  return torch.cat([ang, lin], -1)


def contact_point_groups(m: Model, d: Data):
  """Pyramidal contacts in factored point-direction form, one PointRows
  per condim group (the dense twin is contact_blocks), and None for the
  capped rows. Direction velocities for aref come from the masked
  projection cw[p] = sum_n cdofc[n] dmask[p, n] qvel[n], so nothing here
  is (P, ndirs, nv) wide."""
  if not m.collision_pairs:
    return [], None
  groups = _contact_groups(m, d)
  cdofc = dof_anchored_axes(m, d)
  out = []
  for condim, s in groups.items():
    cap = m.contact_point_cap
    if cap and s.dist.shape[1] > cap:
      raise NotImplementedError(
          f'a condim-{condim} group of {s.dist.shape[1]} points is over '
          f'contact_point_cap {cap}; capped point rows are not ported yet '
          '(ROADMAP A6)')
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
  return out, None


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


def make_rows_split(m: Model, d: Data):
  """(dense Rows | None, ScalarRows | None, list[PointRows]): joint
  limits one-hot, pyramidal contacts in point-direction form (JAX also
  returns cone and frictionloss blocks; the port refuses models that have
  them)."""
  if m.neq:
    raise NotImplementedError('equality rows are not ported yet (ROADMAP A8)')
  if any(m.tendon_limited):
    raise NotImplementedError('tendon limits are not ported yet (ROADMAP A8)')
  if m.friction_dof:
    raise NotImplementedError(
        'frictionloss rows are not ported yet (ROADMAP A8)')
  if m.collision_pairs and m.opt.cone == 1:
    raise NotImplementedError(
        'elliptic friction cones are not ported yet (ROADMAP A8)')
  points, _ = contact_point_groups(m, d)
  return None, _limit_rows_scalar(m, d), points


def newton_operands(m: Model, d: Data, rows: Optional[Rows],
                    scalar: Optional[ScalarRows],
                    points: List[PointRows] = ()):
  """The operands solve hands ops/newton.newton: (the ten dense and
  one-hot operands, the group operands, condims, dmasks)."""
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
  return ((d.qM, d.qacc, j_mat, aref_d, dvec_d, eqf, aref_s, dvec_s, dof,
           sign), tuple(group_args), tuple(p.condim for p in points),
          tuple(p.dmask for p in points))


def solve(m: Model, d: Data, rows: Optional[Rows],
          scalar: Optional[ScalarRows] = None,
          points: List[PointRows] = (),
          max_iterations: Optional[int] = None,
          tolerance: Optional[float] = None) -> Data:
  """Primal Newton solve for qacc given constraint rows; d.qacc holds
  qacc_smooth on entry. Returns Data with the constrained qacc and
  qfrc_constraint."""
  if max_iterations is None:
    max_iterations = m.opt.iterations
  if tolerance is None:
    tolerance = 1e-5 if d.qpos.dtype == torch.float32 else 1e-8
  if rows is None and scalar is None and not points:
    return d.replace(qfrc_constraint=torch.zeros_like(d.qvel))

  args, group_args, condims, dmasks = newton_operands(m, d, rows, scalar,
                                                      points)
  qacc, jar_d, jar_s, *jar_pts = newton_op.newton(
      *args, *group_args, cap=int(max_iterations), tol=float(tolerance),
      condims=condims, dmasks=dmasks)
  _, _, j_mat, _, dvec_d, _, _, dvec_s, dof, sign = args

  qfrc_constraint = torch.zeros_like(d.qvel)
  if rows is not None:
    act = torch.logical_or(jar_d < 0, rows.equality)
    f_d = torch.where(act, -dvec_d * jar_d, torch.zeros_like(jar_d))
    qfrc_constraint = qfrc_constraint + (f_d[:, None, :] @ j_mat)[:, 0]
  if scalar is not None:
    f_s = torch.where(jar_s < 0, -dvec_s * jar_s, torch.zeros_like(jar_s))
    qfrc_constraint = qfrc_constraint.index_add(1, dof, sign * f_s)
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
