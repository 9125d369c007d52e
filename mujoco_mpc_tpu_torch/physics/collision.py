"""Collision narrowphase for primitive geoms, batch-first.

Port of mujoco_mpc_tpu/physics/collision.py: ContactPoint :32,
_make_frame :44, _make_frames :59, _plane_sphere :81, _plane_capsule :87,
_plane_box :103, narrowphase :604 (plane against sphere, capsule and box),
contact_clusters :717, PairParams :1005 and pair_params :1015. As in JAX,
each static geom pair emits a fixed number of candidate points (inactive
ones are masked by distance later), so every shape is static; here each
field carries a leading batch dimension B.

Not ported yet, and refused where reached: every other pair type (sphere,
capsule and box pairs, box-box, cylinder and ellipsoid: ROADMAP A6) and
the mesh hulls and height fields with their batched clusters (A7).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from mujoco_mpc_tpu_torch.physics.model import Data, GeomType, Model
from mujoco_mpc_tpu_torch.utils import math as tm


class ContactPoint(NamedTuple):
  dist: torch.Tensor     # (B,)
  pos: torch.Tensor      # (B, 3)
  normal: torch.Tensor   # (B, 3) from geom1 towards geom2
  # first-tangent hint (B, 3), unit and normal-orthogonal: plane-capsule
  # aligns t1 with the capsule axis (MuJoCo mjc_PlaneCapsule); None ->
  # mju_makeFrame tangents
  tangent: Optional[torch.Tensor] = None


def _make_frames(n: torch.Tensor, hint: Optional[torch.Tensor] = None):
  """Tangent bases (t1, t2) for normals (..., 3), mju_makeFrame semantics.

  `hint` (..., 3) overrides t1 where it is nonzero (zero rows: no
  override, see ContactPoint.tangent)."""
  an = torch.abs(n)
  use_x = (an[..., 0] <= an[..., 1]) & (an[..., 0] <= an[..., 2])
  use_y = ~use_x & (an[..., 1] <= an[..., 2])
  e = torch.stack([use_x, use_y, ~use_x & ~use_y], -1).to(n.dtype)
  t1 = tm.normalize(tm.cross(n, e))
  if hint is not None:
    use = torch.sum(hint * hint, -1, keepdim=True) > 0.25
    t1 = torch.where(use, hint, t1)
  return t1, tm.cross(n, t1)


def _make_frame(n: torch.Tensor):
  """Tangent basis matching mju_makeFrame, for normals (..., 3)."""
  return _make_frames(n)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  return torch.sum(a * b, -1)


def _plane_sphere(pp, pn, c, r):
  dist = _dot(pn, c - pp) - r
  pos = c - pn * (r + 0.5 * dist)[..., None]
  return [ContactPoint(dist, pos, pn)]


def _plane_capsule(pp, pn, c, axis, half, r):
  # t1 along the capsule axis projected onto the plane; makeFrame's t1
  # where the capsule stands normal to the plane
  t = axis - pn * _dot(pn, axis)[..., None]
  tn = torch.linalg.vector_norm(t, dim=-1, keepdim=True)
  t1_mf, _ = _make_frame(pn)
  t1 = torch.where(tn > 1e-8, t / torch.clamp(tn, min=1e-12), t1_mf)
  pts = []
  for s in (-1.0, 1.0):
    (p,) = _plane_sphere(pp, pn, c + (s * half) * axis, r)
    pts.append(p._replace(tangent=t1))
  return pts


def _plane_box(pp, pn, c, mat, size, signs):
  """The 8 box corners as candidates; `signs` (8, 3) in JAX's corner
  order (x outermost, z innermost)."""
  corners = c[:, None, :] + (signs * size) @ mat.transpose(-1, -2)  # (B, 8, 3)
  dist = _dot(pn[:, None, :], corners - pp[:, None, :])             # (B, 8)
  pos = corners - (0.5 * dist)[..., None] * pn[:, None, :]
  return [ContactPoint(dist[:, k], pos[:, k], pn) for k in range(8)]


def _unported(t1: int, t2: int) -> NotImplementedError:
  mesh = {int(GeomType.MESH), int(GeomType.HFIELD)}
  item = 'A7' if t1 in mesh or t2 in mesh else 'A6'
  return NotImplementedError(
      f'{GeomType(t1).name.lower()}-{GeomType(t2).name.lower()} contacts '
      f'are not ported yet (ROADMAP {item})')


def narrowphase(m: Model, d: Data, g1: int, g2: int) -> List[ContactPoint]:
  """Candidate contacts for one geom pair; normal from g1 towards g2."""
  t1, t2 = m.geom_type[g1], m.geom_type[g2]
  if t1 != GeomType.PLANE:
    raise _unported(t1, t2)
  p1, p2 = d.geom_xpos[:, g1], d.geom_xpos[:, g2]
  m2 = d.geom_xmat[:, g2]
  s2 = m.geom_size[g2]
  pn = d.geom_xmat[:, g1, :, 2]
  if t2 == GeomType.SPHERE:
    return _plane_sphere(p1, pn, p2, s2[0])
  if t2 == GeomType.CAPSULE:
    return _plane_capsule(p1, pn, p2, m2[..., 2], s2[1], s2[0])
  if t2 == GeomType.BOX:
    return _plane_box(p1, pn, p2, m2, s2, m.idx.box_signs)
  raise _unported(t1, t2)


def contact_clusters(m: Model):
  """Static pair clusters for the batched hull narrowphase (mm, sm, pm,
  bm, cm, clustered). Clusters exist only for mesh hulls, which the port
  refuses (ROADMAP A7), so for every model it takes this returns empty
  lists and every pair stays on the unrolled per-pair path."""
  for pair in m.collision_pairs:
    for g in pair:
      if m.geom_type[g] == GeomType.MESH:
        raise NotImplementedError(
            'mesh hull contacts are not ported yet (ROADMAP A7)')
  return [], [], [], [], [], set()


class PairParams(NamedTuple):
  """Combined contact parameters for a pair (mj_contactParam rules)."""
  friction: torch.Tensor       # (3,) sliding, torsional, rolling
  solref: torch.Tensor         # (2,)
  solimp: torch.Tensor         # (5,)
  includemargin: torch.Tensor  # margin - gap
  condim: int
  invweight: torch.Tensor      # translational invweight sum


def pair_params(m: Model, g1: int, g2: int) -> PairParams:
  p1, p2 = m.geom_priority[g1], m.geom_priority[g2]
  b1, b2 = m.geom_bodyid[g1], m.geom_bodyid[g2]
  invweight = m.body_invweight0[b1, 0] + m.body_invweight0[b2, 0]
  margin = torch.maximum(m.geom_margin[g1], m.geom_margin[g2])
  gap = torch.maximum(m.geom_gap[g1], m.geom_gap[g2])
  if p1 != p2:
    g = g1 if p1 > p2 else g2
    return PairParams(
        friction=m.geom_friction[g], solref=m.geom_solref[g],
        solimp=m.geom_solimp[g], includemargin=margin - gap,
        condim=m.geom_condim[g], invweight=invweight)
  mix1, mix2 = m.geom_solmix[g1], m.geom_solmix[g2]
  wsum = torch.clamp(mix1 + mix2, min=1e-12)
  w1 = torch.where((mix1 < 1e-12) & (mix2 < 1e-12),
                   torch.full_like(mix1, 0.5), mix1 / wsum)
  w2 = 1.0 - w1
  solref = torch.where(
      (m.geom_solref[g1, 0] > 0) & (m.geom_solref[g2, 0] > 0),
      w1 * m.geom_solref[g1] + w2 * m.geom_solref[g2],
      torch.minimum(m.geom_solref[g1], m.geom_solref[g2]))
  solimp = w1 * m.geom_solimp[g1] + w2 * m.geom_solimp[g2]
  friction = torch.maximum(m.geom_friction[g1], m.geom_friction[g2])
  return PairParams(
      friction=friction, solref=solref, solimp=solimp,
      includemargin=margin - gap,
      condim=max(m.geom_condim[g1], m.geom_condim[g2]),
      invweight=invweight)


def points_per_pair(m: Model, g1: int, g2: int) -> int:
  """The fixed candidate count narrowphase emits for a pair."""
  counts = {int(GeomType.SPHERE): 1, int(GeomType.CAPSULE): 2,
            int(GeomType.BOX): 8}
  if m.geom_type[g1] != GeomType.PLANE or m.geom_type[g2] not in counts:
    raise _unported(m.geom_type[g1], m.geom_type[g2])
  return counts[m.geom_type[g2]]
