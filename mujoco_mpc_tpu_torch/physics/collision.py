"""Collision narrowphase for primitive geoms and convex hulls, batch-first.

Port of mujoco_mpc_tpu/physics/collision.py: ContactPoint :32,
_make_frame :44, _make_frames :59, _plane_sphere :81, _plane_capsule :87,
_plane_box :103, _sphere_sphere :116, the convex-hull colliders
(_points_vs_halfspaces :395, _hull_world :416, _plane_mesh :426,
_sphere_mesh :439, _box_mesh :452), narrowphase :604 (plane against
sphere, capsule, box and mesh; sphere against sphere and mesh; box and
capsule against mesh), the batched hull clusters (_hull_sig :712,
contact_clusters :717, _hulls_local :762, plane_mesh_batched :783,
box_mesh_batched :809, capsule_mesh_batched :949, sphere_mesh_batched
:983), PairParams :1005 and pair_params :1015. As in JAX, each static geom
pair emits a fixed number of candidate points (inactive ones are masked
by distance later), so every shape is static; here each field carries a
leading batch dimension B.

Two selection rules are mirrored exactly, not unified: the unrolled
colliders take the normal of the first face at the maximum (argmax), the
batched clusters average the normals of every face at the maximum. Every
k-deepest choice is `_deepest`, a stable sort, so that among equal depths
the lower index comes first, as lax.top_k gives it (a hull resting on a
face has exact ties). The hull tables are float32 values; the small
contractions over them go through matmul, which runs in full float32
unless the caller enables TF32.

Not ported yet, and refused where reached: the other primitive pairs
(sphere, capsule and box pairs, box-box, cylinder and ellipsoid: ROADMAP
A6) and the mesh-mesh hulls and height fields (A7).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

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


def _sphere_sphere(c1, r1, c2, r2):
  dv = c2 - c1
  ln = torch.linalg.vector_norm(dv, dim=-1)
  n = dv / torch.clamp(ln, min=1e-12)[..., None]
  dist = ln - r1 - r2
  pos = c1 + n * (r1 + 0.5 * dist)[..., None]
  return [ContactPoint(dist, pos, n)]


def _deepest(depth: torch.Tensor, k: int) -> torch.Tensor:
  """Indices (..., k) of the k smallest entries of depth (..., n), the
  lower index first among equals: lax.top_k(-depth, k)'s order."""
  return torch.sort(depth, dim=-1, stable=True).indices[..., :k]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
  """x (..., n, c) at the indices idx (..., k) of its axis -2."""
  idx = idx[..., None].expand(idx.shape + x.shape[-1:])
  return torch.gather(x.expand(idx.shape[:-2] + x.shape[-2:]), -2, idx)


def _points_vs_halfspaces(world_pts, face_n, face_b, k=4):
  """Depth of points (B, P, 3) against halfspaces (B, F, 3), (B, F)
  (n.x + b <= 0 inside): the k deepest points, each with the normal of
  the first face at its maximum."""
  phi = torch.einsum('bpe,bfe->bpf', world_pts, face_n) + face_b[:, None]
  fstar = torch.argmax(phi, dim=2)                            # (B, P)
  depth = torch.gather(phi, 2, fstar[..., None])[..., 0]
  normals = _take(face_n, fstar)                              # (B, P, 3)
  idx = _deepest(depth, min(k, world_pts.shape[1]))
  dist = torch.gather(depth, 1, idx)
  n = _take(normals, idx)
  pos = _take(world_pts, idx) - 0.5 * dist[..., None] * n
  return [ContactPoint(dist[:, i], pos[:, i], n[:, i])
          for i in range(idx.shape[1])]


def _hull_world(m: Model, d: Data, g: int):
  """Hull g (verts, face normals, face offsets) in the world frame:
  (B, V, 3), (B, F, 3), (B, F)."""
  verts_l, n_l, b_l = m.geom_mesh[g]
  c, mat = d.geom_xpos[:, g], d.geom_xmat[:, g]
  verts_w = c[:, None] + torch.einsum('ve,bde->bvd', verts_l, mat)
  n_w = torch.einsum('fe,bde->bfd', n_l, mat)
  return verts_w, n_w, b_l - torch.einsum('bfd,bd->bf', n_w, c)


def _plane_mesh(m: Model, d: Data, pp, pn, g2, k=4):
  """Plane vs hull: the k deepest hull vertices below the plane."""
  verts_w, _, _ = _hull_world(m, d, g2)
  dist = torch.einsum('bvd,bd->bv', verts_w - pp[:, None], pn)
  idx = _deepest(dist, min(k, verts_w.shape[1]))
  dsel = torch.gather(dist, 1, idx)
  pos = _take(verts_w, idx) - 0.5 * dsel[..., None] * pn[:, None]
  return [ContactPoint(dsel[:, i], pos[:, i], pn)
          for i in range(idx.shape[1])]


def _sphere_mesh(m: Model, d: Data, c, r, g2):
  """Sphere vs hull: the largest halfspace signed distance (exact in the
  face regions) gives depth and normal, the first face at the maximum."""
  _, n_w, b_w = _hull_world(m, d, g2)
  phi = torch.einsum('bfd,bd->bf', n_w, c) + b_w
  f = torch.argmax(phi, dim=1)
  n = _take(n_w, f[:, None])[:, 0]                            # hull -> sphere
  dist = torch.gather(phi, 1, f[:, None])[:, 0] - r
  pos = c - n * (r + 0.5 * dist)[:, None]
  return [ContactPoint(dist, pos, -n)]


def _box_mesh(m: Model, d: Data, g1, g2, signs):
  """Box vs hull: the 4 deepest box corners in the hull, then the 4
  deepest hull vertices in the box; `signs` (8, 3) in JAX's corner order
  (x outermost, z innermost)."""
  p1, m1, s1 = d.geom_xpos[:, g1], d.geom_xmat[:, g1], m.geom_size[g1]
  verts_w, n_w, b_w = _hull_world(m, d, g2)
  corners_w = p1[:, None] + (signs * s1) @ m1.transpose(-1, -2)
  # the hull normal points hull -> corner; orient g1 -> g2
  pts = [ContactPoint(c.dist, c.pos, -c.normal)
         for c in _points_vs_halfspaces(corners_w, n_w, b_w)]
  m1t = m1.transpose(-1, -2)                                  # rows: axes
  centre = (m1t @ p1[..., None])[..., 0]
  box_n = torch.cat([m1t, -m1t], 1)                           # (B, 6, 3)
  box_b = torch.cat([-centre - s1, centre - s1], 1)
  return pts + _points_vs_halfspaces(verts_w, box_n, box_b)


def _unported(t1: int, t2: int) -> NotImplementedError:
  mesh = {int(GeomType.MESH), int(GeomType.HFIELD)}
  item = 'A7' if t1 in mesh or t2 in mesh else 'A6'
  return NotImplementedError(
      f'{GeomType(t1).name.lower()}-{GeomType(t2).name.lower()} contacts '
      f'are not ported yet (ROADMAP {item})')


def narrowphase(m: Model, d: Data, g1: int, g2: int) -> List[ContactPoint]:
  """Candidate contacts for one geom pair; normal from g1 towards g2."""
  t1, t2 = m.geom_type[g1], m.geom_type[g2]
  p1, p2 = d.geom_xpos[:, g1], d.geom_xpos[:, g2]
  m1, m2 = d.geom_xmat[:, g1], d.geom_xmat[:, g2]
  s1, s2 = m.geom_size[g1], m.geom_size[g2]
  if t1 == GeomType.PLANE:
    pn = m1[..., 2]
    if t2 == GeomType.SPHERE:
      return _plane_sphere(p1, pn, p2, s2[0])
    if t2 == GeomType.CAPSULE:
      return _plane_capsule(p1, pn, p2, m2[..., 2], s2[1], s2[0])
    if t2 == GeomType.BOX:
      return _plane_box(p1, pn, p2, m2, s2, m.idx.box_signs)
    if t2 == GeomType.MESH:
      return _plane_mesh(m, d, p1, pn, g2)
  elif t1 == GeomType.SPHERE:
    if t2 == GeomType.SPHERE:
      return _sphere_sphere(p1, s1[0], p2, s2[0])
    if t2 == GeomType.MESH:
      return _sphere_mesh(m, d, p1, s1[0], g2)
  elif t1 == GeomType.BOX and t2 == GeomType.MESH:
    return _box_mesh(m, d, g1, g2, m.idx.box_signs)
  elif t1 == GeomType.CAPSULE and t2 == GeomType.MESH:
    return [cp for sgn in (-1.0, 1.0)
            for cp in _sphere_mesh(m, d, p1 + (sgn * s1[1]) * m1[..., 2],
                                   s1[0], g2)]
  raise _unported(t1, t2)


# ---------------------------------------------------------------------------
# Batched same-shape narrowphase: the pairs of one kind whose hulls have
# one shape run as one computation over the pair axis K, in each hull's
# local frame against its constant tables (collision.py :698-710).
# ---------------------------------------------------------------------------


def _hull_sig(m: Model, g: int):
  v, n, _ = m.geom_mesh[g]
  return (v.shape[0], n.shape[0])


def contact_clusters(m: Model):
  """Static pair clusters for the batched narrowphase, as JAX forms them:
  (mm, sm, pm, bm, cm, clustered), mm = mesh-mesh pair lists of one hull
  shape pair and condim 1, sm / pm / bm / cm = sphere- / plane- / box- /
  capsule-mesh pair lists of one hull shape and condim; clusters of fewer
  than 8 (mm) or 4 pairs stay on the unrolled path; clustered = the pairs
  the clusters cover."""
  mm, sm, pm, bm, cm = ({} for _ in range(5))
  kinds = {int(GeomType.SPHERE): sm, int(GeomType.PLANE): pm,
           int(GeomType.BOX): bm, int(GeomType.CAPSULE): cm}
  for (g1, g2) in m.collision_pairs:
    t1, t2 = int(m.geom_type[g1]), int(m.geom_type[g2])
    if t2 != int(GeomType.MESH):
      continue
    condim = pair_params(m, g1, g2).condim
    if t1 == int(GeomType.MESH):
      if condim == 1:
        mm.setdefault((_hull_sig(m, g1), _hull_sig(m, g2)), []).append(
            (g1, g2))
    elif t1 in kinds:
      kinds[t1].setdefault((_hull_sig(m, g2), condim), []).append((g1, g2))
  mm = [v for v in mm.values() if len(v) >= 8]
  sm, pm, bm, cm = ([v for v in c.values() if len(v) >= 4]
                    for c in (sm, pm, bm, cm))
  clustered = set()
  for cls in (mm, sm, pm, bm, cm):
    clustered |= set(p for cl in cls for p in cl)
  return mm, sm, pm, bm, cm, clustered


@dataclasses.dataclass(frozen=True)
class HullCluster:
  """One cluster's model constants, stacked once (JAX folds them into
  the trace, :762-780): its pairs, the device indices of their geoms, the
  first geoms' sizes and the hull tables of the second."""
  pairs: Tuple[Tuple[int, int], ...]
  g1: torch.Tensor       # (K,) long
  g2: torch.Tensor       # (K,) long
  size1: torch.Tensor    # (K, 3)
  verts: torch.Tensor    # (K, V, 3)
  fn: torch.Tensor       # (K, F, 3)
  fb: torch.Tensor       # (K, F)


def hull_cluster(m: Model, pairs) -> HullCluster:
  """The HullCluster of `pairs` ((g1, g2) with g2 a hull, all of one hull
  shape), on the model's device."""
  pairs = tuple((int(a), int(b)) for a, b in pairs)
  g1 = torch.tensor([a for a, _ in pairs], device=m.device)
  g2 = [b for _, b in pairs]
  return HullCluster(
      pairs, g1, torch.tensor(g2, device=m.device), m.geom_size[g1],
      *(torch.stack([m.geom_mesh[g][i] for g in g2]) for i in range(3)))


def _hulls_local(d: Data, cl: HullCluster):
  """(verts (K, V, 3), face normals (K, F, 3), offsets (K, F), xpos
  (B, K, 3), xmat (B, K, 3, 3)) of the cluster's hulls."""
  return (cl.verts, cl.fn, cl.fb, d.geom_xpos[:, cl.g2],
          d.geom_xmat[:, cl.g2])


def _flat(dist, pos, normal):
  """(B, K, k) candidates -> pair-major (B, K*k) ones."""
  bsz = dist.shape[0]
  return (dist.reshape(bsz, -1), pos.reshape(bsz, -1, 3),
          normal.reshape(bsz, -1, 3))


def plane_mesh_batched(m: Model, d: Data, cl: HullCluster, k: int = 4):
  """_plane_mesh over a cluster: the k deepest hull vertices below each
  pair's plane, the plane turned into the hull's frame. Returns (dist
  (B, K*k), pos (B, K*k, 3), normal (B, K*k, 3)), pair-major, normals
  g1 (plane) -> g2 (mesh)."""
  verts, _, _, xp2, xm2 = _hulls_local(d, cl)
  pp = d.geom_xpos[:, cl.g1]                                  # (B, K, 3)
  pn = d.geom_xmat[:, cl.g1, :, 2]
  pn_l = torch.einsum('bked,bke->bkd', xm2, pn)               # mat^T pn
  off = torch.sum((xp2 - pp) * pn, -1)
  dist = torch.einsum('kve,bke->bkv', verts, pn_l) + off[..., None]
  idx = _deepest(dist, min(k, verts.shape[1]))                # (B, K, k)
  dsel = torch.gather(dist, 2, idx)
  vsel = xp2[:, :, None] + torch.einsum('bked,bkid->bkie', xm2,
                                        _take(verts, idx))
  pos = vsel - 0.5 * dsel[..., None] * pn[:, :, None]
  return _flat(dsel, pos, pn[:, :, None].expand_as(vsel))


def _select_averaged(points, phi_n, phi_b, k, nsign, xp, xm):
  """The k deepest of `points` (B, K, P, 3) against halfspaces (B, K,
  F, 3), (B, K, F), all in the hull's frame, each with the mean of the
  normals of every face at its maximum; selected points and normals go
  back to the world by the hull pose xp (B, K, 3), xm (B, K, 3, 3)."""
  phi = (torch.einsum('bkpe,bkfe->bkpf', points, phi_n)
         + phi_b[:, :, None])
  depth = torch.amax(phi, -1)                                 # (B, K, P)
  oh = (phi >= depth[..., None]).to(phi.dtype)
  oh = oh / torch.clamp(torch.sum(oh, -1, keepdim=True), min=1.0)
  normals = torch.einsum('bkpf,bkfe->bkpe', oh, phi_n)
  idx = _deepest(depth, min(k, points.shape[2]))
  dsel = torch.gather(depth, 2, idx)
  psel = xp[:, :, None] + torch.einsum('bked,bkid->bkie', xm,
                                       _take(points, idx))
  nsel = torch.einsum('bked,bkid->bkie', xm, _take(normals, idx))
  nsel = nsel / torch.clamp(
      torch.linalg.vector_norm(nsel, dim=-1, keepdim=True), min=1e-12)
  return _flat(dsel, psel - 0.5 * dsel[..., None] * nsel, nsign * nsel)


def box_mesh_batched(m: Model, d: Data, cl: HullCluster, k: int = 4):
  """_box_mesh over a cluster: per pair the k deepest box corners in the
  hull, then (the second half) the k deepest hull vertices in the box,
  with the averaged-face normals. Returns (dist (B, 2*K*k), pos, normal),
  two pair-major halves, normals g1 (box) -> g2 (mesh)."""
  verts, fn, fb, xp2, xm2 = _hulls_local(d, cl)
  bsz, kp = xp2.shape[:2]
  bp = d.geom_xpos[:, cl.g1]                                  # (B, K, 3)
  bmat = d.geom_xmat[:, cl.g1]                                # (B, K, 3, 3)
  # box corners into the hull (hull normal hull -> corner = g2 -> g1),
  # in the hull's frame
  corners = m.idx.box_signs * cl.size1[:, None]               # (K, 8, 3)
  corners_w = bp[:, :, None] + torch.einsum('bkde,kpe->bkpd', bmat, corners)
  corners_l = torch.einsum('bked,bkpe->bkpd', xm2,
                           corners_w - xp2[:, :, None])
  d1, p1, n1 = _select_averaged(corners_l, fn.expand(bsz, -1, -1, -1),
                                fb.expand(bsz, -1, -1), k, -1.0, xp2, xm2)
  # hull vertices into the box's halfspaces (normal box -> vertex = g1 ->
  # g2), the halfspaces turned into the hull's frame
  bt = bmat.transpose(-1, -2)
  box_n = torch.cat([bt, -bt], 2)                             # (B, K, 6, 3)
  box_b = (-torch.einsum('bkfe,bke->bkf', box_n, bp)
           - torch.cat([cl.size1, cl.size1], -1))
  box_n_l = torch.einsum('bked,bkfe->bkfd', xm2, box_n)
  box_b_l = box_b + torch.einsum('bkfe,bke->bkf', box_n, xp2)
  d2, p2, n2 = _select_averaged(verts.expand(bsz, kp, -1, -1), box_n_l,
                                box_b_l, k, 1.0, xp2, xm2)
  return (torch.cat([d1, d2], 1), torch.cat([p1, p2], 1),
          torch.cat([n1, n2], 1))


def _spheres_vs_hulls(centres, r, cl, xp2, xm2):
  """Spheres (B, K, S, 3) of radii r (K,) against the cluster's hulls,
  the averaged-face rule: (dist (B, K, S), pos, normal g1 -> g2)."""
  c_l = torch.einsum('bked,bkse->bksd', xm2, centres - xp2[:, :, None])
  phi = torch.einsum('bksd,kfd->bksf', c_l, cl.fn) + cl.fb[:, None]
  best = torch.amax(phi, -1)                                  # (B, K, S)
  oh = (phi >= best[..., None]).to(phi.dtype)
  oh = oh / torch.clamp(torch.sum(oh, -1, keepdim=True), min=1.0)
  n = torch.einsum('bked,bksd->bkse', xm2,
                   torch.einsum('bksf,kfd->bksd', oh, cl.fn))
  n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True),
                      min=1e-12)
  r = r[:, None]
  dist = best - r
  return dist, centres - n * (r + 0.5 * dist)[..., None], -n


def capsule_mesh_batched(m: Model, d: Data, cl: HullCluster):
  """Capsule vs hull over a cluster: each capsule's two end spheres
  against its hull. Returns (dist (B, 2K), pos, normal), pair-major in the
  unrolled path's [-end, +end] order, normals g1 (capsule) -> g2
  (mesh)."""
  _, _, _, xp2, xm2 = _hulls_local(d, cl)
  p1 = d.geom_xpos[:, cl.g1]                                  # (B, K, 3)
  ax = d.geom_xmat[:, cl.g1, :, 2] * cl.size1[:, 1:2]
  ends = torch.stack([p1 - ax, p1 + ax], 2)                   # (B, K, 2, 3)
  return _flat(*_spheres_vs_hulls(ends, cl.size1[:, 0], cl, xp2, xm2))


def sphere_mesh_batched(m: Model, d: Data, cl: HullCluster):
  """_sphere_mesh over a cluster, the averaged-face rule: one point per
  pair, (dist (B, K), pos (B, K, 3), normal (B, K, 3)), normals g1
  (sphere) -> g2 (mesh)."""
  _, _, _, xp2, xm2 = _hulls_local(d, cl)
  c = d.geom_xpos[:, cl.g1, None]                             # (B, K, 1, 3)
  return _flat(*_spheres_vs_hulls(c, cl.size1[:, 0], cl, xp2, xm2))


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
  t1, t2 = m.geom_type[g1], m.geom_type[g2]
  counts = {(GeomType.PLANE, GeomType.SPHERE): 1,
            (GeomType.PLANE, GeomType.CAPSULE): 2,
            (GeomType.PLANE, GeomType.BOX): 8,
            (GeomType.SPHERE, GeomType.SPHERE): 1,
            (GeomType.SPHERE, GeomType.MESH): 1,
            (GeomType.CAPSULE, GeomType.MESH): 2,
            (GeomType.BOX, GeomType.MESH): 8}
  if (t1, t2) == (GeomType.PLANE, GeomType.MESH):
    return min(4, m.geom_mesh[g2][0].shape[0])
  if (t1, t2) not in counts:
    raise _unported(t1, t2)
  return counts[(t1, t2)]
