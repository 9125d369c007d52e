"""Collision narrowphase for primitive geoms and convex hulls, batch-first.

Port of mujoco_mpc_tpu/physics/collision.py: ContactPoint :32,
_make_frame :44, _make_frames :59, _plane_sphere :81, _plane_capsule :87,
_plane_box :103, _sphere_sphere :116, _closest_on_segment :125,
_segment_closest :130, _sphere_box :145, _box_box_sat :170,
_capsule_box :376, the cylinder and ellipsoid colliders (_plane_cylinder
:289, _plane_ellipsoid :322, _sphere_cylinder :336,
_cylinder_axis_contact :472), the convex-hull colliders
(_points_vs_halfspaces :395, _hull_world :416, _plane_mesh :426,
_sphere_mesh :439, _box_mesh :452, _mesh_mesh :504), the height-field
colliders (_hfield_surface :515, _hfield_point :552, _hfield_collide
:568), narrowphase :604 (plane against sphere, capsule, cylinder,
ellipsoid, box and mesh; height field against sphere, capsule, cylinder,
ellipsoid and box; sphere against sphere, capsule, ellipsoid, cylinder,
box and mesh; capsule against capsule, ellipsoid, cylinder, box and
mesh; ellipsoid and cylinder against box through _box_mesh with the
roles swapped, and against ellipsoids, cylinders and meshes through
_mesh_mesh on their tessellated hulls, plus the axis contact for two
cylinders; box against box and mesh; mesh against mesh), the batched
hull clusters
(_hull_sig :712, contact_clusters :717, _hulls_local :762,
plane_mesh_batched :783, box_mesh_batched :809, mesh_mesh_batched :874
with its broadphase, capsule_mesh_batched :949, sphere_mesh_batched
:983), PairParams :1005 and pair_params :1015. As in JAX, each static geom
pair emits a fixed number of candidate points (inactive ones are masked
by distance later), so every shape is static; here each field carries a
leading batch dimension B. The segment, capsule and box-box colliders
take any leading dimensions (...), and so do the cylinder and ellipsoid
colliders, so that the pairs of one kind can be stacked; narrowphase
calls them a pair at a time, as JAX does.

Two selection rules are mirrored exactly, not unified: the unrolled
colliders take the normal of the first face at the maximum (argmax), the
batched clusters average the normals of every face at the maximum. Every
k-deepest choice is `_deepest`, a stable sort, so that among equal depths
the lower index comes first, as lax.top_k gives it (a hull resting on a
face has exact ties). The hull tables are float32 values; the small
contractions over them go through matmul, which runs in full float32
unless the caller enables TF32.

A height field is a triangulated grid: a point takes the plane of the
triangle under it, each cell split along its (0, 0)-(1, 1) diagonal, and
a point beyond the grid's extent (by more than a cell) gets depth _BIG.
The cell indices are per sample, so the grid is gathered per point.

Not ported yet, and refused where reached: a height field against a
mesh (ROADMAP A7; JAX emits no point there).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mujoco_mpc_tpu_torch.physics.model import Data, GeomType, Model
from mujoco_mpc_tpu_torch.utils import math as tm


# the depth of a candidate that is no contact (JAX's _BIG)
_BIG = 1e10


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


def _plane_sphere(pp, pn, c, r):
  dist = tm.dot(pn, c - pp) - r
  pos = c - pn * (r + 0.5 * dist)[..., None]
  return [ContactPoint(dist, pos, pn)]


def _plane_capsule(pp, pn, c, axis, half, r):
  # t1 along the capsule axis projected onto the plane; makeFrame's t1
  # where the capsule stands normal to the plane
  t = axis - pn * tm.dot(pn, axis)[..., None]
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
  dist = tm.dot(pn[:, None, :], corners - pp[:, None, :])             # (B, 8)
  pos = corners - (0.5 * dist)[..., None] * pn[:, None, :]
  return [ContactPoint(dist[:, k], pos[:, k], pn) for k in range(8)]


def _sphere_sphere(c1, r1, c2, r2):
  dv = c2 - c1
  ln = torch.linalg.vector_norm(dv, dim=-1)
  n = dv / torch.clamp(ln, min=1e-12)[..., None]
  dist = ln - r1 - r2
  pos = c1 + n * (r1 + 0.5 * dist)[..., None]
  return [ContactPoint(dist, pos, n)]


def _closest_on_segment(p, c, axis, half):
  """The point of the segment c +- half axis closest to p (..., 3)."""
  t = torch.clamp(tm.dot(p - c, axis), -half, half)
  return c + t[..., None] * axis


def _segment_closest(c1, a1, h1, c2, a2, h2):
  """Closest points (q1, q2) (..., 3) between the segments c1 +- h1 a1 and
  c2 +- h2 a2 (unit axes), JAX's clamped solve: s, then t, then s again,
  the denominator 1 - (a1.a2)^2 floored at 1e-12 (parallel axes: s 0
  before its re-clamp)."""
  r = c1 - c2
  b = tm.dot(a1, a2)
  cdot = tm.dot(a1, r)
  f = tm.dot(a2, r)
  denom = torch.clamp(1.0 - b * b, min=1e-12)
  s = torch.clamp((b * f - cdot) / denom, -h1, h1)
  t = torch.clamp(f + s * b, -h2, h2)
  s = torch.clamp(t * b - cdot, -h1, h1)
  return c1 + s[..., None] * a1, c2 + t[..., None] * a2


def _capsule_capsule(c1, a1, h1, r1, c2, a2, h2, r2):
  """Capsule vs capsule: the spheres at the segments' closest points."""
  q1, q2 = _segment_closest(c1, a1, h1, c2, a2, h2)
  return _sphere_sphere(q1, r1, q2, r2)


def _sphere_box(c, r, bc, bmat, bsize):
  """Sphere (centre c (..., 3), radius r) vs box (centre bc (..., 3),
  frame bmat (..., 3, 3), half sizes bsize (3,)), in the box's frame.
  Shallow, the centre outside or on the surface: the closest box point,
  the normal towards the centre (guarded at 1e-12: zero on the surface).
  Deep, the centre strictly inside on every axis: pushed out along the
  axis of least depth, the first such axis at a tie (jnp.argmin's), the
  normal's sign that of the centre's coordinate there (0 at the exact
  centre, as jnp.sign gives it). The normal points from the box to the
  sphere; the caller flips it."""
  local = torch.einsum('...ji,...j->...i', bmat, c - bc)
  clamped = torch.clamp(local, -bsize, bsize)
  inside = torch.all(torch.abs(local) < bsize, -1)
  delta = local - clamped
  ln = torch.linalg.vector_norm(delta, dim=-1)
  n_shallow = delta / torch.clamp(ln, min=1e-12)[..., None]
  depth = bsize - torch.abs(local)
  d0, d1, d2 = depth.unbind(-1)
  k = torch.where((d0 <= d1) & (d0 <= d2), 0, torch.where(d1 <= d2, 1, 2))
  dk = torch.gather(depth, -1, k[..., None])[..., 0]
  sign = torch.sign(torch.gather(local, -1, k[..., None]))
  n_deep = torch.nn.functional.one_hot(k, 3).to(c.dtype) * sign
  n_local = torch.where(inside[..., None], n_deep, n_shallow)
  dist = torch.where(inside, -(dk + r), ln - r)
  surface_local = torch.where(inside[..., None],
                              local + n_local * dk[..., None], clamped)
  n = torch.einsum('...ij,...j->...i', bmat, n_local)
  surface = bc + torch.einsum('...ij,...j->...i', bmat, surface_local)
  return [ContactPoint(dist, surface + 0.5 * dist[..., None] * n, n)]


def _plane_cylinder(pp, pn, c, mat, size):
  """Plane vs cylinder (centre c (..., 3), frame mat (..., 3, 3), size
  (radius, half length)): four points, the deepest rim point of each end
  disc, then the opposite rim point of each disc, masked (dist 1e6)
  unless the cylinder lies flat (|axis . n| < 0.05). The radial direction
  is the plane normal's part across the axis, the frame's x where the
  axis stands along the normal."""
  r, half = size[0], size[1]
  axis = mat[..., 2]
  a_dot = tm.dot(pn, axis)
  rad = pn - a_dot[..., None] * axis
  ln = torch.linalg.vector_norm(rad, dim=-1, keepdim=True)
  rad_n = torch.where(ln > 1e-8, rad / torch.clamp(ln, min=1e-12),
                      mat[..., 0])
  pts = []
  for send in (-1.0, 1.0):
    deep = c + (send * half) * axis - r * rad_n
    dist = tm.dot(pn, deep - pp)
    pts.append(ContactPoint(dist, deep - (0.5 * dist)[..., None] * pn, pn))
  flat = torch.abs(a_dot) < 0.05
  for send in (-1.0, 1.0):
    other = c + (send * half) * axis + r * rad_n
    dist0 = tm.dot(pn, other - pp)
    dist = torch.where(flat, dist0, 1e6)
    pts.append(ContactPoint(dist, other - (0.5 * dist0)[..., None] * pn, pn))
  return pts


def _plane_ellipsoid(pp, pn, c, mat, size):
  """Plane vs ellipsoid: the support point along -n, c - mat (s^2 nl) /
  sqrt(nl . s^2 nl) with nl = mat^T n."""
  nl = _mtv(mat, pn)
  s2nl = size * size * nl
  denom = torch.sqrt(torch.clamp(tm.dot(nl, s2nl), min=1e-18))
  deep = c - _mv(mat, s2nl / denom[..., None])
  dist = tm.dot(pn, deep - pp)
  return [ContactPoint(dist, deep - (0.5 * dist)[..., None] * pn, pn)]


def _sphere_cylinder(c, r, cc, cmat, csize):
  """Sphere (centre c (..., 3), radius r) vs cylinder (centre cc, frame
  cmat, size (radius, half length)) in closed form, in the cylinder's
  frame: outside, the closest point of the solid cylinder (side, end disc
  or rim); inside, the exit through the nearer of the side wall and the
  end disc. One point, the normal from the sphere to the cylinder."""
  rad_c, half = csize[0], csize[1]
  local = _mtv(cmat, c - cc)
  rho = torch.linalg.vector_norm(local[..., :2], dim=-1)
  e_x = torch.tensor([1.0, 0.0], dtype=c.dtype, device=c.device)
  radial = torch.where((rho > 1e-9)[..., None],
                       local[..., :2] / torch.clamp(rho, min=1e-12)[..., None],
                       e_x)
  za = local[..., 2]
  outside = (rho > rad_c) | (torch.abs(za) > half)
  q_out = torch.cat([torch.minimum(rho, rad_c)[..., None] * radial,
                     torch.clamp(za, -half, half)[..., None]], -1)
  delta = local - q_out
  ln = torch.linalg.vector_norm(delta, dim=-1)
  n_out = delta / torch.clamp(ln, min=1e-12)[..., None]
  d_out = ln - r
  side = (rad_c - rho) < (half - torch.abs(za))
  zsgn = torch.where(za >= 0, 1.0, -1.0).to(c.dtype)
  zero = torch.zeros_like(za)[..., None]
  e_z = torch.tensor([0.0, 0.0, 1.0], dtype=c.dtype, device=c.device)
  n_in = torch.where(side[..., None], torch.cat([radial, zero], -1),
                     e_z * zsgn[..., None])
  q_in = torch.where(side[..., None],
                     torch.cat([rad_c * radial, za[..., None]], -1),
                     torch.cat([rho[..., None] * radial,
                                (zsgn * half)[..., None]], -1))
  d_in = torch.where(side, rho - rad_c, torch.abs(za) - half) - r
  n_l = torch.where(outside[..., None], n_out, n_in)
  q_l = torch.where(outside[..., None], q_out, q_in)
  dist = torch.where(outside, d_out, d_in)
  n_w = _mv(cmat, n_l)                                   # cylinder -> sphere
  pos = cc + _mv(cmat, q_l) + (0.5 * dist)[..., None] * n_w
  return [ContactPoint(dist, pos, -n_w)]


def _cylinder_axis_contact(p1, m1, s1, p2, m2, s2):
  """Two cylinders' side-side contact from the closest points of their
  axes (JAX's clamped solve, as _segment_closest): valid where both
  closest points lie inside 99 % of their half lengths and the common
  perpendicular is within |cos| 0.3 of orthogonal to both axes, else
  dist 1e9. The normal points g1 -> g2."""
  a1, a2 = m1[..., 2], m2[..., 2]
  h1, h2 = s1[1], s2[1]
  r = p1 - p2
  b = tm.dot(a1, a2)
  cdot = tm.dot(a1, r)
  f = tm.dot(a2, r)
  denom = torch.clamp(1.0 - b * b, min=1e-12)
  s = torch.clamp((b * f - cdot) / denom, -h1, h1)
  t = torch.clamp(f + s * b, -h2, h2)
  s = torch.clamp(t * b - cdot, -h1, h1)
  q1 = p1 + s[..., None] * a1
  q2 = p2 + t[..., None] * a2
  diff = q2 - q1
  ln = torch.linalg.vector_norm(diff, dim=-1)
  n = diff / torch.clamp(ln, min=1e-12)[..., None]
  interior = (torch.abs(s) < 0.99 * h1) & (torch.abs(t) < 0.99 * h2)
  side = (torch.abs(tm.dot(n, a1)) < 0.3) & (torch.abs(tm.dot(n, a2)) < 0.3)
  valid = interior & side & (ln > 1e-9)
  gap = ln - s1[0] - s2[0]
  dist = torch.where(valid, gap, 1e9)
  pos = q1 + n * (s1[0] + 0.5 * gap)[..., None]
  return [ContactPoint(dist, pos, n)]


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
  """Index (...) of the first maximum of x (..., n): jnp.argmax's choice
  among equals, by explicit comparison."""
  hit = x >= torch.amax(x, -1, keepdim=True)
  n = x.shape[-1]
  ar = torch.arange(n, device=x.device)
  return torch.amin(torch.where(hit, ar, n), -1)


def _pick(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
  """x (..., n) at the index idx (...) of its last axis."""
  return torch.gather(x, -1, idx[..., None])[..., 0]


def _column(mat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
  """Column idx (...) of mat (..., 3, 3): (..., 3)."""
  return torch.gather(mat, -1, idx[..., None, None].expand(
      mat.shape[:-1] + (1,)))[..., 0]


def _mv(mat, v):
  return torch.einsum('...ij,...j->...i', mat, v)


def _mtv(mat, v):
  return torch.einsum('...ji,...j->...i', mat, v)


# the 4 incident-face vertices (su, sv) in JAX's order, su outermost
_FACE_SIGNS = ((-1.0, -1.0), (-1.0, 1.0), (1.0, -1.0), (1.0, 1.0))


def _sat_axes(p1, m1, s1, p2, m2, s2):
  """The separating-axis test of _box_box_sat on boxes (centres (..., 3),
  frames (..., 3, 3), half sizes (..., 3)): (face separations (..., 6),
  box 1's axes then box 2's; edge separations (..., 9) over e_i x b_j, i
  outer, -1e6 where the edges are parallel (the axis's norm below 1e-6);
  the unit edge axes (..., 9, 3) in box 1's frame)."""
  eps = 1e-9
  r = torch.einsum('...ji,...jk->...ik', m1, m2)   # box2 axes in box1 frame
  t = _mtv(m1, p2 - p1)                            # box2 centre in box1 frame
  absr = torch.abs(r) + eps
  sep1 = torch.abs(t) - (s1 + _mv(absr, s2))
  t2f = _mtv(r, t)
  sep2 = torch.abs(t2f) - (s2 + _mtv(absr, s1))
  # edge axes cross(e_i, r[:, j]) in box1's frame, (..., 9, 3), i outer
  eye = torch.eye(3, dtype=p1.dtype, device=p1.device)
  rt = r.transpose(-1, -2)                         # rows: r[:, j]
  axis = tm.cross(eye[:, None, :], rt[..., None, :, :]).flatten(-3, -2)
  ln = torch.linalg.vector_norm(axis, dim=-1)
  axis_n = axis / torch.clamp(ln, min=eps)[..., None]
  ra = torch.sum(s1[..., None, :] * torch.abs(axis_n), -1)
  rb = torch.sum(s2[..., None, :] * torch.abs(
      torch.einsum('...ji,...aj->...ai', r, axis_n)), -1)
  sep = torch.abs(torch.sum(t[..., None, :] * axis_n, -1)) - (ra + rb)
  return (torch.cat([sep1, sep2], -1), torch.where(ln < 1e-6, -1e6, sep),
          axis_n)


def _box_box_sat(p1, m1, s1, p2, m2, s2):
  """Box vs box (centres (..., 3), frames (..., 3, 3), half sizes (3,) or
  (..., 3)) by the separating-axis test, JAX's _box_box_sat (_sat_axes):
  the first face axis of largest separation unless the first such edge
  axis beats it by more than 1e-4. Five points: the incident face's 4
  vertices clamped into the reference face (dist 1e6 when the edge
  wins), then the edges' closest-point contact (dist 1e6 when a face
  wins). jnp.sign(0) = 0 carries through: at exact alignment a normal or
  a support may be zero, as in JAX. The normal points g1 -> g2."""
  dtype = p1.dtype
  big = 1e6
  s1 = s1.expand(p1.shape)
  s2 = s2.expand(p2.shape)
  face_seps, edge_seps, axis_n = _sat_axes(p1, m1, s1, p2, m2, s2)
  best_face = _first_argmax(face_seps)
  best_edge = _first_argmax(edge_seps)
  face_sep = _pick(face_seps, best_face)
  edge_sep_v = _pick(edge_seps, best_edge)
  use_edge = edge_sep_v > face_sep + 1e-4
  separation = torch.maximum(face_sep, edge_sep_v)

  # ---- face manifold: reference box A, incident face of B ----
  a_is_1 = best_face < 3
  ia = torch.where(a_is_1, best_face, best_face - 3)
  a1v, a1m = a_is_1[..., None], a_is_1[..., None, None]
  ca, mata, sa = (torch.where(a1v, p1, p2), torch.where(a1m, m1, m2),
                  torch.where(a1v, s1, s2))
  cb, matb, sb = (torch.where(a1v, p2, p1), torch.where(a1m, m2, m1),
                  torch.where(a1v, s2, s1))
  axis_a = _column(mata, ia)
  sign_a = torch.sign(tm.dot(cb - ca, axis_a))
  n_ref = axis_a * sign_a[..., None]               # A -> B
  dots = _mtv(matb, n_ref)
  jb = _first_argmax(torch.abs(dots))
  sign_b = -torch.sign(_pick(dots, jb))
  n_inc = _column(matb, jb) * sign_b[..., None]
  face_center_b = cb + n_inc * _pick(sb, jb)[..., None]
  j1 = torch.remainder(jb + 1, 3)
  j2 = torch.remainder(jb + 2, 3)
  tb1 = _column(matb, j1) * _pick(sb, j1)[..., None]
  tb2 = _column(matb, j2) * _pick(sb, j2)[..., None]
  su, sv = (torch.tensor(x, dtype=dtype, device=p1.device)[:, None]
            for x in zip(*_FACE_SIGNS))            # (4, 1) each
  v = (face_center_b[..., None, :] + su * tb1[..., None, :]
       + sv * tb2[..., None, :])                   # (..., 4, 3)
  vl = torch.einsum('...ji,...aj->...ai', mata, v - ca[..., None, :])
  sa4 = sa[..., None, :]
  vl_clamped = torch.clamp(vl, -sa4, sa4)
  keep = torch.nn.functional.one_hot(ia, 3).to(dtype)[..., None, :]
  vl2 = keep * vl + (1.0 - keep) * vl_clamped
  vw = ca[..., None, :] + torch.einsum('...ij,...aj->...ai', mata, vl2)
  depth = (torch.sum((vw - ca[..., None, :]) * n_ref[..., None, :], -1)
           - torch.sum(sa * torch.abs(_mtv(mata, n_ref)), -1)[..., None])
  dist = torch.where(use_edge[..., None], big, depth)
  n_out = torch.where(a1v, n_ref, -n_ref)
  pos = vw - 0.5 * depth[..., None] * n_ref[..., None, :]
  pts = [ContactPoint(dist[..., k], pos[..., k, :], n_out)
         for k in range(4)]

  # ---- edge manifold ----
  i_e = torch.div(best_edge, 3, rounding_mode='floor')
  j_e = torch.remainder(best_edge, 3)
  axis_e = torch.gather(axis_n, -2, best_edge[..., None, None].expand(
      best_edge.shape + (1, 3)))[..., 0, :]
  axis_w = _mv(m1, axis_e)
  axis_w = axis_w * torch.sign(tm.dot(p2 - p1, axis_w))[..., None]
  ar3 = torch.arange(3, device=p1.device)
  sup1 = torch.where(ar3 == i_e[..., None], 0.0,
                     torch.sign(_mtv(m1, axis_w)))
  e1c = p1 + _mv(m1, sup1 * s1)
  sup2 = torch.where(ar3 == j_e[..., None], 0.0,
                     -torch.sign(_mtv(m2, axis_w)))
  e2c = p2 + _mv(m2, sup2 * s2)
  q1, q2 = _segment_closest(e1c, _column(m1, i_e), _pick(s1, i_e), e2c,
                            _column(m2, j_e), _pick(s2, j_e))
  edge_dist = torch.where(use_edge, separation, big)
  return pts + [ContactPoint(edge_dist, 0.5 * (q1 + q2), axis_w)]


def _capsule_box(c, axis, half, r, bc, bmat, bsize):
  """Capsule (centre c (..., 3), unit axis, half length, radius) vs box:
  the segment point closest to the box by 8 alternating projections
  from the centre (t = 0), then _sphere_box there and at the two ends,
  in that order, each normal flipped to point capsule -> box."""
  t = torch.zeros(c.shape[:-1], dtype=c.dtype, device=c.device)
  for _ in range(8):
    p = c + t[..., None] * axis
    local = torch.clamp(_mtv(bmat, p - bc), -bsize, bsize)
    q = bc + _mv(bmat, local)
    t = torch.clamp(tm.dot(q - c, axis), -half, half)
  ha = half[..., None] * axis
  ends = (c + t[..., None] * axis, c - ha, c + ha)
  return [ContactPoint(x.dist, x.pos, -x.normal)
          for pt in ends for x in _sphere_box(pt, r, bc, bmat, bsize)]


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


def _mesh_mesh(m: Model, d: Data, g1: int, g2: int):
  """Hull vs hull: the k deepest vertices of g1 in g2 (normal flipped to
  g1 -> g2), then the k deepest vertices of g2 in g1."""
  v1, n1, b1 = _hull_world(m, d, g1)
  v2, n2, b2 = _hull_world(m, d, g2)
  pts = [ContactPoint(c.dist, c.pos, -c.normal)
         for c in _points_vs_halfspaces(v1, n2, b2)]
  return pts + _points_vs_halfspaces(v2, n1, b1)


def _hfield_surface(grid, size, lx, ly):
  """The triangulated height field (grid (nrow, ncol) in [0, 1], size
  (rx, ry, z_top, z_bottom)) under local (lx, ly) (...): (surface z, unit
  normal (..., 3) in the field's frame, inside the extent). Heights are
  grid * z_top over [-rx, rx] x [-ry, ry]; a cell's lower triangle (u >=
  v) is (00, 10, 11), its upper one (00, 11, 01). The cell indices are
  clamped as floats before the integer cast (JAX's int32 cast saturates
  where a point lies far off)."""
  nrow, ncol = grid.shape
  dx = 2.0 * size[0] / (ncol - 1)
  dy = 2.0 * size[1] / (nrow - 1)
  fx = (lx + size[0]) / dx
  fy = (ly + size[1]) / dy
  i = torch.clamp(torch.floor(fx), 0, ncol - 2)
  j = torch.clamp(torch.floor(fy), 0, nrow - 2)
  u = torch.clamp(fx - i, 0.0, 1.0)
  v = torch.clamp(fy - j, 0.0, 1.0)
  flat = grid.reshape(-1)
  at = j.long() * ncol + i.long()
  z00 = flat[at] * size[2]
  z10 = flat[at + 1] * size[2]
  z01 = flat[at + ncol] * size[2]
  z11 = flat[at + ncol + 1] * size[2]
  lower = u >= v
  a = torch.where(lower, z10 - z00, z11 - z01)
  b = torch.where(lower, z11 - z10, z01 - z00)
  z = z00 + a * u + b * v
  n = tm.normalize(torch.stack([-a / dx, -b / dy, torch.ones_like(a)], -1))
  inside = (torch.abs(lx) <= size[0] + dx) & (torch.abs(ly) <= size[1] + dy)
  return z, n, inside


def _hfield_point(grid, size, p1, m1, c, r):
  """A sphere (centre c (..., 3), radius r; 0 for a point) against the
  height field at pose (p1 (..., 3), m1 (..., 3, 3)): depth along the
  normal of the triangle under the centre, _BIG outside the extent; the
  normal points from the field to the sphere."""
  lc = _mtv(m1, c - p1)
  z, n, inside = _hfield_surface(grid, size, lc[..., 0], lc[..., 1])
  p_surf = torch.stack([lc[..., 0], lc[..., 1], z], -1)
  dist = torch.where(inside, tm.dot(n, lc - p_surf) - r, _BIG)
  n_w = _mv(m1, n)
  return ContactPoint(dist, c - n_w * (r + 0.5 * dist)[..., None], n_w)


def _hfield_collide(m: Model, d: Data, g1: int, g2: int):
  """Height field g1 against geom g2, point-sampled: a sphere's centre (1
  point), a capsule's or a cylinder's two end-cap centres (+ end first,
  the cylinder as spheres of its radius), an ellipsoid's centre with its
  least semi-axis (1), and a box's 4 deepest of its 8 corners (the lower
  corner index first among equal depths: jnp.argsort is stable)."""
  t2 = m.geom_type[g2]
  if t2 not in (GeomType.SPHERE, GeomType.CAPSULE, GeomType.CYLINDER,
                GeomType.ELLIPSOID, GeomType.BOX):
    raise _unported(int(GeomType.HFIELD), t2)
  grid, size = m.geom_hfield[g1]
  p1, m1 = d.geom_xpos[:, g1], d.geom_xmat[:, g1]
  p2, m2, s2 = d.geom_xpos[:, g2], d.geom_xmat[:, g2], m.geom_size[g2]

  def point(c, r):
    return _hfield_point(grid, size, p1, m1, c, r)
  if t2 == GeomType.SPHERE:
    return [point(p2, s2[0])]
  if t2 in (GeomType.CAPSULE, GeomType.CYLINDER):
    ha = s2[1] * m2[..., 2]
    return [point(p2 + ha, s2[0]), point(p2 - ha, s2[0])]
  if t2 == GeomType.ELLIPSOID:
    return [point(p2, torch.amin(s2))]
  corners = p2[:, None, :] + (m.idx.box_signs * s2) @ m2.transpose(-1, -2)
  cp = _hfield_point(grid, size, p1[:, None], m1[:, None], corners, 0.0)
  idx = _deepest(cp.dist, 4)                                  # (B, 4)
  dist = torch.gather(cp.dist, 1, idx)
  pos, normal = _take(cp.pos, idx), _take(cp.normal, idx)
  return [ContactPoint(dist[:, k], pos[:, k], normal[:, k])
          for k in range(4)]


def _unported(t1: int, t2: int) -> NotImplementedError:
  return NotImplementedError(
      f'{GeomType(t1).name.lower()}-{GeomType(t2).name.lower()} contacts '
      f'are not ported yet (ROADMAP A7)')


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
    if t2 == GeomType.CYLINDER:
      return _plane_cylinder(p1, pn, p2, m2, s2)
    if t2 == GeomType.ELLIPSOID:
      return _plane_ellipsoid(p1, pn, p2, m2, s2)
    if t2 == GeomType.MESH:
      return _plane_mesh(m, d, p1, pn, g2)
  elif t1 == GeomType.HFIELD:
    return _hfield_collide(m, d, g1, g2)
  elif t1 == GeomType.SPHERE:
    if t2 == GeomType.SPHERE:
      return _sphere_sphere(p1, s1[0], p2, s2[0])
    if t2 == GeomType.CAPSULE:
      cp = _closest_on_segment(p1, p2, m2[..., 2], s2[1])
      return _sphere_sphere(p1, s1[0], cp, s2[0])
    if t2 == GeomType.ELLIPSOID:     # its tessellated hull
      return _sphere_mesh(m, d, p1, s1[0], g2)
    if t2 == GeomType.CYLINDER:
      return _sphere_cylinder(p1, s1[0], p2, m2, s2)
    if t2 == GeomType.BOX:
      # _sphere_box's normal points box -> sphere, g2 -> g1: flipped
      return [cp._replace(normal=-cp.normal)
              for cp in _sphere_box(p1, s1[0], p2, m2, s2)]
    if t2 == GeomType.MESH:
      return _sphere_mesh(m, d, p1, s1[0], g2)
  elif t1 == GeomType.BOX and t2 == GeomType.BOX:
    return _box_box_sat(p1, m1, s1, p2, m2, s2)
  elif t1 == GeomType.BOX and t2 == GeomType.MESH:
    return _box_mesh(m, d, g1, g2, m.idx.box_signs)
  elif t1 == GeomType.CAPSULE and t2 == GeomType.CAPSULE:
    return _capsule_capsule(p1, m1[..., 2], s1[1], s1[0], p2, m2[..., 2],
                            s2[1], s2[0])
  elif t1 == GeomType.CAPSULE and t2 == GeomType.CYLINDER:
    # the segment point closest to the cylinder's axis, then both ends
    q1, _ = _segment_closest(p1, m1[..., 2], s1[1], p2, m2[..., 2], s2[1])
    ends = [p1 + (sgn * s1[1]) * m1[..., 2] for sgn in (-1.0, 1.0)]
    return [cp for c in [q1] + ends
            for cp in _sphere_cylinder(c, s1[0], p2, m2, s2)]
  elif t1 == GeomType.CAPSULE and t2 == GeomType.ELLIPSOID:
    return [cp for sgn in (-1.0, 0.0, 1.0)
            for cp in _sphere_mesh(m, d, p1 + (sgn * s1[1]) * m1[..., 2],
                                   s1[0], g2)]
  elif t1 == GeomType.CAPSULE and t2 == GeomType.BOX:
    return _capsule_box(p1, m1[..., 2], s1[1], s1[0], p2, m2, s2)
  elif t1 == GeomType.CAPSULE and t2 == GeomType.MESH:
    return [cp for sgn in (-1.0, 1.0)
            for cp in _sphere_mesh(m, d, p1 + (sgn * s1[1]) * m1[..., 2],
                                   s1[0], g2)]
  elif t1 == GeomType.MESH and t2 == GeomType.MESH:
    return _mesh_mesh(m, d, g1, g2)
  elif t1 in (GeomType.ELLIPSOID, GeomType.CYLINDER):
    # the tessellated hulls: against a box through _box_mesh with the
    # roles swapped (its normal flipped back to g1 -> g2), against the
    # other hulls through _mesh_mesh
    if t2 == GeomType.BOX:
      return [cp._replace(normal=-cp.normal)
              for cp in _box_mesh(m, d, g2, g1, m.idx.box_signs)]
    if t2 in (GeomType.ELLIPSOID, GeomType.CYLINDER, GeomType.MESH):
      pts = _mesh_mesh(m, d, g1, g2)
      if t1 == GeomType.CYLINDER and t2 == GeomType.CYLINDER:
        pts += _cylinder_axis_contact(p1, m1, s1, p2, m2, s2)
      return pts
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


@dataclasses.dataclass(frozen=True)
class MeshCluster:
  """A mesh-mesh cluster's model constants, stacked once: its pairs, the
  device indices of their geoms, both hulls' tables, and each pair's
  summed hull circumradii for the broadphase (JAX's `_rb`, computed in
  float32 from the float32 tables as JAX does)."""
  pairs: Tuple[Tuple[int, int], ...]
  g1: torch.Tensor       # (K,) long
  g2: torch.Tensor       # (K,) long
  hull1: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (K, V, 3), ...
  hull2: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
  radii: torch.Tensor    # (K,)


def mesh_cluster(m: Model, pairs) -> MeshCluster:
  """The MeshCluster of mesh-mesh `pairs` (one hull shape pair), on the
  model's device."""
  pairs = tuple((int(a), int(b)) for a, b in pairs)

  def radius(g):
    v = m.geom_mesh[g][0].detach().cpu().numpy().astype(np.float32)
    return float(np.linalg.norm(v, axis=-1).max())

  radii = np.asarray([radius(a) for a, _ in pairs]) + np.asarray(
      [radius(b) for _, b in pairs])
  return MeshCluster(
      pairs, torch.tensor([a for a, _ in pairs], device=m.device),
      torch.tensor([b for _, b in pairs], device=m.device),
      *(tuple(torch.stack([m.geom_mesh[g[side]][i] for g in pairs])
              for i in range(3)) for side in (0, 1)),
      torch.as_tensor(radii, dtype=m.dtype, device=m.device))


def _one_way(va, xpa, xma, fnb, fbb, xpb, xmb, k, sign):
  """Vertices va (B, K, V, 3) of hull a against the halfspaces (fnb
  (B, K, F, 3), fbb (B, K, F)) of hull b, in b's frame: the k deepest
  per pair, each with the mean of the normals of every face at its
  maximum (collision.py :906-937). Returns (dist, pos, normal) flat,
  pair-major, normal `sign` times b's outward normal."""
  rel = torch.einsum('bkcd,bkce->bkde', xmb, xma)             # b^T a
  t = torch.einsum('bked,bke->bkd', xmb, xpa - xpb)
  va_in_b = t[:, :, None] + torch.einsum('bkde,bkve->bkvd', rel, va)
  phi = torch.einsum('bkve,bkfe->bkvf', va_in_b, fnb) + fbb[:, :, None]
  depth = torch.amax(phi, -1)                                 # (B, K, V)
  oh = (phi >= depth[..., None]).to(phi.dtype)
  oh = oh / torch.clamp(torch.sum(oh, -1, keepdim=True), min=1.0)
  normals = torch.einsum('bkvf,bkfe->bkve', oh, fnb)
  idx = _deepest(depth, k)                                    # (B, K, k)
  dist = torch.gather(depth, 2, idx)
  vsel = xpb[:, :, None] + torch.einsum('bked,bkid->bkie', xmb,
                                        _take(va_in_b, idx))
  nsel = torch.einsum('bked,bkid->bkie', xmb, _take(normals, idx))
  nsel = nsel / torch.clamp(
      torch.linalg.vector_norm(nsel, dim=-1, keepdim=True), min=1e-12)
  return _flat(dist, vsel - 0.5 * dist[..., None] * nsel, sign * nsel)


def mesh_mesh_batched(m: Model, d: Data, cl: MeshCluster, k: int = 4,
                      pair_cap: int = 64):
  """_mesh_mesh over a cluster of hull pairs. Broadphase: past
  `pair_cap` pairs, only the pair_cap nearest by centre distance minus
  the hulls' circumradii (the lower index first among equals, lax.top_k's
  order) get a narrowphase, chosen per sample. Returns (dist (B, P), pos
  (B, P, 3), normal (B, P, 3), pair_idx (B, P)) with P = 2 k
  min(pair_cap, K): the k deepest vertices of each first hull in its
  second, then of each second in its first, pair-major, normals g1 ->
  g2, and the index into the cluster's pairs of each point."""
  bsz = d.qpos.shape[0]
  npairs = len(cl.pairs)
  if pair_cap and npairs > pair_cap:
    cdist = (torch.linalg.vector_norm(
        d.geom_xpos[:, cl.g1] - d.geom_xpos[:, cl.g2], dim=-1) - cl.radii)
    sel = _deepest(cdist, pair_cap)                           # (B, cap)
  else:
    sel = torch.arange(npairs, device=d.qpos.device).expand(bsz, npairs)
  h1 = tuple(x[sel] for x in cl.hull1)                       # (B, k', ...)
  h2 = tuple(x[sel] for x in cl.hull2)
  i1, i2 = cl.g1[sel], cl.g2[sel]                             # (B, k')
  rows = torch.arange(bsz, device=d.qpos.device)[:, None]
  xp1, xm1 = d.geom_xpos[rows, i1], d.geom_xmat[rows, i1]
  xp2, xm2 = d.geom_xpos[rows, i2], d.geom_xmat[rows, i2]
  kk = min(k, h1[0].shape[2])
  d12, p12, n12 = _one_way(h1[0], xp1, xm1, h2[1], h2[2], xp2, xm2, kk,
                           -1.0)
  d21, p21, n21 = _one_way(h2[0], xp2, xm2, h1[1], h1[2], xp1, xm1, kk,
                           1.0)
  base = sel.repeat_interleave(kk, dim=1)
  return (torch.cat([d12, d21], 1), torch.cat([p12, p21], 1),
          torch.cat([n12, n21], 1), torch.cat([base, base], 1))


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
            (GeomType.PLANE, GeomType.CYLINDER): 4,
            (GeomType.PLANE, GeomType.ELLIPSOID): 1,
            (GeomType.HFIELD, GeomType.SPHERE): 1,
            (GeomType.HFIELD, GeomType.CAPSULE): 2,
            (GeomType.HFIELD, GeomType.ELLIPSOID): 1,
            (GeomType.HFIELD, GeomType.CYLINDER): 2,
            (GeomType.HFIELD, GeomType.BOX): 4,
            (GeomType.SPHERE, GeomType.SPHERE): 1,
            (GeomType.SPHERE, GeomType.CAPSULE): 1,
            (GeomType.SPHERE, GeomType.ELLIPSOID): 1,
            (GeomType.SPHERE, GeomType.CYLINDER): 1,
            (GeomType.SPHERE, GeomType.BOX): 1,
            (GeomType.SPHERE, GeomType.MESH): 1,
            (GeomType.CAPSULE, GeomType.CAPSULE): 1,
            (GeomType.CAPSULE, GeomType.ELLIPSOID): 3,
            (GeomType.CAPSULE, GeomType.CYLINDER): 3,
            (GeomType.CAPSULE, GeomType.BOX): 3,
            (GeomType.CAPSULE, GeomType.MESH): 2,
            (GeomType.BOX, GeomType.BOX): 5,
            (GeomType.BOX, GeomType.MESH): 8}
  if (t1, t2) == (GeomType.PLANE, GeomType.MESH):
    return min(4, m.geom_mesh[g2][0].shape[0])
  hulls = (GeomType.ELLIPSOID, GeomType.CYLINDER, GeomType.MESH)
  if t1 in hulls and t2 == GeomType.BOX:      # box corners, hull vertices
    return 4 + min(4, m.geom_mesh[g1][0].shape[0])
  if t1 in hulls and t2 in hulls:
    return (min(4, m.geom_mesh[g1][0].shape[0])
            + min(4, m.geom_mesh[g2][0].shape[0])
            + (t1 == t2 == GeomType.CYLINDER))
  if (t1, t2) not in counts:
    raise _unported(t1, t2)
  return counts[(t1, t2)]
