"""Support queries over Data: point and subtree velocities, ground height.

Port of mujoco_mpc_tpu/physics/support.py: point_velocity :18,
site_linvel :26, body_angvel :31, subtree_linvel :35, _descendants :53,
subtree_mass :65, subtree_angmom :72, get_state :96, set_state :101,
state_diff :108, integrate_state :132, _static_geoms :138, _ray_geom
:158, raycast :252 and ground_height :273, batch-first. The subtree sums
run over all bodies at once, weighted by the subtree's 0/1 body mask,
where JAX loops over the static body list; state_diff works on the joint
coordinate maps of Model.idx where JAX loops over the joints; a ray is
(B, 3) rays, one a sample. ground_height takes height fields through
the colliders' triangulated surface (collision._hfield_surface); a ray
of raycast misses a height field, as in JAX's raycast.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mujoco_mpc_tpu_torch.physics import collision
from mujoco_mpc_tpu_torch.physics import forward as fwd
from mujoco_mpc_tpu_torch.physics.model import Data, GeomType, Model
from mujoco_mpc_tpu_torch.utils import math as tm


def point_velocity(m: Model, d: Data, bodyid,
                   point: torch.Tensor) -> torch.Tensor:
  """World linear velocity (B, 3) of a point (B, 3) attached to a body;
  with a LongTensor of k body ids, (B, k, 3) of points (B, k, 3) (JAX
  stacks one call per body)."""
  origin = d.subtree_com[:, m.idx.body_rootid[bodyid]]
  w = d.cvel[:, bodyid, :3]
  return d.cvel[:, bodyid, 3:] + tm.cross(w, point - origin)


def site_linvel(m: Model, d: Data, siteid: int) -> torch.Tensor:
  """Linear velocity (B, 3) of a site (framelinvel sensor)."""
  return point_velocity(m, d, m.site_bodyid[siteid], d.site_xpos[:, siteid])


def body_angvel(m: Model, d: Data, bodyid) -> torch.Tensor:
  """Angular velocity (B, 3) of a body (B, k, 3 for k body ids)."""
  return d.cvel[:, bodyid, :3]


def _body_com_velocities(m: Model, d: Data) -> torch.Tensor:
  """Linear velocity (B, nbody, 3) of every body's center of mass."""
  origin = d.subtree_com[:, m.idx.body_rootid]
  return d.cvel[..., 3:] + tm.cross(d.cvel[..., :3], d.xipos - origin)


def _descendants(m: Model, bodyid: int) -> torch.Tensor:
  """(nbody,) 0/1 mask of the subtree rooted at bodyid (JAX: the static
  body list): the body's row of the ancestor-or-self mask."""
  return m.idx.d_sub[bodyid]


def subtree_linvel(m: Model, d: Data, bodyid: int) -> torch.Tensor:
  """Mass-weighted linear velocity (B, 3) of a body subtree
  (subtreelinvel sensor)."""
  w = _descendants(m, bodyid) * m.body_mass
  momentum = torch.einsum('n,bnk->bk', w, _body_com_velocities(m, d))
  return momentum / torch.clamp(torch.sum(w), min=1e-12)


def subtree_mass(m: Model, bodyid: int) -> torch.Tensor:
  """Total mass (0-d) of the subtree rooted at bodyid."""
  return torch.sum(_descendants(m, bodyid) * m.body_mass)


def subtree_angmom(m: Model, d: Data, bodyid: int) -> torch.Tensor:
  """Angular momentum (B, 3) of a subtree about its center of mass
  (subtreeangmom sensor)."""
  mask = _descendants(m, bodyid)
  w = mask * m.body_mass
  com = (torch.einsum('n,bnk->bk', w, d.xipos)
         / torch.clamp(torch.sum(w), min=1e-12))
  v = _body_com_velocities(m, d)
  # orbital m (r - com) x v, plus spin R I R^T w in the inertial frame
  orbital = torch.einsum('n,bnk->bk', w,
                         tm.cross(d.xipos - com[:, None, :], v))
  local = m.body_inertia * (d.ximat.transpose(-1, -2)
                            @ d.cvel[..., :3, None])[..., 0]
  spin = torch.einsum('n,bnk->bk', mask, (d.ximat @ local[..., None])[..., 0])
  return orbital + spin


def get_state(d: Data) -> torch.Tensor:
  """Physics state (B, nq + nv + na): qpos, qvel, act, in the reference's
  State order."""
  return torch.cat([d.qpos, d.qvel, d.act], -1)


def set_state(m: Model, d: Data, state: torch.Tensor) -> Data:
  return d.replace(qpos=state[:, :m.nq], qvel=state[:, m.nq:m.nq + m.nv],
                   act=state[:, m.nq + m.nv:m.nq + m.nv + m.na])


def state_diff(m: Model, qpos1: torch.Tensor,
               qpos2: torch.Tensor) -> torch.Tensor:
  """Velocity-space difference qpos2 - qpos1 (B, nv) on the configuration
  manifold (mj_differentiatePos): coordinate differences for slides,
  hinges and free translations, quat_sub for quaternion blocks."""
  idx = m.idx
  out = torch.zeros(qpos1.shape[:-1] + (m.nv,), dtype=qpos1.dtype,
                    device=qpos1.device)
  if len(idx.sq):
    out = out.index_copy(1, idx.sd, qpos2[:, idx.sq] - qpos1[:, idx.sq])
  if len(idx.qj):
    phi = tm.quat_sub(qpos2[:, idx.quat_q], qpos1[:, idx.quat_q])
    out = out.index_copy(1, idx.quat_d.reshape(-1),
                         phi.reshape(qpos1.shape[0], -1))
  return out


def integrate_state(m: Model, qpos: torch.Tensor, dq: torch.Tensor,
                    scale=1.0) -> torch.Tensor:
  """qpos + scale dq on the manifold (mj_integratePos with dt = scale)."""
  return fwd.integrate_pos(m, qpos, dq, scale)


def _static_geoms(m: Model, group: int = 0) -> Tuple[int, ...]:
  """Geoms in `group` on bodies with no dofs in their ancestor chain (the
  terrain and scene; the reference Ground() raycast's static geoms)."""
  out = []
  for g in range(m.ngeom):
    if m.geom_group[g] != group:
      continue
    b = m.geom_bodyid[g]
    static = True
    while b > 0:
      if m.body_dofnum[b]:
        static = False
        break
      b = m.body_parentid[b]
    if static:
      out.append(g)
  return tuple(out)


def _quadratic(b: torch.Tensor, c: torch.Tensor, big: float) -> torch.Tensor:
  """Smallest positive root of t^2 + 2 b t + c = 0, `big` if none."""
  disc = b * b - c
  sq = torch.sqrt(torch.clamp(disc, min=0.0))
  t0, t1 = -b - sq, -b + sq
  t = torch.where(t0 > 0, t0, torch.where(t1 > 0, t1, torch.full_like(t0,
                                                                       big)))
  return torch.where(disc >= 0, t, torch.full_like(t, big))


def _ray_geom(m: Model, d: Data, g: int, origin: torch.Tensor,
              dirn: torch.Tensor) -> torch.Tensor:
  """Distance (B,) along unit rays (B, 3) to geom g (mj_rayGeom), `big`
  (1e9) on a miss: plane (one-sided, +z normal; a ray within 64 eps of
  the dtype of parallel misses), sphere, ellipsoid, capsule, cylinder,
  box and convex hull; a height field is never hit."""
  big = 1e9
  gtype = m.geom_type[g]
  gpos, gmat, size = d.geom_xpos[:, g], d.geom_xmat[:, g], m.geom_size[g]
  local = lambda v: torch.einsum('bji,bj->bi', gmat, v)  # noqa: E731  R^T v
  bigs = torch.full_like(origin[:, 0], big)

  if gtype == GeomType.PLANE:
    n = gmat[..., 2]
    denom = tm.dot(n, dirn)
    # a ray parallel to the plane misses (JAX's guard, 1e-12). In float32
    # a level ray's n.dir is rounding noise of ~1e-7, whose sign would put
    # a hit millions of metres away on one device and a miss on another:
    # below 64 eps of the dtype the ray counts as parallel
    tol = max(1e-12, 64 * torch.finfo(denom.dtype).eps)
    parallel = torch.abs(denom) < tol
    t = tm.dot(n, gpos - origin) / torch.where(
        parallel, torch.full_like(denom, tol), denom)
    return torch.where((t > 0) & ~parallel, t, bigs)
  if gtype == GeomType.SPHERE:
    oc = origin - gpos
    return _quadratic(tm.dot(oc, dirn), tm.dot(oc, oc) - size[0] ** 2, big)
  if gtype == GeomType.ELLIPSOID:      # scaled to the unit sphere
    o = local(origin - gpos) / size
    v = local(dirn) / size
    vv = tm.dot(v, v)
    return _quadratic(tm.dot(o, v) / vv, (tm.dot(o, o) - 1.0) / vv, big)
  if gtype in (GeomType.CAPSULE, GeomType.CYLINDER):
    o = local(origin - gpos)
    v = local(dirn)
    r, h = size[0], size[1]
    # the side surface: the axis (z) projected out
    vv = v[:, 0] ** 2 + v[:, 1] ** 2
    vv_safe = torch.clamp(vv, min=1e-12)
    t_side = _quadratic((o[:, 0] * v[:, 0] + o[:, 1] * v[:, 1]) / vv_safe,
                        (o[:, 0] ** 2 + o[:, 1] ** 2 - r * r) / vv_safe, big)
    z_at = o[:, 2] + t_side * v[:, 2]
    ts = [torch.where((vv > 1e-12) & (torch.abs(z_at) <= h), t_side, bigs)]
    if gtype == GeomType.CAPSULE:      # spherical end caps
      for zc in (-1.0, 1.0):
        oc = o - torch.stack([torch.zeros_like(h), torch.zeros_like(h),
                              zc * h])
        t_cap = _quadratic(tm.dot(oc, v), tm.dot(oc, oc) - r * r, big)
        zrel = o[:, 2] + t_cap * v[:, 2] - zc * h
        ts.append(torch.where(zc * zrel >= 0, t_cap, bigs))
    else:                              # flat end discs
      vz = torch.where(torch.abs(v[:, 2]) < 1e-12,
                       torch.full_like(v[:, 2], 1e-12), v[:, 2])
      for zc in (-1.0, 1.0):
        t_disc = (zc * h - o[:, 2]) / vz
        x = o[:, 0] + t_disc * v[:, 0]
        y = o[:, 1] + t_disc * v[:, 1]
        ts.append(torch.where((t_disc > 0) & (x * x + y * y <= r * r),
                              t_disc, bigs))
    return torch.amin(torch.stack(ts), 0)
  if gtype == GeomType.BOX:            # slab test
    o = local(origin - gpos)
    v = local(dirn)
    v = torch.where(torch.abs(v) < 1e-12, torch.full_like(v, 1e-12), v)
    t1 = (-size - o) / v
    t2 = (size - o) / v
    tmin = torch.amax(torch.minimum(t1, t2), -1)
    tmax = torch.amin(torch.maximum(t1, t2), -1)
    hit = (tmax >= torch.clamp(tmin, min=0.0)) & (tmax > 0)
    return torch.where(hit, torch.where(tmin > 0, tmin, tmax), bigs)
  if gtype == GeomType.MESH and g in m.geom_mesh:   # hull: halfspace slabs
    from mujoco_mpc_tpu_torch.physics import collision
    _, n_w, b_w = collision._hull_world(m, d, g)
    num = -(torch.einsum('bfd,bd->bf', n_w, origin) + b_w)
    den = torch.einsum('bfd,bd->bf', n_w, dirn)
    den = torch.where(torch.abs(den) < 1e-12, torch.full_like(den, 1e-12),
                      den)
    t = num / den
    tmin = torch.amax(torch.where(den < 0, t, torch.full_like(t, -big)), -1)
    tmax = torch.amin(torch.where(den > 0, t, torch.full_like(t, big)), -1)
    hit = (tmax >= torch.clamp(tmin, min=0.0)) & (tmax > 0)
    return torch.where(hit, torch.where(tmin > 0, tmin, tmax), bigs)
  return bigs


def raycast(m: Model, d: Data, origin: torch.Tensor, dirn: torch.Tensor,
            exclude_body: int = -1) -> torch.Tensor:
  """Distance (B,) from origins (B, 3) along directions (B, 3) to the
  nearest geom (mj_ray; the rangefinder sensor), -1 where nothing is hit.
  Geoms on `exclude_body` and visual-only geoms (contype and conaffinity
  0, planes excepted) are skipped."""
  big = 1e9
  dirn = dirn / torch.clamp(torch.linalg.vector_norm(dirn, dim=-1,
                                                     keepdim=True), min=1e-12)
  dists = [torch.full_like(origin[:, 0], big)]
  for g in range(m.ngeom):
    if exclude_body >= 0 and m.geom_bodyid[g] == exclude_body:
      continue
    if m.geom_contype[g] == 0 and m.geom_conaffinity[g] == 0 and \
       m.geom_type[g] != GeomType.PLANE:
      continue
    dists.append(_ray_geom(m, d, g, origin, dirn))
  t = torch.amin(torch.stack(dists), 0)
  return torch.where(t < big, t, torch.full_like(t, -1.0))


def ground_height(m: Model, d: Data, pos: torch.Tensor) -> torch.Tensor:
  """Terrain height (B, ...) under world positions pos (B, ..., 3): a
  vertical downward ray against the static group-0 planes, spheres,
  boxes and height fields, from 0.5 above pos; z = 0 where nothing is
  hit. A height field is hit on the triangle under the ray in its frame
  (an axis-aligned field's exact surface; JAX's z-axis approximation of
  a tilted one), missed beyond its extent."""
  dtype = pos.dtype
  lead = (pos.shape[0],) + (1,) * (pos.dim() - 2)
  big = 1e9
  z0 = pos[..., 2] + 0.5
  origin = torch.stack([pos[..., 0], pos[..., 1], z0], -1)

  dists = []
  for g in _static_geoms(m):
    gtype = m.geom_type[g]
    gpos = d.geom_xpos[:, g].reshape(lead + (3,))
    gmat = d.geom_xmat[:, g].reshape(lead + (3, 3))
    size = m.geom_size[g]
    if gtype == GeomType.PLANE:
      # z of the plane through gpos with normal n = R e_z at (x, y)
      n = gmat[..., 2]
      denom = torch.where(torch.abs(n[..., 2]) < 1e-9,
                          torch.full_like(n[..., 2], 1e-9), n[..., 2])
      zs = gpos[..., 2] + (n[..., 0] * (gpos[..., 0] - origin[..., 0])
                           + n[..., 1] * (gpos[..., 1] - origin[..., 1])
                           ) / denom
      dist = z0 - zs
    elif gtype == GeomType.SPHERE:
      # |oc - t e_z|^2 = r^2  ->  t^2 - 2 oc_z t + |oc|^2 - r^2 = 0
      oc = origin - gpos
      b = oc[..., 2]
      disc = b * b - (torch.sum(oc * oc, -1) - size[0] * size[0])
      t = b - torch.sqrt(torch.clamp(disc, min=0.0))
      dist = torch.where((disc >= 0) & (t > 0), t, torch.full_like(t, big))
    elif gtype == GeomType.BOX:
      # slab test in the box frame
      gmat_t = gmat.transpose(-1, -2)
      o = (gmat_t @ (origin - gpos)[..., None])[..., 0]
      dd = -gmat_t[..., 2]                                   # R^T (0, 0, -1)
      dd = torch.where(torch.abs(dd) < 1e-12, torch.full_like(dd, 1e-12), dd)
      t1 = (-size - o) / dd
      t2 = (size - o) / dd
      tmin = torch.amax(torch.minimum(t1, t2), -1)
      tmax = torch.amin(torch.maximum(t1, t2), -1)
      dist = torch.where((tmax >= tmin) & (tmax > 0),
                         torch.clamp(tmin, min=0.0),
                         torch.full_like(tmin, big))
    elif gtype == GeomType.HFIELD:
      lc = (gmat.transpose(-1, -2) @ (origin - gpos)[..., None])[..., 0]
      z, _, inside = collision._hfield_surface(*m.geom_hfield[g],
                                               lc[..., 0], lc[..., 1])
      dist = torch.where(inside, lc[..., 2] - z, torch.full_like(z, big))
    else:
      continue
    dists.append(dist.to(dtype))

  if not dists:
    return torch.zeros_like(z0)
  dist = torch.amin(torch.stack(dists), 0)
  return torch.where(dist < big, z0 - dist, torch.zeros_like(dist))
