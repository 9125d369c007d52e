"""Support queries over Data: point and subtree velocities, ground height.

Port of mujoco_mpc_tpu/physics/support.py: point_velocity :18,
site_linvel :26, subtree_linvel :35, _descendants :53, subtree_angmom :72,
get_state :96, set_state :101, state_diff :108, integrate_state :132,
_static_geoms :138 and ground_height :273, batch-first. The subtree sums
run over all bodies at once, weighted by the subtree's 0/1 body mask,
where JAX loops over the static body list; state_diff works on the joint
coordinate maps of Model.idx where JAX loops over the joints.

Not ported yet: body_angvel, raycast and mesh rays (ROADMAP A8), and
ground_height over height fields (A7), which raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

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


def ground_height(m: Model, d: Data, pos: torch.Tensor) -> torch.Tensor:
  """Terrain height (B, ...) under world positions pos (B, ..., 3): a
  vertical downward ray against the static group-0 planes, spheres and
  boxes, from 0.5 above pos; z = 0 where nothing is hit."""
  dtype = pos.dtype
  lead = (pos.shape[0],) + (1,) * (pos.dim() - 2)
  big = 1e9
  z0 = pos[..., 2] + 0.5
  origin = torch.stack([pos[..., 0], pos[..., 1], z0], -1)

  dists = []
  for g in _static_geoms(m):
    gtype = m.geom_type[g]
    if gtype == GeomType.HFIELD:
      raise NotImplementedError(
          'ground height over height fields is not ported yet (ROADMAP A7)')
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
    else:
      continue
    dists.append(dist.to(dtype))

  if not dists:
    return torch.zeros_like(z0)
  dist = torch.amin(torch.stack(dists), 0)
  return torch.where(dist < big, z0 - dist, torch.zeros_like(dist))
