"""Forward kinematics and com-based frame quantities, batch-first.

Port of mujoco_mpc_tpu/physics/kinematics.py (kinematics :21, com_pos
:133, com_vel :178): level-batched frame composition, subtree sums as
matmuls against static masks, cdof from candidate-table gathers. Every
index tensor comes from Model.idx (built once at model load).
"""

from __future__ import annotations

import torch

from mujoco_mpc_tpu_torch.physics.model import Data, JointType, Model
from mujoco_mpc_tpu_torch.utils import math as tm


def _set(x: torch.Tensor, idx: torch.Tensor, val: torch.Tensor):
  """x with x[:, idx] = val (out of place)."""
  return x.index_copy(1, idx, val)


def kinematics(m: Model, d: Data) -> Data:
  """Global body, joint, geom and site frames from qpos (mj_kinematics)."""
  qpos = d.qpos
  bsz = qpos.shape[0]
  kw = dict(dtype=qpos.dtype, device=qpos.device)
  xpos = torch.zeros((bsz, m.nbody, 3), **kw)
  xquat = torch.zeros((bsz, m.nbody, 4), **kw)
  xquat[:, :, 0] = 1.0
  xanchor = torch.zeros((bsz, m.njnt, 3), **kw)
  xaxis = torch.zeros((bsz, m.njnt, 3), **kw)

  for lvl in m.idx.levels:
    p_pos = xpos[:, lvl.parents]
    p_quat = xquat[:, lvl.parents]
    pos = p_pos + tm.quat_rot(p_quat, m.body_pos[lvl.bodies])
    quat = tm.quat_mul(p_quat, m.body_quat[lvl.bodies])

    if lvl.free is not None:
      g = lvl.free
      fpos = qpos[:, g.qadr[:, None] + torch.arange(3, device=qpos.device)]
      fquat = tm.quat_normalize(
          qpos[:, g.qadr[:, None] + 3 + torch.arange(4, device=qpos.device)])
      pos = _set(pos, g.pos, fpos)
      quat = _set(quat, g.pos, fquat)
      xanchor = _set(xanchor, g.jnt, fpos)
      xaxis = _set(xaxis, g.jnt, m.jnt_axis[g.jnt].expand(bsz, -1, -1))

    if lvl.mocap is not None:
      ipos, mids = lvl.mocap
      pos = _set(pos, ipos, d.mocap_pos[:, mids])
      quat = _set(quat, ipos, tm.quat_normalize(d.mocap_quat[:, mids]))

    for slot in lvl.slots:
      for jtype, g in slot.items():
        jpos = m.jnt_pos[g.jnt]                          # (K, 3)
        jaxis = m.jnt_axis[g.jnt]
        q_k = quat[:, g.pos]
        anchor = pos[:, g.pos] + tm.quat_rot(q_k, jpos)
        axis = tm.quat_rot(q_k, jaxis)
        xanchor = _set(xanchor, g.jnt, anchor)
        xaxis = _set(xaxis, g.jnt, axis)
        if jtype == JointType.SLIDE:
          disp = (qpos[:, g.qadr] - m.qpos0[g.qadr])[..., None]
          pos = _set(pos, g.pos, pos[:, g.pos] + axis * disp)
        elif jtype == JointType.HINGE:
          angle = qpos[:, g.qadr] - m.qpos0[g.qadr]
          q_new = tm.quat_mul(q_k, tm.axis_angle_to_quat(jaxis, angle))
          quat = _set(quat, g.pos, q_new)
          pos = _set(pos, g.pos, anchor - tm.quat_rot(q_new, jpos))
        elif jtype == JointType.BALL:
          qloc = tm.quat_normalize(
              qpos[:, g.qadr[:, None] + torch.arange(4, device=qpos.device)])
          q_new = tm.quat_mul(q_k, qloc)
          quat = _set(quat, g.pos, q_new)
          pos = _set(pos, g.pos, anchor - tm.quat_rot(q_new, jpos))
        else:
          raise NotImplementedError(f'joint type {jtype} in level plan')

    xpos = _set(xpos, lvl.bodies, pos)
    xquat = _set(xquat, lvl.bodies, tm.quat_normalize(quat))

  xmat = tm.quat_to_mat(xquat)
  xipos = xpos + tm.quat_rot(xquat, m.body_ipos)
  ximat = tm.quat_to_mat(tm.quat_mul(xquat, m.body_iquat))

  def frame(bodyid, offset_pos, offset_quat):
    bq = xquat[:, bodyid]
    gpos = xpos[:, bodyid] + tm.quat_rot(bq, offset_pos)
    gmat = tm.quat_to_mat(tm.quat_mul(bq, offset_quat))
    return gpos, gmat

  geom_xpos, geom_xmat = frame(m.idx.geom_bodyid, m.geom_pos, m.geom_quat)
  site_xpos, site_xmat = frame(m.idx.site_bodyid, m.site_pos, m.site_quat)
  return d.replace(
      xpos=xpos, xquat=xquat, xmat=xmat, xipos=xipos, ximat=ximat,
      xanchor=xanchor, xaxis=xaxis, geom_xpos=geom_xpos,
      geom_xmat=geom_xmat, site_xpos=site_xpos, site_xmat=site_xmat)


def com_pos(m: Model, d: Data) -> Data:
  """Subtree com, com-based spatial inertias and motion dofs (mj_comPos)."""
  idx = m.idx
  mass_x = m.body_mass[:, None] * d.xipos                 # (B, nbody, 3)
  sub_massx = idx.d_sub @ mass_x
  sub_mass = idx.d_sub @ m.body_mass
  subtree_com = sub_massx / torch.clamp(sub_mass, min=1e-12)[:, None]

  root_com = subtree_com[:, idx.body_rootid]
  xiquat = tm.quat_mul(d.xquat, m.body_iquat)
  cinert = tm.inert_from_body_quat(m.body_mass, m.body_inertia, xiquat,
                                   d.xipos, root_com)

  bsz = d.qpos.shape[0]
  zero3 = torch.zeros((bsz, 1, 3), dtype=d.qpos.dtype, device=d.qpos.device)
  xmat_cols = d.xmat.transpose(-1, -2).reshape(bsz, -1, 3)
  ang = torch.cat([zero3, d.xaxis, xmat_cols], 1)[:, idx.ang_idx]
  pt = torch.cat([zero3, d.xanchor, d.xpos], 1)[:, idx.pt_idx]
  linc = torch.cat([zero3, d.xaxis, idx.eye3.expand(bsz, 3, 3)],
                   1)[:, idx.lin_idx]
  origin = subtree_com[:, idx.dof_rootid]
  cdof = torch.cat([ang, tm.cross(ang, origin - pt) + linc], -1)
  return d.replace(subtree_com=subtree_com, cinert=cinert, cdof=cdof)


def com_vel(m: Model, d: Data) -> Data:
  """Body spatial velocities and cdof time derivatives (mj_comVel)."""
  cdof_qvel = d.cdof * d.qvel[..., None]                  # (B, nv, 6)
  cvel = m.idx.a_body @ cdof_qvel                         # (B, nbody, 6)
  v_at = m.idx.v_dof @ cdof_qvel                          # (B, nv, 6)
  cdof_dot = tm.motion_cross(v_at, d.cdof)
  return d.replace(cvel=cvel, cdof_dot=cdof_dot)
