"""Smooth dynamics: mass matrix, bias, passive, transmission, actuation.

Port of mujoco_mpc_tpu/physics/smooth.py (crb :22, rne :46, tendon :197,
passive :278, transmission :348, actuation :473, xfrc_accumulate :525),
batch-first. Dense mass matrix; tree sums are matmuls against the static
masks in Model.idx.

Not ported yet, and refused where reached: tendons (ROADMAP A8), gravity
compensation (A8), and actuator transmissions other than joints (A8).
"""

from __future__ import annotations

import torch

from mujoco_mpc_tpu_torch.physics.model import Data, Model, TrnType
from mujoco_mpc_tpu_torch.utils import math as tm


def crb(m: Model, d: Data) -> Data:
  """Composite-rigid-body mass matrix, dense (mj_crb)."""
  crb_inert = m.idx.d_sub @ d.cinert                      # (B, nbody, 10)
  f = tm.inert_vec(crb_inert[:, m.idx.dof_body], d.cdof)  # (B, nv, 6)
  lower = (f @ d.cdof.transpose(-1, -2)) * m.dof_ancestor_mask
  qm = (lower + lower.transpose(-1, -2)
        - torch.diag_embed(torch.diagonal(lower, dim1=-2, dim2=-1)))
  qm = qm + torch.diag(m.dof_armature)
  return d.replace(qM=qm)


def rne(m: Model, d: Data) -> Data:
  """Bias force C(q, qvel) qvel + gravity (mj_rne)."""
  base = torch.cat([torch.zeros_like(m.opt.gravity), -m.opt.gravity])
  cacc = base + m.idx.a_body @ (d.cdof_dot * d.qvel[..., None])
  iv = tm.inert_vec(d.cinert, d.cvel)
  cfrc = tm.inert_vec(d.cinert, cacc) + tm.force_cross(d.cvel, iv)
  cfrc_total = m.idx.d_sub @ cfrc                         # (B, nbody, 6)
  qfrc_bias = torch.sum(d.cdof * cfrc_total[:, m.idx.dof_body], dim=-1)
  return d.replace(qfrc_bias=qfrc_bias)


def tendon(m: Model, d: Data) -> Data:
  """Tendon lengths and moments (mj_tendon); a model without tendons
  passes through."""
  if m.ntendon:
    raise NotImplementedError('tendons are not ported yet (ROADMAP A8)')
  return d


def passive(m: Model, d: Data) -> Data:
  """Damper and joint-spring forces (mj_passive; fluid in forward.py).
  Ball and free joints spring on the quaternion difference
  (smooth.py:304-307)."""
  qfrc = -m.dof_damping * d.qvel
  idx = m.idx
  if m.any_gravcomp:
    raise NotImplementedError(
        'gravity compensation is not ported yet (ROADMAP A8)')
  if len(idx.sq):
    dif = d.qpos[:, idx.sq] - m.qpos_spring[idx.sq]
    qfrc = qfrc.index_add(1, idx.sd, -m.jnt_stiffness[idx.sj] * dif)
  if len(idx.qj):
    rot = tm.quat_sub(d.qpos[:, idx.quat_q], m.qpos_spring[idx.quat_q])
    qfrc = qfrc.index_add(
        1, idx.quat_d.reshape(-1),
        (-m.jnt_stiffness[idx.qj][:, None] * rot).reshape(d.qpos.shape[0],
                                                          -1))
  return d.replace(qfrc_passive=qfrc)


def transmission(m: Model, d: Data) -> Data:
  """Actuator lengths, velocities and moment arms for joint
  transmissions (mj_transmission)."""
  if m.nu == 0:
    return d
  if any(t != TrnType.JOINT for t in m.actuator_trntype):
    raise NotImplementedError(
        'non-joint actuator transmissions are not ported yet (ROADMAP A8)')
  gear = m.actuator_gear                                  # (nu, 6)
  moment = torch.einsum('unk,uk->un', m.idx.act_sel, gear)
  length = d.qpos[:, m.idx.act_qadr] * gear[:, 0] * m.idx.act_scalar
  velocity = d.qvel @ moment.T
  return d.replace(actuator_length=length, actuator_velocity=velocity,
                   actuator_moment=moment.expand(d.qpos.shape[0], -1, -1))


def actuation(m: Model, d: Data) -> Data:
  """Actuator forces and activation derivatives (mj_fwdActuation)."""
  if m.nu == 0:
    return d.replace(qfrc_actuator=torch.zeros_like(d.qvel),
                     act_dot=d.act)
  idx = m.idx
  ctrl = d.ctrl
  clamped = torch.clamp(ctrl, m.actuator_ctrlrange[:, 0],
                        m.actuator_ctrlrange[:, 1])
  ctrl = torch.where(idx.ctrl_limited, clamped, ctrl)

  if m.na:
    tau = torch.clamp(m.actuator_dynprm[:, 0], min=1e-8)
    act_u = d.act[:, idx.act_gather]
    dot_u = torch.where(idx.is_integ, ctrl, (ctrl - act_u) / tau)
    act_dot = torch.zeros_like(d.act).index_copy(
        1, idx.act_scatter_a, dot_u[:, idx.act_scatter_u])
    inp = torch.where(idx.has_act, act_u, ctrl)
  else:
    act_dot = d.act
    inp = ctrl

  gp, bp = m.actuator_gainprm, m.actuator_biasprm
  affine_g = (gp[:, 0] + gp[:, 1] * d.actuator_length
              + gp[:, 2] * d.actuator_velocity)
  gains = torch.where(idx.gain_affine, affine_g, gp[:, 0])
  affine_b = (bp[:, 0] + bp[:, 1] * d.actuator_length
              + bp[:, 2] * d.actuator_velocity)
  biases = torch.where(idx.bias_on, affine_b, torch.zeros_like(affine_b))
  force = gains * inp + biases
  fclamped = torch.clamp(force, m.actuator_forcerange[:, 0],
                         m.actuator_forcerange[:, 1])
  force = torch.where(idx.force_limited, fclamped, force)
  qfrc_actuator = (force[:, None, :] @ d.actuator_moment)[:, 0]
  return d.replace(actuator_force=force, act_dot=act_dot,
                   qfrc_actuator=qfrc_actuator)


def xfrc_accumulate(m: Model, d: Data) -> torch.Tensor:
  """Per-body applied world wrenches mapped to generalized forces."""
  off = d.xipos - d.subtree_com[:, m.idx.body_rootid]     # (B, nbody, 3)
  # jacp[b, i] = cdof[i, 3:] + cdof[i, :3] x off[b]
  jacp = (d.cdof[:, None, :, 3:]
          + tm.cross(d.cdof[:, None, :, :3], off[:, :, None, :]))
  contrib = (torch.einsum('zbis,zbs->zbi', jacp, d.xfrc_applied[..., :3])
             + d.xfrc_applied[..., 3:] @ d.cdof[..., :3].transpose(-1, -2))
  return torch.sum(m.idx.a_body * contrib, dim=1)
