"""Inertia-box fluid model: viscous and quadratic drag, with wind.

Port of mujoco_mpc_tpu/physics/fluid.py (fluid :21-76), batch-first. Each
body is replaced by its equivalent inertia box; the drag is computed in
the body's inertial frame at xipos and mapped to generalized forces with
the body's point Jacobian. JAX loops over the bodies and adds
jacp @ force + jacr @ torque one body at a time; here every body's wrench
is computed at once and mapped by smooth.xfrc_accumulate, which is the
same point Jacobian (xipos, the subtree root's com) summed over bodies.
"""

from __future__ import annotations

import torch

from mujoco_mpc_tpu_torch.physics import smooth
from mujoco_mpc_tpu_torch.physics.model import Data, Model
from mujoco_mpc_tpu_torch.utils import math as tm

_PI = 3.141592653589793


def fluid(m: Model, d: Data) -> Data:
  """Add fluid drag forces to qfrc_passive (mj_fluid, inertia-box)."""
  if not m.has_fluid:
    return d
  density, viscosity, wind = m.opt.density, m.opt.viscosity, m.opt.wind
  mass = m.body_mass[1:, None]                           # world excluded
  inertia = m.body_inertia[1:]
  perm1, perm2 = [1, 2, 0], [2, 0, 1]
  # equivalent inertia-box full side lengths
  box = torch.sqrt(torch.clamp(
      inertia[:, perm1] + inertia[:, perm2] - inertia, min=1e-12)
      / mass * 6.0)                                      # (nbody - 1, 3)

  # 6D velocity at xipos in the inertial (ximat) frame
  croot = d.subtree_com[:, m.idx.body_rootid[1:]]
  ang_w = d.cvel[:, 1:, :3]
  lin_w = d.cvel[:, 1:, 3:] + tm.cross(ang_w, d.xipos[:, 1:] - croot)
  ximat = d.ximat[:, 1:]
  rt = ximat.transpose(-1, -2)
  lvel_ang = (rt @ ang_w[..., None])[..., 0]
  lvel_lin = (rt @ (lin_w - wind)[..., None])[..., 0]

  # viscous resistance (equivalent sphere)
  diam = torch.sum(box, -1, keepdim=True) / 3.0
  lfrc_ang = -_PI * diam ** 3 * viscosity * lvel_ang
  lfrc_lin = -3.0 * _PI * diam * viscosity * lvel_lin

  # quadratic drag
  box_p1, box_p2 = box[:, perm1], box[:, perm2]
  lfrc_lin = lfrc_lin - 0.5 * density * box_p1 * box_p2 * \
      torch.abs(lvel_lin) * lvel_lin
  lfrc_ang = lfrc_ang - density * box * (box_p1 ** 4 + box_p2 ** 4) * \
      torch.abs(lvel_ang) * lvel_ang / 64.0

  # the local wrench in world axes, applied at xipos
  torque_w = (ximat @ lfrc_ang[..., None])[..., 0]
  force_w = (ximat @ lfrc_lin[..., None])[..., 0]
  wrench = torch.cat([force_w, torque_w], -1)
  wrench = torch.cat([torch.zeros_like(wrench[:, :1]), wrench], 1)
  qfrc = smooth.xfrc_accumulate(m, d.replace(xfrc_applied=wrench))
  return d.replace(qfrc_passive=d.qfrc_passive + qfrc)
