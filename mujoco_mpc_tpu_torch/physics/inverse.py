"""Inverse dynamics: the applied force from (qpos, qvel, qacc).

Port of mujoco_mpc_tpu/physics/inverse.py (inverse :20), batch-first:
mj_inverse for the smooth pipeline, which the direct optimizer and the
batch estimator call at every window step. It solves nothing, so it
launches no kernel.
"""

from __future__ import annotations

import torch

from mujoco_mpc_tpu_torch.physics import fluid as fluid_mod
from mujoco_mpc_tpu_torch.physics import kinematics as kin
from mujoco_mpc_tpu_torch.physics import smooth
from mujoco_mpc_tpu_torch.physics.model import Data, Model, zero_filled


def inverse(m: Model, d: Data) -> Data:
  """qfrc_smooth = M qacc + bias - passive for Data's (qpos, qvel, qacc),
  with the kinematic fields the sensors read. Fields no stage sets read
  zero, as in JAX's make_data template."""
  d = zero_filled(m, d)
  d = kin.kinematics(m, d)
  d = kin.com_pos(m, d)
  d = smooth.transmission(m, d)
  d = kin.com_vel(m, d)
  d = smooth.rne(m, d)
  d = smooth.passive(m, d)
  d = fluid_mod.fluid(m, d)
  d = smooth.crb(m, d)
  qfrc_inverse = ((d.qM @ d.qacc[..., None])[..., 0] + d.qfrc_bias
                  - d.qfrc_passive)
  return d.replace(qfrc_actuator=torch.zeros_like(qfrc_inverse),
                   qfrc_smooth=qfrc_inverse)
