"""Task registry: built-in tasks, loaded from model snapshots.

Port of mujoco_mpc_tpu/tasks/registry.py, Cartpole entry only (:114-129).
The JAX registry compiles models/*.xml with `mujoco`; the port loads the
compiled model and task parameters from mujoco_mpc_tpu_torch/assets/
(written by tools/export_torch_snapshot.py), so it runs where neither
`mujoco` nor JAX is installed. Residuals are batch-first.
"""

from __future__ import annotations

import functools
import os

import torch

from mujoco_mpc_tpu_torch import convert
from mujoco_mpc_tpu_torch.tasks import base

ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'assets')


def _cartpole_residual(m, d, rp):
  """Reference: mjpc/tasks/cartpole/cartpole.cc Residual."""
  return torch.stack([
      torch.cos(d.qpos[:, 1]) - 1.0,   # Vertical
      d.qpos[:, 0] - rp[0],            # Centered (goal parameter)
      d.qvel[:, 1],                    # Velocity
      d.ctrl[:, 0],                    # Control
  ], dim=-1)


# task name -> (snapshot file, residual function)
TASKS = {'Cartpole': ('cartpole.npz', _cartpole_residual)}


def task_names():
  return tuple(TASKS)


@functools.lru_cache(maxsize=None)
def get_task(name: str, device='cpu', dtype=torch.float32) -> base.TaskSpec:
  """The task `name` with its model on `device` in `dtype`."""
  fname, residual_fn = TASKS[name]
  arrays, static = convert.load_snapshot(os.path.join(ASSETS, fname))
  return convert.spec_from_arrays(arrays, static, residual_fn,
                                  device=torch.device(device), dtype=dtype)
