"""Estimator framework: the filter state and the ground-truth estimator.

Port of mujoco_mpc_tpu/estimators/base.py (EstimatorState :24, ndx :36,
init_state :40, _sensor_range :56, measure :75, predict :84, perturb
:91, difference :100, ground_truth_update :114), batch-first: B filters
side by side, each field with a leading batch dimension (an unbatched
JAX state is B = 1). Estimators are update functions over an
EstimatorState (the reference's Estimator interface,
mjpc/estimators/estimator.h:33-210).

`measure` and `predict` run the forward pipeline and the step, so on the
card they launch both hand kernels (B1 for the mass-matrix and Euler
solves, B2 for the constraint solve).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from mujoco_mpc_tpu_torch.physics import forward as fwd
from mujoco_mpc_tpu_torch.physics import sensors as sensors_mod
from mujoco_mpc_tpu_torch.physics import support
from mujoco_mpc_tpu_torch.physics.model import Data, Model


@dataclasses.dataclass(frozen=True)
class EstimatorState:
  """Filter state: physics state, tangent-space covariance, noise."""
  qpos: torch.Tensor           # (B, nq)
  qvel: torch.Tensor           # (B, nv)
  act: torch.Tensor            # (B, na)
  time: torch.Tensor           # (B,)
  covariance: torch.Tensor     # (B, ndx, ndx)
  noise_process: torch.Tensor  # (B, ndx) diagonal
  noise_sensor: torch.Tensor   # (B, nsensordata of the selection) diagonal

  def replace(self, **changes) -> 'EstimatorState':
    return dataclasses.replace(self, **changes)


def ndx(m: Model) -> int:
  """Tangent dimension of the state: 2 nv + na."""
  return 2 * m.nv + m.na


def init_state(m: Model, batch: int = 1, dtype: Optional[torch.dtype] = None,
               sensor_slice: Optional[Tuple[int, int]] = None,
               covariance_scale: float = 1e-4, process_noise: float = 1e-5,
               sensor_noise: float = 1e-4) -> EstimatorState:
  """`batch` filters at qpos0 at rest, on the model's device (dtype: the
  model's)."""
  dtype = dtype or m.dtype
  kw = dict(dtype=dtype, device=m.device)
  nd = ndx(m)
  nsel = _sensor_range(m, sensor_slice)[1]
  return EstimatorState(
      qpos=m.qpos0.to(dtype).expand(batch, m.nq).clone(),
      qvel=torch.zeros((batch, m.nv), **kw),
      act=torch.zeros((batch, m.na), **kw),
      time=torch.zeros(batch, **kw),
      covariance=covariance_scale * torch.eye(nd, **kw).expand(
          batch, nd, nd).clone(),
      noise_process=torch.full((batch, nd), process_noise, **kw),
      noise_sensor=torch.full((batch, nsel), sensor_noise, **kw))


def _sensor_range(m: Model, sensor_slice) -> Tuple[int, int]:
  """(first sensordata column, columns) of a (first sensor, count) range;
  all sensors when sensor_slice is None."""
  start, count = (0, len(m.sensor_type)) if sensor_slice is None \
      else sensor_slice
  if count == 0:
    return 0, 0
  last = start + count - 1
  adr0 = m.sensor_adr[start]
  return adr0, m.sensor_adr[last] + m.sensor_dim[last] - adr0


def _state_data(template: Data, qpos, qvel, act, time, ctrl) -> Data:
  """template (batch 1 or the state's) with the state set."""
  if template.batch != qpos.shape[0]:
    template = template.expand(qpos.shape[0])
  return template.replace(qpos=qpos, qvel=qvel, act=act, time=time,
                          ctrl=ctrl)


def measure(m: Model, template: Data, qpos, qvel, act, time, ctrl,
            sensor_slice=None) -> torch.Tensor:
  """Predicted measurements h(x, u) (B, ns): forward, then the selected
  sensordata columns."""
  d = fwd.forward(m, _state_data(template, qpos, qvel, act, time, ctrl))
  adr0, dim = _sensor_range(m, sensor_slice)
  return sensors_mod.sensordata(m, d)[:, adr0:adr0 + dim]


def predict(m: Model, template: Data, qpos, qvel, act, time, ctrl):
  """One dynamics step f(x, u): (qpos, qvel, act, time)."""
  d = fwd.step(m, _state_data(template, qpos, qvel, act, time, ctrl))
  return d.qpos, d.qvel, d.act, d.time


def perturb(m: Model, qpos, qvel, act, dx):
  """x + dx on the state manifold, dx (B, ndx)."""
  nv = m.nv
  qp = fwd.integrate_pos(m, qpos, dx[:, :nv], 1.0)
  qv = qvel + dx[:, nv:2 * nv]
  a = act + dx[:, 2 * nv:] if m.na else act
  return qp, qv, a


def difference(m: Model, qpos0, qvel0, act0, qpos1, qvel1, act1):
  """x1 - x0 in tangent space (B, ndx)."""
  parts = [support.state_diff(m, qpos0, qpos1), qvel1 - qvel0]
  if m.na:
    parts.append(act1 - act0)
  return torch.cat(parts, -1)


def ground_truth_update(m: Model, template: Data, state: EstimatorState,
                        ctrl: torch.Tensor,
                        sensor: Optional[torch.Tensor] = None
                        ) -> EstimatorState:
  """Step the state's copy of the physics (estimator.h:201-210)."""
  qpos, qvel, act, time = predict(m, template, state.qpos, state.qvel,
                                  state.act, state.time, ctrl)
  return state.replace(qpos=qpos, qvel=qvel, act=act, time=time)
