"""Build the port's Model, TaskParams and TaskSpec from numpy arrays.

The JAX package compiles MJCF with `mujoco` (physics/model.py put_model
:397, tasks/base.py parse_user_sensors :100), and neither `mujoco` nor JAX
exists on the GPU machine. So the compiled model and the task's numeric
parts travel as data: the JAX Model's and TaskParams' leaves as numpy
arrays, plus a JSON-able dict of the static fields.
tools/export_torch_snapshot.py writes them (it may import JAX; this
module never does) into mujoco_mpc_tpu_torch/assets/<task>.npz.

Snapshot layout: arrays 'model/<field>' (physics/model.py ARRAY_FIELDS
and 'opt.<field>'), 'params/<field>' (TaskParams), 'task/<name>' (arrays
a task keeps beside its model and parameters, such as Humanoid Track's
marker clip; tasks/registry.py hands them to the task's maker), and
'static', one JSON string: {'name', 'model': {static Model fields},
'task': {term_names, norm_types, term_dims, config, weight_ranges,
residual_param_names, residual_param_ranges}}.

`ilqg_state_from_arrays` carries the JAX package's iLQG planner state
(planners/ilqg.py ILQGState and ILQGPolicy, as numpy arrays) across, so
both packages can start an iteration from the same policy;
`cem_state_from_arrays`, `sg_state_from_arrays` and
`ilqs_state_from_arrays` do the same for Cross Entropy's, Sample
Gradient's and iLQS's states, and `estimator_state_from_arrays` and
`batch_state_from_arrays` for the estimators' (estimators/base.py
EstimatorState, estimators/batch.py BatchState), so that both packages
start an update from the same filter state.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from mujoco_mpc_tpu_torch.estimators import base as est_base
from mujoco_mpc_tpu_torch.estimators import batch as est_batch
from mujoco_mpc_tpu_torch.physics import model as model_lib
from mujoco_mpc_tpu_torch.planners import (cross_entropy, ilqg, ilqs,
                                           sample_gradient, sampling)
from mujoco_mpc_tpu_torch.tasks import base

PARAM_FIELDS = ('weights', 'norm_params', 'residual_params', 'risk')
ILQG_STATE_FIELDS = ('regularization', 'regularization_factor',
                     'previous_return', 'expected_dv')


def model_from_arrays(arrays: dict, static: dict, device='cuda',
                      dtype=torch.float32) -> model_lib.Model:
  """Model from its leaves (numpy) and static fields (see
  physics/model.py from_arrays)."""
  return model_lib.from_arrays(arrays, static, device=device, dtype=dtype)


def params_from_arrays(arrays: dict, device='cuda',
                       dtype=torch.float32) -> base.TaskParams:
  """TaskParams from {'weights', 'norm_params', 'residual_params',
  'risk'} numpy arrays."""
  device = model_lib.resolve_device(device)
  return base.TaskParams(**{
      k: torch.as_tensor(np.array(arrays[k]), dtype=dtype, device=device)
      for k in PARAM_FIELDS})


def group(arrays: dict, prefix: str) -> dict:
  """The snapshot arrays under `prefix` ('model/', 'params/', 'task/'),
  keyed by their names without it."""
  return {k[len(prefix):]: v for k, v in arrays.items()
          if k.startswith(prefix)}


def spec_from_arrays(arrays: dict, static: dict, residual_fn, device='cuda',
                     dtype=torch.float32) -> base.TaskSpec:
  """TaskSpec from a snapshot's arrays and static dict (layout above)."""
  task = static['task']
  tup = lambda xs: tuple(tuple(x) for x in xs)  # noqa: E731
  return base.TaskSpec(
      name=static['name'],
      model=model_from_arrays(group(arrays, 'model/'), static['model'],
                              device, dtype),
      term_names=tuple(task['term_names']),
      norm_types=tuple(task['norm_types']),
      term_dims=tuple(task['term_dims']),
      residual_fn=residual_fn,
      default_params=params_from_arrays(group(arrays, 'params/'), device,
                                        dtype),
      config=dict(task['config']),
      weight_ranges=tup(task['weight_ranges']),
      residual_param_names=tuple(task['residual_param_names']),
      residual_param_ranges=tup(task['residual_param_ranges']))


def load_snapshot(path: str):
  """(arrays, static) of a snapshot file written by
  tools/export_torch_snapshot.py."""
  with np.load(path, allow_pickle=False) as z:
    arrays = {k: z[k] for k in z.files if k != 'static'}
    static = json.loads(str(z['static']))
  return arrays, static


def ilqg_state_from_arrays(policy: dict, state: dict, device='cuda',
                           dtype=torch.float32) -> ilqg.ILQGState:
  """ILQGState from the numpy leaves of a JAX ILQGPolicy (`policy`, keyed
  by the fields of ilqg.ILQGPolicy) and of the ILQGState around it
  (`state`, keyed by ILQG_STATE_FIELDS)."""
  device = model_lib.resolve_device(device)

  def t(x):
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)
  return ilqg.ILQGState(
      policy=ilqg.ILQGPolicy(**{
          f.name: t(policy[f.name])
          for f in dataclasses.fields(ilqg.ILQGPolicy)}),
      **{k: t(state[k]) for k in ILQG_STATE_FIELDS})



def _tensor(x, device, dtype):
  return torch.as_tensor(np.array(x), dtype=dtype,
                         device=model_lib.resolve_device(device))


def sampling_policy_from_arrays(policy: dict, device='cuda',
                                dtype=torch.float32) -> sampling.SamplingPolicy:
  """SamplingPolicy from {'times', 'values'} numpy arrays."""
  return sampling.SamplingPolicy(times=_tensor(policy['times'], device, dtype),
                                 values=_tensor(policy['values'], device,
                                                dtype))


def cem_state_from_arrays(policy: dict, variance, device='cuda',
                          dtype=torch.float32) -> cross_entropy.CEMState:
  """CEMState from a JAX CEMState's leaves: its policy's {'times',
  'values'} and its variance."""
  return cross_entropy.CEMState(
      policy=sampling_policy_from_arrays(policy, device, dtype),
      variance=_tensor(variance, device, dtype))


def sg_state_from_arrays(policy: dict, gradient, gradient_prev,
                         device='cuda',
                         dtype=torch.float32) -> sample_gradient.SGState:
  """SGState from a JAX SGState's leaves."""
  return sample_gradient.SGState(
      policy=sampling_policy_from_arrays(policy, device, dtype),
      gradient=_tensor(gradient, device, dtype),
      gradient_prev=_tensor(gradient_prev, device, dtype))


def ilqs_state_from_arrays(sampling_policy: dict, ilqg_policy: dict,
                           ilqg_state: dict, active, device='cuda',
                           dtype=torch.float32) -> ilqs.ILQSState:
  """ILQSState from a JAX ILQSState's leaves: its sampling policy's
  {'times', 'values'}, its iLQG state's policy and fields (as
  ilqg_state_from_arrays takes them) and `active`."""
  return ilqs.ILQSState(
      sampling_policy=sampling_policy_from_arrays(sampling_policy, device,
                                                  dtype),
      ilqg_state=ilqg_state_from_arrays(ilqg_policy, ilqg_state, device,
                                        dtype),
      active=_tensor(active, device, torch.int32))


def estimator_state_from_arrays(state: dict, device='cuda',
                                dtype=torch.float32) -> est_base.EstimatorState:
  """EstimatorState from a JAX EstimatorState's leaves (numpy, keyed by
  its fields). JAX's state is one filter: its arrays gain the port's
  leading batch dimension (B = 1); arrays that already have it (qpos of
  rank 2) are taken as they are."""
  one = np.ndim(state['qpos']) == 1
  return est_base.EstimatorState(**{
      f.name: _tensor(np.asarray(state[f.name])[None] if one
                      else state[f.name], device, dtype)
      for f in dataclasses.fields(est_base.EstimatorState)})


def batch_state_from_arrays(state: dict, device='cuda',
                            dtype=torch.float32) -> est_batch.BatchState:
  """BatchState from a JAX BatchState's leaves (numpy, keyed by its
  fields); both hold one window."""
  return est_batch.BatchState(**{
      f.name: _tensor(state[f.name], device,
                      torch.int32 if f.name == 'filled' else dtype)
      for f in dataclasses.fields(est_batch.BatchState)})
