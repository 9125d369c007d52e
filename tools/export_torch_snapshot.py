"""Export a JAX task's compiled model and parameters for the PyTorch port.

Writes mujoco_mpc_tpu_torch/assets/<task>.npz (layout: see
mujoco_mpc_tpu_torch/convert.py) from mujoco_mpc_tpu.tasks.registry, which
compiles the task's MJCF with `mujoco`. The port loads these files where
neither JAX nor `mujoco` is installed. Run from the repository root after
changing a task's MJCF or the port's Model fields:

    python tools/export_torch_snapshot.py

tests/test_torch_package.py re-exports in memory and fails when a
committed snapshot is stale.
"""

from __future__ import annotations

import inspect
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
  sys.path.insert(0, ROOT)

from mujoco_mpc_tpu_torch.convert import PARAM_FIELDS  # noqa: E402
from mujoco_mpc_tpu_torch.physics import model as port_model  # noqa: E402
from mujoco_mpc_tpu_torch.tasks import registry as port_registry  # noqa: E402


def _jsonable(x):
  if isinstance(x, (list, tuple)):
    return [_jsonable(v) for v in x]
  if isinstance(x, np.ndarray):
    return _jsonable(x.tolist())
  if isinstance(x, (bool, np.bool_)):
    return bool(x)
  if isinstance(x, (int, np.integer)):
    return int(x)
  if isinstance(x, (float, np.floating)):
    return float(x)
  return x


def model_snapshot(m):
  """(arrays, static) of a JAX Model, as physics/model.py from_arrays
  takes them."""
  arrays = {k: np.asarray(getattr(m, k)) for k in port_model.ARRAY_FIELDS}
  arrays.update({'opt.' + k: np.asarray(getattr(m.opt, k))
                 for k in port_model.OPTION_ARRAYS})
  for g, hull in (m.geom_mesh or {}).items():
    arrays.update({f'geom_mesh/{int(g)}/{part}': np.asarray(a)
                   for part, a in zip(port_model.HULL_ARRAYS, hull)})
  static = {k: _jsonable(getattr(m, k)) for k in port_model.STATIC_FIELDS}
  static.update({'opt.' + k: int(getattr(m.opt, k))
                 for k in port_model.OPTION_STATIC})
  return arrays, static


def track_arrays(spec):
  """Humanoid Track's clip, which JAX keeps in its residual's closure
  (registry.py :1411-1433): the marker table as the residual holds it
  (float32), the clips' first frames and lengths, and in the CMU branch
  the marker sites."""
  res = inspect.getclosurevars(spec.residual_fn).nonlocals
  window = inspect.getclosurevars(res['_frames']).nonlocals
  out = {'markers': np.asarray(res['markers_j']),
         'starts': np.asarray(window['starts']),
         'lengths': np.asarray(window['lengths'])}
  if res['marker_sites'] is not None:
    out['marker_sites'] = np.asarray(res['marker_sites'])
  return out


# task name -> its arrays beside Model and TaskParams ('task/<name>')
TASK_ARRAYS = {'Humanoid Track': track_arrays}


def task_snapshot(spec):
  """(arrays, static) of a JAX TaskSpec (layout: convert.py)."""
  ma, ms = model_snapshot(spec.model)
  arrays = {'model/' + k: v for k, v in ma.items()}
  arrays.update({'params/' + k: np.asarray(getattr(spec.default_params, k))
                 for k in PARAM_FIELDS})
  if spec.name in TASK_ARRAYS:
    arrays.update({'task/' + k: v
                   for k, v in TASK_ARRAYS[spec.name](spec).items()})
  static = {
      'name': spec.name,
      'model': ms,
      'task': {
          'term_names': list(spec.term_names),
          'norm_types': _jsonable(spec.norm_types),
          'term_dims': _jsonable(spec.term_dims),
          'config': {k: _jsonable(v) for k, v in spec.config.items()},
          'weight_ranges': _jsonable(spec.weight_ranges),
          'residual_param_names': list(spec.residual_param_names),
          'residual_param_ranges': _jsonable(spec.residual_param_ranges),
      },
  }
  return arrays, json.loads(json.dumps(static, sort_keys=True))


def write(path: str, arrays: dict, static: dict) -> None:
  np.savez(path, static=np.asarray(json.dumps(static, sort_keys=True)),
           **arrays)


def main():
  from mujoco_mpc_tpu.tasks import registry
  for name, (fname, _) in port_registry.TASKS.items():
    path = os.path.join(port_registry.ASSETS, fname)
    write(path, *task_snapshot(registry.get_task(name)))
    print(f'wrote {os.path.relpath(path, ROOT)} '
          f'({os.path.getsize(path)} bytes)')


if __name__ == '__main__':
  main()
