"""Task framework: residual functions, weighted norm costs, risk transform.

Port of mujoco_mpc_tpu/tasks/base.py (TaskParams :37, TaskSpec :51,
cost_terms :76, cost :89). The TaskSpec here holds no `mj_model`: the
compiled model travels as arrays (convert.py), and the MJCF parsers
parse_user_sensors / parse_custom_numerics (:100, :134), which need
`mujoco`, stay on the JAX side of tools/export_torch_snapshot.py.
Residual functions are batch-first: (Model, Data, residual_params) ->
(B, num_residual). A transition (TransitionFn, :46) updates the B = 1
simulation state and the task parameters once per plan.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from mujoco_mpc_tpu_torch.ops import norms
from mujoco_mpc_tpu_torch.physics.model import Data, Model

# reference: task.h:29
RISK_NEUTRAL_TOLERANCE = 1.0e-6
# reference: task.h:32
MAX_NORM_PARAMS = 3


@dataclasses.dataclass(frozen=True)
class TaskParams:
  """Tunable task parameters."""
  weights: torch.Tensor          # (num_term,)
  norm_params: torch.Tensor      # (num_term, MAX_NORM_PARAMS)
  residual_params: torch.Tensor  # (n_residual_params,)
  risk: torch.Tensor             # ()

  def replace(self, **changes) -> 'TaskParams':
    return dataclasses.replace(self, **changes)


ResidualFn = Callable[[Model, Data, torch.Tensor], torch.Tensor]
# (Model, Data with B = 1, TaskParams, torch.Generator) -> (Data, TaskParams)
TransitionFn = Callable[[Model, Data, TaskParams, torch.Generator],
                        Tuple[Data, TaskParams]]


@dataclasses.dataclass(frozen=True)
class TaskSpec:
  """Static task definition."""
  name: str
  model: Model
  term_names: Tuple[str, ...]
  norm_types: Tuple[int, ...]
  term_dims: Tuple[int, ...]
  residual_fn: ResidualFn
  default_params: TaskParams
  config: Dict[str, float]
  transition_fn: Optional[TransitionFn] = None
  weight_ranges: Tuple[Tuple[float, float], ...] = ()
  residual_param_names: Tuple[str, ...] = ()
  residual_param_ranges: Tuple[Tuple[float, float], ...] = ()

  @property
  def num_term(self) -> int:
    return len(self.term_dims)

  @property
  def num_residual(self) -> int:
    return sum(self.term_dims)

  def cost_terms(self, residual: torch.Tensor, params: TaskParams,
                 weighted: bool = True) -> torch.Tensor:
    """Per-term norm costs (..., num_term)."""
    terms = []
    offset = 0
    for k in range(self.num_term):
      dim = self.term_dims[k]
      r = residual[..., offset:offset + dim]
      val = norms.norm_value(r, params.norm_params[k], self.norm_types[k])
      terms.append(params.weights[k] * val if weighted else val)
      offset += dim
    return torch.stack(terms, dim=-1)

  def cost(self, residual: torch.Tensor, params: TaskParams) -> torch.Tensor:
    """Total weighted cost with the exponential risk transform
    (reference: task.cc:91-110)."""
    c = torch.sum(self.cost_terms(residual, params), dim=-1)
    risk = params.risk
    neutral = torch.abs(risk) < RISK_NEUTRAL_TOLERANCE
    safe_risk = torch.where(neutral, torch.ones_like(risk), risk)
    transformed = (torch.exp(safe_risk * c) - 1.0) / safe_risk
    return torch.where(neutral, c, transformed)
