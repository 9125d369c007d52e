"""Physics Model and batch-first Data, as frozen dataclasses of tensors.

Port of mujoco_mpc_tpu/physics/model.py (enums :31-79, Option :87, Model
:110, Data :318, make_data :822). The MJCF compiler `put_model` (:397)
needs the `mujoco` package, which the GPU machine does not have; the port
builds its Model from arrays instead (`from_arrays`), exported from the
JAX package's compiled Model (tools/export_torch_snapshot.py) or handed
over by tests.

Differences from the JAX pytrees:
  * Data is batch-first: every field has a leading batch dimension B (an
    unbatched JAX call is B = 1 here). Model fields carry no batch.
  * Static structure stays as Python ints and tuples; the masks and
    gathers the step indexes with are built once, on the model's device,
    into `Model.idx` (physics/structure.py).

Model fields not carried yet (their consumers are still to be ported;
ROADMAP A6-A8): collision and geom contact parameters (geom_type,
geom_contype/conaffinity/condim/priority, geom_size, geom_friction,
geom_solref/solimp/margin/gap/solmix, geom_mesh, geom_hfield,
contact_point_cap, contact_cap), body_invweight0, frictionloss rows
(dof_frictionloss, dof_friction_solref/solimp), equality data (eq_*),
tendons (ten_*, tendon_*), sensors (sensor_*, nsensordata), site_size,
site_type, magnetic-field consumers and the name tables other than
bodies, joints, sites, actuators and keyframes. Data fields not carried
yet: sensordata and the tendon quantities. A model that needs any of them
is refused where it would be used (NotImplementedError), never silently
computed without them.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

import numpy as np
import torch

from mujoco_mpc_tpu_torch.physics import structure


class JointType(enum.IntEnum):
  FREE = 0
  BALL = 1
  SLIDE = 2
  HINGE = 3


class IntegratorType(enum.IntEnum):
  EULER = 0
  RK4 = 1
  IMPLICITFAST = 2


class TrnType(enum.IntEnum):
  JOINT = 0
  JOINTINPARENT = 1
  SLIDERCRANK = 2
  TENDON = 3
  SITE = 4
  BODY = 5


class DynType(enum.IntEnum):
  NONE = 0
  INTEGRATOR = 1
  FILTER = 2
  FILTEREXACT = 3


class GainType(enum.IntEnum):
  FIXED = 0
  AFFINE = 1


class BiasType(enum.IntEnum):
  NONE = 0
  AFFINE = 1


class _Replace:
  """`replace(**changes)` for frozen dataclasses."""

  def replace(self, **changes):
    return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class Option(_Replace):
  """Simulation options; floats are 0-d or (3,) tensors."""
  timestep: torch.Tensor
  gravity: torch.Tensor
  wind: torch.Tensor
  magnetic: torch.Tensor
  density: torch.Tensor
  viscosity: torch.Tensor
  integrator: int = int(IntegratorType.EULER)
  iterations: int = 100
  cone: int = 0
  noslip_iterations: int = 0


# Static (Python int / tuple) fields of Model, in from_arrays' `static` dict.
STATIC_FIELDS = (
    'nq', 'nv', 'nu', 'na', 'nbody', 'njnt', 'ngeom', 'nsite', 'nmocap',
    'ntendon', 'neq',
    'body_parentid', 'body_rootid', 'body_jntadr', 'body_jntnum',
    'body_dofadr', 'body_dofnum', 'body_mocapid', 'jnt_type', 'jnt_qposadr',
    'jnt_dofadr', 'jnt_bodyid', 'jnt_limited', 'dof_bodyid', 'dof_jntid',
    'dof_parentid', 'geom_bodyid', 'site_bodyid', 'collision_pairs',
    'tendon_limited', 'friction_dof',
    'actuator_trntype', 'actuator_dyntype', 'actuator_gaintype',
    'actuator_biastype', 'actuator_trnid', 'actuator_actadr',
    'actuator_actnum', 'actuator_ctrllimited', 'actuator_forcelimited',
    'has_fluid', 'any_gravcomp',
    'body_names', 'joint_names', 'site_names', 'actuator_names',
    'keyframe_names',
)
# Static fields of Option, stored in `static` as 'opt.<name>'.
OPTION_STATIC = ('integrator', 'iterations', 'cone', 'noslip_iterations')
# Tensor fields of Option, stored in `arrays` as 'opt.<name>'.
OPTION_ARRAYS = ('timestep', 'gravity', 'wind', 'magnetic', 'density',
                 'viscosity')
# Tensor fields of Model, in from_arrays' `arrays` dict.
ARRAY_FIELDS = (
    'qpos0', 'qpos_spring', 'body_pos', 'body_quat', 'body_ipos',
    'body_iquat', 'body_mass', 'body_gravcomp', 'body_inertia', 'jnt_pos',
    'jnt_axis', 'jnt_stiffness', 'jnt_range', 'jnt_solref', 'jnt_solimp',
    'jnt_margin', 'dof_damping', 'dof_armature', 'dof_invweight0',
    'geom_pos', 'geom_quat', 'site_pos', 'site_quat', 'actuator_gear',
    'actuator_dynprm', 'actuator_gainprm', 'actuator_biasprm',
    'actuator_ctrlrange', 'actuator_forcerange', 'act_range',
    'dof_ancestor_mask', 'key_qpos', 'key_qvel', 'key_act', 'key_ctrl',
)


@dataclasses.dataclass(frozen=True)
class Model(_Replace):
  """Physics model: static structure, tensor leaves and device indices."""
  # sizes
  nq: int
  nv: int
  nu: int
  na: int
  nbody: int
  njnt: int
  ngeom: int
  nsite: int
  nmocap: int
  ntendon: int
  neq: int
  # tree structure
  body_parentid: Tuple[int, ...]
  body_rootid: Tuple[int, ...]
  body_jntadr: Tuple[int, ...]
  body_jntnum: Tuple[int, ...]
  body_dofadr: Tuple[int, ...]
  body_dofnum: Tuple[int, ...]
  body_mocapid: Tuple[int, ...]
  jnt_type: Tuple[int, ...]
  jnt_qposadr: Tuple[int, ...]
  jnt_dofadr: Tuple[int, ...]
  jnt_bodyid: Tuple[int, ...]
  jnt_limited: Tuple[int, ...]
  dof_bodyid: Tuple[int, ...]
  dof_jntid: Tuple[int, ...]
  dof_parentid: Tuple[int, ...]
  geom_bodyid: Tuple[int, ...]
  site_bodyid: Tuple[int, ...]
  collision_pairs: Tuple[Tuple[int, int], ...]
  tendon_limited: Tuple[int, ...]
  friction_dof: Tuple[int, ...]
  actuator_trntype: Tuple[int, ...]
  actuator_dyntype: Tuple[int, ...]
  actuator_gaintype: Tuple[int, ...]
  actuator_biastype: Tuple[int, ...]
  actuator_trnid: Tuple[int, ...]
  actuator_actadr: Tuple[int, ...]
  actuator_actnum: Tuple[int, ...]
  actuator_ctrllimited: Tuple[int, ...]
  actuator_forcelimited: Tuple[int, ...]
  has_fluid: bool
  any_gravcomp: bool
  body_names: Tuple[str, ...]
  joint_names: Tuple[str, ...]
  site_names: Tuple[str, ...]
  actuator_names: Tuple[str, ...]
  keyframe_names: Tuple[str, ...]
  # tensors
  qpos0: torch.Tensor
  qpos_spring: torch.Tensor
  body_pos: torch.Tensor
  body_quat: torch.Tensor
  body_ipos: torch.Tensor
  body_iquat: torch.Tensor
  body_mass: torch.Tensor
  body_gravcomp: torch.Tensor
  body_inertia: torch.Tensor
  jnt_pos: torch.Tensor
  jnt_axis: torch.Tensor
  jnt_stiffness: torch.Tensor
  jnt_range: torch.Tensor
  jnt_solref: torch.Tensor
  jnt_solimp: torch.Tensor
  jnt_margin: torch.Tensor
  dof_damping: torch.Tensor
  dof_armature: torch.Tensor
  dof_invweight0: torch.Tensor
  geom_pos: torch.Tensor
  geom_quat: torch.Tensor
  site_pos: torch.Tensor
  site_quat: torch.Tensor
  actuator_gear: torch.Tensor
  actuator_dynprm: torch.Tensor
  actuator_gainprm: torch.Tensor
  actuator_biasprm: torch.Tensor
  actuator_ctrlrange: torch.Tensor
  actuator_forcerange: torch.Tensor
  act_range: torch.Tensor
  dof_ancestor_mask: torch.Tensor
  key_qpos: torch.Tensor
  key_qvel: torch.Tensor
  key_act: torch.Tensor
  key_ctrl: torch.Tensor
  opt: Option
  idx: structure.Indices

  @property
  def device(self) -> torch.device:
    return self.qpos0.device

  @property
  def dtype(self) -> torch.dtype:
    return self.qpos0.dtype

  def to(self, device) -> 'Model':
    """The same model with every tensor (indices included) on `device`."""
    return structure.tree_to(self, torch.device(device))

  def keyframe_qpos(self, name: str) -> torch.Tensor:
    return self.key_qpos[self.keyframe_names.index(name)]


def from_arrays(arrays: dict, static: dict, device='cpu',
                dtype=torch.float32) -> Model:
  """Build a Model from numpy arrays and static fields.

  arrays: ARRAY_FIELDS plus 'opt.<OPTION_ARRAYS>' -> numpy arrays (the
  JAX Model's leaves); static: STATIC_FIELDS plus 'opt.<OPTION_STATIC>'
  -> ints, bools, strings or (nested) sequences of them."""
  device = torch.device(device)

  def tup(v):
    if isinstance(v, (list, tuple)):
      return tuple(tup(x) for x in v)
    return v

  s = {k: tup(static[k]) for k in STATIC_FIELDS}
  t = {}
  for k in ARRAY_FIELDS:
    a = np.array(arrays[k])   # a copy: the source may be read-only
    t[k] = torch.as_tensor(a, device=device,
                           dtype=torch.bool if a.dtype == bool else dtype)
  opt = Option(
      **{k: torch.as_tensor(np.array(arrays['opt.' + k]), dtype=dtype,
                            device=device) for k in OPTION_ARRAYS},
      **{k: int(static['opt.' + k]) for k in OPTION_STATIC})
  return Model(**s, **t, opt=opt,
               idx=structure.build_indices(s, device, dtype))


@dataclasses.dataclass(frozen=True)
class Data(_Replace):
  """Batch-first simulation state and computed quantities.

  State fields are always set; computed fields are None until the stage
  that computes them has run (JAX's make_data zero-fills them instead)."""
  # state
  time: torch.Tensor           # (B,)
  qpos: torch.Tensor           # (B, nq)
  qvel: torch.Tensor           # (B, nv)
  act: torch.Tensor            # (B, na)
  ctrl: torch.Tensor           # (B, nu)
  qfrc_applied: torch.Tensor   # (B, nv)
  xfrc_applied: torch.Tensor   # (B, nbody, 6)
  mocap_pos: torch.Tensor      # (B, nmocap, 3)
  mocap_quat: torch.Tensor     # (B, nmocap, 4)
  userdata: torch.Tensor       # (B, nuserdata)
  # kinematics
  xpos: Optional[torch.Tensor] = None
  xquat: Optional[torch.Tensor] = None
  xmat: Optional[torch.Tensor] = None
  xipos: Optional[torch.Tensor] = None
  ximat: Optional[torch.Tensor] = None
  xanchor: Optional[torch.Tensor] = None
  xaxis: Optional[torch.Tensor] = None
  geom_xpos: Optional[torch.Tensor] = None
  geom_xmat: Optional[torch.Tensor] = None
  site_xpos: Optional[torch.Tensor] = None
  site_xmat: Optional[torch.Tensor] = None
  # com_pos / com_vel
  subtree_com: Optional[torch.Tensor] = None
  cinert: Optional[torch.Tensor] = None
  cdof: Optional[torch.Tensor] = None
  cvel: Optional[torch.Tensor] = None
  cdof_dot: Optional[torch.Tensor] = None
  # dynamics
  qM: Optional[torch.Tensor] = None
  qfrc_bias: Optional[torch.Tensor] = None
  qfrc_passive: Optional[torch.Tensor] = None
  qfrc_constraint: Optional[torch.Tensor] = None
  actuator_length: Optional[torch.Tensor] = None
  actuator_velocity: Optional[torch.Tensor] = None
  actuator_force: Optional[torch.Tensor] = None
  actuator_moment: Optional[torch.Tensor] = None
  qfrc_actuator: Optional[torch.Tensor] = None
  qfrc_smooth: Optional[torch.Tensor] = None
  qacc: Optional[torch.Tensor] = None
  act_dot: Optional[torch.Tensor] = None

  @property
  def batch(self) -> int:
    return self.qpos.shape[0]

  def expand(self, batch: int) -> 'Data':
    """Broadcast a B = 1 state to `batch` samples (views, no copies; the
    physics never writes into Data tensors in place)."""
    return self.replace(**{
        f.name: getattr(self, f.name).expand(
            (batch,) + tuple(getattr(self, f.name).shape[1:]))
        for f in dataclasses.fields(self)
        if getattr(self, f.name) is not None})


NUSERDATA = 16


def make_data(m: Model, batch: int = 1) -> Data:
  """Fresh state at qpos0 with zero velocity (mj_makeData + mj_resetData),
  batch copies; mocap bodies start at their model frame."""
  kw = dict(device=m.device, dtype=m.dtype)
  z = lambda *shape: torch.zeros((batch,) + shape, **kw)  # noqa: E731
  mocap_pos = z(m.nmocap, 3)
  mocap_quat = z(m.nmocap, 4)
  for b in range(m.nbody):
    i = m.body_mocapid[b]
    if i >= 0:
      mocap_pos[:, i] = m.body_pos[b]
      mocap_quat[:, i] = m.body_quat[b]
  return Data(
      time=z(), qpos=m.qpos0.expand(batch, m.nq).clone(), qvel=z(m.nv),
      act=z(m.na), ctrl=z(m.nu), qfrc_applied=z(m.nv),
      xfrc_applied=z(m.nbody, 6), mocap_pos=mocap_pos,
      mocap_quat=mocap_quat, userdata=z(NUSERDATA))
