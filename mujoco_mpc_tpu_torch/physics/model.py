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

The geom contact fields (geom_type, geom_contype/conaffinity/condim/
priority/group, geom_size, geom_friction, geom_solref/solimp/solmix/
margin/gap, body_invweight0, geom_names, contact_point_cap, contact_cap)
are carried for the colliders (physics/collision.py); the sensor fields
(nsensordata, sensor_type/objtype/objid/adr/dim/names, :182-189), the
touch zones' site_type and site_size (:163, :240) and the magnetic field
(Option.magnetic) for physics/sensors.py, and so are the
convex hulls of the mesh, cylinder and ellipsoid geoms (geom_mesh, :255,
built by put_model at :569-620 and kept as JAX keeps them, float32
values, promoted to the model's dtype), the height fields (geom_hfield,
:258, built at :622-632: each hfield geom's elevation grid and size, the
same float32 values promoted), the site transmissions' reference sites
(actuator_refid), the frictionloss
rows' constants (dof_frictionloss, dof_friction_solref/solimp, :225-228,
one entry per dof of friction_dof), the tendons (ten_moment, ten_qmat,
ten_length0, the static wrap plan ten_spatial, tendon_*; :276-291), the
equality constraints (eq_type, eq_obj1id/obj2id, eq_active0, eq_data,
eq_solref/solimp; :161-165, :272-274) and gravity compensation
(body_gravcomp, any_gravcomp). A snapshot carries the tendon and equality
fields only where the model has them; from_arrays fills them in empty
elsewhere. JAX's put_model refuses tendon frictionloss (:439-443) before
a model is exported; from_arrays refuses, as put_model does (:546-553),
a tendon equality on a spatial tendon, and (:397-421) a sensor type outside
sensors.SUPPORTED_SENSORS; a supported sensor whose physics the port
lacks (force sensors over elliptic cones) raises where it is evaluated.
Data fields not carried: sensordata (physics/sensors.py sensordata
returns it). A model that needs what the port lacks is refused where it
would be used (NotImplementedError), never silently computed without it.

Entry points build on the card: `device` defaults to 'cuda' and raises
when there is none (`resolve_device`); the tests ask for 'cpu'.
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


class GeomType(enum.IntEnum):
  PLANE = 0
  HFIELD = 1
  SPHERE = 2
  CAPSULE = 3
  ELLIPSOID = 4
  CYLINDER = 5
  BOX = 6
  MESH = 7
  OTHER = 100


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
  """`replace(**changes)` for frozen dataclasses: dataclasses.replace's
  result (the fields copied, `changes` set), without its per-field
  __init__ (a step replaces Data fields some hundred times)."""

  def replace(self, **changes):
    unknown = changes.keys() - self.__dataclass_fields__.keys()
    if unknown:
      raise TypeError(f'{type(self).__name__} has no fields '
                      f'{sorted(unknown)}')
    new = object.__new__(type(self))
    new.__dict__.update(self.__dict__, **changes)
    return new


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
    'geom_type', 'geom_contype', 'geom_conaffinity', 'geom_condim',
    'geom_priority', 'geom_group', 'contact_point_cap', 'contact_cap',
    'tendon_limited', 'friction_dof',
    'actuator_trntype', 'actuator_dyntype', 'actuator_gaintype',
    'actuator_biastype', 'actuator_trnid', 'actuator_actadr',
    'actuator_actnum', 'actuator_ctrllimited', 'actuator_forcelimited',
    'has_fluid', 'any_gravcomp', 'site_type',
    'nsensordata', 'sensor_type', 'sensor_objtype', 'sensor_objid',
    'sensor_adr', 'sensor_dim', 'sensor_names',
    'body_names', 'joint_names', 'geom_names', 'site_names',
    'actuator_names', 'keyframe_names',
)
# Static fields of Option, stored in `static` as 'opt.<name>'.
OPTION_STATIC = ('integrator', 'iterations', 'cone', 'noslip_iterations')
# Tensor fields of Option, stored in `arrays` as 'opt.<name>'.
OPTION_ARRAYS = ('timestep', 'gravity', 'wind', 'magnetic', 'density',
                 'viscosity')
# The arrays of one convex hull in Model.geom_mesh, in from_arrays' `arrays`
# dict as 'geom_mesh/<geom id>/<name>'.
HULL_ARRAYS = ('verts', 'normals', 'offsets')
# The arrays of one height field in Model.geom_hfield, in from_arrays'
# `arrays` dict as 'geom_hfield/<geom id>/<name>': the elevation grid
# (nrow, ncol) in [0, 1] and the size (4,) = (radius_x, radius_y, z_top,
# z_bottom).
HFIELD_ARRAYS = ('grid', 'size')
# Static fields of the tendons and the equality constraints, in `static`
# only where ntendon > 0 or neq > 0 (empty tuples otherwise).
# ten_spatial is JAX's static wrap plan: per tendon () for a fixed one, or
# ((divisor, elements), ...) branches, each element ('s', site) or ('g',
# geom, kind 0 sphere / 1 cylinder, side site or -1).
TENDON_STATIC = ('tendon_names', 'ten_spatial')
EQ_STATIC = ('eq_type', 'eq_obj1id', 'eq_obj2id', 'eq_active0')
# Tensor fields of the tendons, (ntendon, ...), and of the equality
# constraints, (neq, ...), with their trailing shapes ('nv' and 'nq' stand
# for the model's sizes): in `arrays` only where ntendon > 0 or neq > 0.
TENDON_ARRAYS = {'ten_moment': ('nv',), 'ten_qmat': ('nq',),
                 'ten_length0': (), 'tendon_stiffness': (),
                 'tendon_damping': (), 'tendon_lengthspring': (2,),
                 'tendon_range': (2,), 'tendon_margin': (),
                 'tendon_solref_lim': (2,), 'tendon_solimp_lim': (5,),
                 'tendon_invweight0': ()}
EQ_ARRAYS = {'eq_data': (11,), 'eq_solref': (2,), 'eq_solimp': (5,)}
# The frictionloss rows' constants, (F,), (F, 2) and (F, 5) for the F dofs
# of friction_dof: in a snapshot only where F > 0, empty otherwise.
FRICTION_ARRAYS = {'dof_frictionloss': (), 'dof_friction_solref': (2,),
                   'dof_friction_solimp': (5,)}
# Tensor fields of Model, in from_arrays' `arrays` dict.
ARRAY_FIELDS = (
    'qpos0', 'qpos_spring', 'body_pos', 'body_quat', 'body_ipos',
    'body_iquat', 'body_mass', 'body_gravcomp', 'body_inertia', 'jnt_pos',
    'jnt_axis', 'jnt_stiffness', 'jnt_range', 'jnt_solref', 'jnt_solimp',
    'jnt_margin', 'dof_damping', 'dof_armature', 'dof_invweight0',
    'geom_pos', 'geom_quat', 'geom_size', 'geom_friction', 'geom_solref',
    'geom_solimp', 'geom_solmix', 'geom_margin', 'geom_gap',
    'body_invweight0', 'site_pos', 'site_quat', 'site_size', 'actuator_gear',
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
  geom_type: Tuple[int, ...]
  geom_contype: Tuple[int, ...]
  geom_conaffinity: Tuple[int, ...]
  geom_condim: Tuple[int, ...]
  geom_priority: Tuple[int, ...]
  geom_group: Tuple[int, ...]
  contact_point_cap: int
  contact_cap: int
  tendon_limited: Tuple[int, ...]
  friction_dof: Tuple[int, ...]
  actuator_trntype: Tuple[int, ...]
  actuator_dyntype: Tuple[int, ...]
  actuator_gaintype: Tuple[int, ...]
  actuator_biastype: Tuple[int, ...]
  actuator_trnid: Tuple[int, ...]
  actuator_refid: Tuple[int, ...]     # a site transmission's reference site
  actuator_actadr: Tuple[int, ...]
  actuator_actnum: Tuple[int, ...]
  actuator_ctrllimited: Tuple[int, ...]
  actuator_forcelimited: Tuple[int, ...]
  tendon_names: Tuple[str, ...]
  ten_spatial: tuple                   # the spatial tendons' wrap plan
  eq_type: Tuple[int, ...]             # mjtEq: 0 connect, 1 weld, 2 joint,
  eq_obj1id: Tuple[int, ...]           # 3 tendon
  eq_obj2id: Tuple[int, ...]
  eq_active0: Tuple[int, ...]
  has_fluid: bool
  any_gravcomp: bool
  site_type: Tuple[int, ...]           # mjtGeom: the touch sensors' zones
  # sensors (static; their values come from physics/sensors.py)
  nsensordata: int
  sensor_type: Tuple[int, ...]
  sensor_objtype: Tuple[int, ...]
  sensor_objid: Tuple[int, ...]
  sensor_adr: Tuple[int, ...]
  sensor_dim: Tuple[int, ...]
  sensor_names: Tuple[str, ...]
  body_names: Tuple[str, ...]
  joint_names: Tuple[str, ...]
  geom_names: Tuple[str, ...]
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
  geom_size: torch.Tensor
  geom_friction: torch.Tensor
  geom_solref: torch.Tensor
  geom_solimp: torch.Tensor
  geom_solmix: torch.Tensor
  geom_margin: torch.Tensor
  geom_gap: torch.Tensor
  body_invweight0: torch.Tensor
  site_pos: torch.Tensor
  site_quat: torch.Tensor
  site_size: torch.Tensor
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
  dof_frictionloss: torch.Tensor
  dof_friction_solref: torch.Tensor
  dof_friction_solimp: torch.Tensor
  ten_moment: torch.Tensor            # (ntendon, nv) fixed-tendon rows
  ten_qmat: torch.Tensor              # (ntendon, nq)
  ten_length0: torch.Tensor           # (ntendon,) lengths at qpos0
  tendon_stiffness: torch.Tensor
  tendon_damping: torch.Tensor
  tendon_lengthspring: torch.Tensor   # (ntendon, 2) deadband [lo, hi]
  tendon_range: torch.Tensor
  tendon_margin: torch.Tensor
  tendon_solref_lim: torch.Tensor
  tendon_solimp_lim: torch.Tensor
  tendon_invweight0: torch.Tensor
  eq_data: torch.Tensor               # (neq, 11)
  eq_solref: torch.Tensor             # (neq, 2)
  eq_solimp: torch.Tensor             # (neq, 5)
  opt: Option
  idx: structure.Indices
  # convex hulls, geom id -> (verts (V, 3), face normals (F, 3), face
  # offsets (F,)) in the geom frame, n.x + b <= 0 inside
  geom_mesh: dict = dataclasses.field(default_factory=dict)
  # height fields, geom id -> (elevation grid (nrow, ncol) in [0, 1], size
  # (4,) = (radius_x, radius_y, z_top, z_bottom))
  geom_hfield: dict = dataclasses.field(default_factory=dict)
  # per-condim contact groups of the collision pairs
  # (physics/constraint.py contact_table), built by from_arrays
  contact: tuple = ()
  # mesh-mesh clusters of dynamically selected rows (constraint.dyn_table)
  contact_dyn: tuple = ()

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

  def body(self, name: str) -> int:
    return self.body_names.index(name)

  def geom(self, name: str) -> int:
    return self.geom_names.index(name)

  def site(self, name: str) -> int:
    return self.site_names.index(name)


def resolve_device(device) -> torch.device:
  """`device` as a torch.device; a CUDA device must exist (no quiet
  fallback to the CPU)."""
  device = torch.device(device)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(
        'no CUDA device: the port runs on the GPU by default; pass '
        "device='cpu' to run on the CPU")
  return device


def from_arrays(arrays: dict, static: dict, device='cuda',
                dtype=torch.float32) -> Model:
  """Build a Model from numpy arrays and static fields.

  arrays: ARRAY_FIELDS plus 'opt.<OPTION_ARRAYS>' -> numpy arrays (the
  JAX Model's leaves), for each hull geom g 'geom_mesh/<g>/verts',
  '.../normals' and '.../offsets' (HULL_ARRAYS), for each height field g
  'geom_hfield/<g>/grid' and '.../size' (HFIELD_ARRAYS), and
  FRICTION_ARRAYS where friction_dof is not empty, TENDON_ARRAYS where
  ntendon > 0 and EQ_ARRAYS where neq > 0; static: STATIC_FIELDS (and
  'actuator_refid' where a site transmission has a reference site,
  TENDON_STATIC where ntendon > 0, EQ_STATIC where neq > 0)
  plus 'opt.<OPTION_STATIC>' -> ints, bools, strings or (nested)
  sequences of them."""
  device = resolve_device(device)

  def tup(v):
    if isinstance(v, (list, tuple)):
      return tuple(tup(x) for x in v)
    return v

  s = {k: tup(static[k]) for k in STATIC_FIELDS}
  # a snapshot carries the site transmissions' reference sites only where
  # one has a reference site; -1 (none) elsewhere
  s['actuator_refid'] = tup(static.get('actuator_refid', (-1,) * s['nu']))
  # the tendon and equality statics only where the model has them
  for k in TENDON_STATIC:
    s[k] = tup(static.get(k, ((),) * s['ntendon'] if k == 'ten_spatial'
                          else ('',) * s['ntendon']))
  for k in EQ_STATIC:
    s[k] = tup(static.get(k, (0,) * s['neq']))
  for e in range(s['neq']):
    spatial = [t for t in (s['eq_obj1id'][e], s['eq_obj2id'][e])
               if s['eq_type'][e] == 3 and t >= 0 and s['ten_spatial'][t]]
    if spatial:
      raise NotImplementedError(
          f'equality {e} couples spatial tendon {spatial[0]}; tendon '
          'equality constraints support fixed tendons only')
  from mujoco_mpc_tpu_torch.physics import sensors
  bad = [f'{name!r} (mjtSensor {t})'
         for name, t in zip(s['sensor_names'], s['sensor_type'])
         if t not in sensors.SUPPORTED_SENSORS]
  if bad:
    raise NotImplementedError(
        'unsupported sensor types (silent zeros would corrupt residuals '
        'and estimators): ' + ', '.join(bad))
  t = {}
  for k in ARRAY_FIELDS:
    a = np.array(arrays[k])   # a copy: the source may be read-only
    t[k] = torch.as_tensor(a, device=device,
                           dtype=torch.bool if a.dtype == bool else dtype)
  for k, shape in FRICTION_ARRAYS.items():
    a = (np.array(arrays[k]) if k in arrays
         else np.zeros((len(s['friction_dof']),) + shape))
    t[k] = torch.as_tensor(a, device=device, dtype=dtype)
  sizes = {'nv': s['nv'], 'nq': s['nq']}
  for fields, n in ((TENDON_ARRAYS, s['ntendon']), (EQ_ARRAYS, s['neq'])):
    for k, shape in fields.items():
      a = (np.array(arrays[k]) if k in arrays else
           np.zeros((n,) + tuple(sizes.get(x, x) for x in shape)))
      t[k] = torch.as_tensor(a, device=device, dtype=dtype)
  opt = Option(
      **{k: torch.as_tensor(np.array(arrays['opt.' + k]), dtype=dtype,
                            device=device) for k in OPTION_ARRAYS},
      **{k: int(static['opt.' + k]) for k in OPTION_STATIC})
  hulls = sorted({int(k.split('/')[1]) for k in arrays
                  if k.startswith('geom_mesh/')})
  geom_mesh = {g: tuple(
      torch.as_tensor(np.array(arrays[f'geom_mesh/{g}/{part}']),
                      dtype=dtype, device=device) for part in HULL_ARRAYS)
               for g in hulls}
  fields = sorted({int(k.split('/')[1]) for k in arrays
                   if k.startswith('geom_hfield/')})
  geom_hfield = {g: tuple(
      torch.as_tensor(np.array(arrays[f'geom_hfield/{g}/{part}']),
                      dtype=dtype, device=device) for part in HFIELD_ARRAYS)
                 for g in fields}
  m = Model(**s, **t, opt=opt, idx=structure.build_indices(s, device, dtype),
            geom_mesh=geom_mesh, geom_hfield=geom_hfield)
  if m.collision_pairs:
    from mujoco_mpc_tpu_torch.physics import constraint
    m = m.replace(contact=constraint.contact_table(m),
                  contact_dyn=constraint.dyn_table(m))
  return m


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
  # tendons (smooth.tendon)
  ten_length: Optional[torch.Tensor] = None     # (B, ntendon)
  ten_velocity: Optional[torch.Tensor] = None   # (B, ntendon)
  ten_J: Optional[torch.Tensor] = None          # (B, ntendon, nv)

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


def zero_filled(m: Model, d: Data) -> Data:
  """d with every computed field that is still None set to zeros, as JAX's
  make_data leaves them (model.py:853-884) on a state no stage has seen."""
  nb, nv, nu = m.nbody, m.nv, m.nu
  shapes = dict(
      xpos=(nb, 3), xquat=(nb, 4), xmat=(nb, 3, 3), xipos=(nb, 3),
      ximat=(nb, 3, 3), xanchor=(m.njnt, 3), xaxis=(m.njnt, 3),
      geom_xpos=(m.ngeom, 3), geom_xmat=(m.ngeom, 3, 3),
      site_xpos=(m.nsite, 3), site_xmat=(m.nsite, 3, 3),
      subtree_com=(nb, 3), cinert=(nb, 10), cdof=(nv, 6), cvel=(nb, 6),
      cdof_dot=(nv, 6), qM=(nv, nv), qfrc_bias=(nv,), qfrc_passive=(nv,),
      qfrc_constraint=(nv,), actuator_length=(nu,),
      actuator_velocity=(nu,), actuator_force=(nu,),
      actuator_moment=(nu, nv), qfrc_actuator=(nv,), qfrc_smooth=(nv,),
      qacc=(nv,), act_dot=(m.na,), ten_length=(m.ntendon,),
      ten_velocity=(m.ntendon,), ten_J=(m.ntendon, nv))
  return d.replace(**{
      k: torch.zeros((d.batch,) + s, device=m.device, dtype=m.dtype)
      for k, s in shapes.items() if getattr(d, k) is None})
