"""Sensor evaluation: MuJoCo's sensordata as a batch-first function.

Port of mujoco_mpc_tpu/physics/sensors.py (the mjtSensor values and
SUPPORTED_SENSORS :21-60, _object_frame :69, _point_vel :81, _cacc :87,
_cfrc_int :100, _inside_site :141, sensordata :160). JAX loops over the
sensors and writes each into the output; here the sensors of one type
are evaluated together, one gather over the batch for all of them, and
the output is one gather of their columns. The sensor plan (which
sensors, their frames, bodies and columns) is built once per model
structure and device (`_plan`).

The tendon sensors read smooth.tendon's ten_length and ten_velocity.
Raised where evaluated: the force, torque and touch sensors over
elliptic cones (constraint.contact_forces, ROADMAP A8). USER sensors read zero, as in JAX: the task
layer computes them.
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from mujoco_mpc_tpu_torch.physics import constraint
from mujoco_mpc_tpu_torch.physics import support
from mujoco_mpc_tpu_torch.physics.model import Data, Model
from mujoco_mpc_tpu_torch.utils import math as tm

# mjtSensor values
TOUCH = 0
ACCELEROMETER = 1
VELOCIMETER = 2
GYRO = 3
FORCE = 4
TORQUE = 5
MAGNETOMETER = 6
RANGEFINDER = 7
JOINTPOS = 9
JOINTVEL = 10
TENDONPOS = 11
TENDONVEL = 12
ACTUATORPOS = 13
ACTUATORVEL = 14
ACTUATORFRC = 15
BALLQUAT = 18
BALLANGVEL = 19
FRAMEPOS = 26
FRAMEQUAT = 27
FRAMEXAXIS = 28
FRAMEYAXIS = 29
FRAMEZAXIS = 30
FRAMELINVEL = 31
FRAMEANGVEL = 32
SUBTREECOM = 35
SUBTREELINVEL = 36
SUBTREEANGMOM = 37
CLOCK = 45
USER = 48

# every sensor type sensordata can evaluate; physics/model.py from_arrays
# refuses a model with any other
SUPPORTED_SENSORS = frozenset({
    TOUCH, FORCE, TORQUE,
    JOINTPOS, JOINTVEL, TENDONPOS, TENDONVEL, ACTUATORPOS, ACTUATORVEL,
    ACTUATORFRC, BALLQUAT, BALLANGVEL, FRAMEPOS, FRAMEQUAT, FRAMEXAXIS,
    FRAMEYAXIS, FRAMEZAXIS, FRAMELINVEL, FRAMEANGVEL, ACCELEROMETER,
    VELOCIMETER, GYRO, MAGNETOMETER, RANGEFINDER, SUBTREECOM,
    SUBTREELINVEL, SUBTREEANGMOM, CLOCK, USER,
})

# mjtObj values
OBJ_BODY = 1
OBJ_XBODY = 2
OBJ_GEOM = 5
OBJ_SITE = 6

# the types read at an object's frame (_object_frame)
_FRAME_TYPES = (FRAMEPOS, FRAMEQUAT, FRAMEXAXIS, FRAMEYAXIS, FRAMEZAXIS,
                FRAMELINVEL, FRAMEANGVEL, GYRO, MAGNETOMETER, VELOCIMETER,
                ACCELEROMETER)


class _Group(NamedTuple):
  """The sensors of one type: their ids, object ids, joint addresses
  (qpos for jointpos and ballquat, dof for jointvel and ballangvel, the
  object id otherwise), frame rows (into [sites; geoms; bodies' inertial
  frames; bodies' frames]), body ids, and output columns in order (each
  sensor's dim columns)."""
  sensors: Tuple[int, ...]
  objid: torch.Tensor
  adr: torch.Tensor
  rows: torch.Tensor
  bodies: torch.Tensor
  cols: Tuple[int, ...]


class _Plan(NamedTuple):
  groups: Dict[int, _Group]
  perm: torch.Tensor        # (nsensordata,) output column -> value column


def _object(m: Model, objtype: int, objid: int) -> Tuple[int, int]:
  """(frame row, body id) of a sensor's object (_object_frame): a site, a
  geom, a body's inertial frame or (any other objtype) its body frame."""
  if objtype == OBJ_SITE:
    return objid, m.site_bodyid[objid]
  if objtype == OBJ_GEOM:
    return m.nsite + objid, m.geom_bodyid[objid]
  if objtype == OBJ_BODY:
    return m.nsite + m.ngeom + objid, objid
  return m.nsite + m.ngeom + m.nbody + objid, objid


def _plan(m: Model) -> _Plan:
  return _plan_cached(m.sensor_type, m.sensor_objtype, m.sensor_objid,
                      m.sensor_adr, m.sensor_dim, m.site_bodyid,
                      m.geom_bodyid, m.jnt_qposadr, m.jnt_dofadr, m.nsite,
                      m.ngeom, m.nbody, m.nsensordata, m.device)


@functools.lru_cache(maxsize=64)
def _plan_cached(sensor_type, sensor_objtype, sensor_objid, sensor_adr,
                 sensor_dim, site_bodyid, geom_bodyid, jnt_qposadr,
                 jnt_dofadr, nsite, ngeom, nbody, nsensordata,
                 device) -> _Plan:
  stub = type('M', (), dict(site_bodyid=site_bodyid, geom_bodyid=geom_bodyid,
                            nsite=nsite, ngeom=ngeom, nbody=nbody))
  by_type: Dict[int, List[int]] = {}
  for s, t in enumerate(sensor_type):
    if t != USER:
      by_type.setdefault(t, []).append(s)
  li = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64),  # noqa: E731
                                 device=device)
  groups, order = {}, []
  for t, ss in by_type.items():
    objid = [sensor_objid[s] for s in ss]
    if t in (JOINTPOS, BALLQUAT):
      adr = [jnt_qposadr[j] for j in objid]
    elif t in (JOINTVEL, BALLANGVEL):
      adr = [jnt_dofadr[j] for j in objid]
    else:
      adr = objid
    frames = [_object(stub, sensor_objtype[s], sensor_objid[s]) for s in ss]
    cols = tuple(c for s in ss
                 for c in range(sensor_adr[s], sensor_adr[s] + sensor_dim[s]))
    groups[t] = _Group(tuple(ss), li(objid), li(adr),
                       li([f[0] for f in frames]), li([f[1] for f in frames]),
                       cols)
    order += cols
  perm = np.full(nsensordata, len(order), dtype=np.int64)   # zero column
  perm[np.asarray(order, dtype=np.int64)] = np.arange(len(order))
  return _Plan(groups, li(perm))


def _frames(m: Model, d: Data):
  """Positions (B, K, 3) and rotations (B, K, 3, 3) of every frame a
  sensor may read, in _object's row order."""
  pos = torch.cat([d.site_xpos, d.geom_xpos, d.xipos, d.xpos], 1)
  mat = torch.cat([d.site_xmat, d.geom_xmat, d.ximat, d.xmat], 1)
  return pos, mat


def _frame_quats(m: Model, d: Data, g: _Group) -> torch.Tensor:
  """Quaternions (B, k, 4) of a group's frames: the body's xquat times the
  object's offset (a site's, a geom's, the inertial frame's; none for a
  body frame)."""
  one = torch.zeros((1, 4), dtype=m.dtype, device=m.device)
  one[0, 0] = 1.0
  offsets = torch.cat([m.site_quat, m.geom_quat, m.body_iquat,
                       one.expand(m.nbody, 4)], 0)
  return tm.quat_mul(d.xquat[:, g.bodies], offsets[g.rows])


def _rot_t(mat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """mat^T v over leading dimensions: (..., 3, 3), (..., 3)."""
  return torch.einsum('...ji,...j->...i', mat, v)


def _point_vel(m: Model, d: Data, bodies: torch.Tensor, point: torch.Tensor):
  """Linear velocity (B, k, 3) of points (B, k, 3) on bodies (k,), and the
  bodies' angular velocities."""
  return (support.point_velocity(m, d, bodies, point),
          d.cvel[:, bodies, :3])


def _cacc(m: Model, d: Data) -> torch.Tensor:
  """Com-frame body accelerations (B, nbody, 6), gravity included
  (mj_rnePostConstraint): the sum over each body's ancestor dofs of
  cdof_dot qvel + cdof qacc, where JAX accumulates body by body."""
  base = torch.cat([torch.zeros_like(m.opt.gravity), -m.opt.gravity])
  acc = d.cdof_dot * d.qvel[..., None] + d.cdof * d.qacc[..., None]
  return base + m.idx.a_body @ acc


def _cfrc_int(m: Model, d: Data) -> torch.Tensor:
  """Interaction wrench (B, nbody, 6) of each body with its parent
  (mj_rnePostConstraint cfrc_int), (torque, force) about the subtree com
  of the body's root: the subtree sum of I a + v x* I v - f_ext, with
  f_ext the applied body wrenches and the decoded contact wrenches.
  Equality wrenches are not folded in, as in JAX."""
  cacc = _cacc(m, d)
  iv = tm.inert_vec(d.cinert, d.cvel)
  cfrc_body = tm.inert_vec(d.cinert, cacc) + tm.force_cross(d.cvel, iv)

  rootid = m.idx.body_rootid
  com_root = d.subtree_com[:, rootid]
  xf = d.xfrc_applied
  rot = xf[..., 3:] + tm.cross(d.xipos - com_root, xf[..., :3])
  cfrc_ext = torch.cat([rot, xf[..., :3]], -1)

  cf = constraint.contact_forces(m, d)
  if cf is not None:
    fw = torch.einsum('bprx,bpr->bpx', cf.frame, cf.force6[..., :3])
    tw = torch.einsum('bprx,bpr->bpx', cf.frame, cf.force6[..., 3:])
    for bodies, sign in ((cf.b2, 1.0), (cf.b1, -1.0)):
      idx = torch.as_tensor(bodies, device=m.device)
      off = cf.pos - d.subtree_com[:, rootid[idx]]
      w = sign * torch.cat([tw + tm.cross(off, fw), fw], -1)
      cfrc_ext = cfrc_ext.index_add(1, idx, w.to(cfrc_ext.dtype))
  return m.idx.d_sub @ (cfrc_body - cfrc_ext)


def _inside_site(m: Model, objid: int, local: torch.Tensor) -> torch.Tensor:
  """Whether site-frame points (..., 3) lie in the site's volume (the
  touch sensor's zone): sphere, capsule, ellipsoid, cylinder, else box."""
  t = m.site_type[objid]
  size = m.site_size[objid]
  x, y, z = local.unbind(-1)
  if t == 2:      # sphere
    return torch.sum(local ** 2, -1) <= size[0] ** 2
  if t == 3:      # capsule
    zc = torch.clamp(z, -size[1], size[1])
    return x ** 2 + y ** 2 + (z - zc) ** 2 <= size[0] ** 2
  if t == 4:      # ellipsoid
    return torch.sum((local / torch.clamp(size, min=1e-12)) ** 2, -1) <= 1.0
  if t == 5:      # cylinder
    return (torch.abs(z) <= size[1]) & (x ** 2 + y ** 2 <= size[0] ** 2)
  return torch.all(torch.abs(local) <= size, -1)   # box (6) and default


def _touch(m: Model, d: Data, g: _Group, cf) -> torch.Tensor:
  """(B, k) normal contact force on each touch sensor's site body from
  the contacts whose point lies inside the site's volume."""
  out = []
  for s in g.sensors:
    site = m.sensor_objid[s]
    body = m.site_bodyid[site]
    total = torch.zeros_like(d.qpos[:, 0])
    if cf is not None:
      onbody = np.flatnonzero((cf.b1 == body) | (cf.b2 == body))
      if len(onbody):
        pts = torch.as_tensor(onbody, device=m.device)
        local = _rot_t(d.site_xmat[:, site, None],
                       cf.pos[:, pts] - d.site_xpos[:, site, None])
        fn = cf.force6[:, pts, 0]
        total = torch.sum(torch.where(_inside_site(m, site, local), fn,
                                      torch.zeros_like(fn)), -1)
    out.append(total)
  return torch.stack(out, -1)


def _values(m: Model, d: Data, t: int, g: _Group, ctx) -> torch.Tensor:
  """(B, k, dim) values of a group of sensors of type t."""
  bsz = d.qpos.shape[0]
  if t in _FRAME_TYPES:
    pos_all, mat_all = ctx['frames']()
    pos, mat = pos_all[:, g.rows], mat_all[:, g.rows]
  if t == JOINTPOS:
    return d.qpos[:, g.adr][..., None]
  if t == JOINTVEL:
    return d.qvel[:, g.adr][..., None]
  if t == FRAMEPOS:
    return pos
  if t == FRAMEQUAT:
    return _frame_quats(m, d, g)
  if t in (FRAMEXAXIS, FRAMEYAXIS, FRAMEZAXIS):
    return mat[..., t - FRAMEXAXIS]
  if t == FRAMELINVEL:
    return _point_vel(m, d, g.bodies, pos)[0]
  if t == FRAMEANGVEL:
    return d.cvel[:, g.bodies, :3]
  if t == GYRO:
    return _rot_t(mat, d.cvel[:, g.bodies, :3])
  if t == MAGNETOMETER:
    return _rot_t(mat, m.opt.magnetic.expand(pos.shape))
  if t == VELOCIMETER:
    return _rot_t(mat, _point_vel(m, d, g.bodies, pos)[0])
  if t == ACCELEROMETER:
    cacc = ctx['cacc']()
    rel = pos - d.subtree_com[:, m.idx.body_rootid[g.bodies]]
    ang = cacc[:, g.bodies, :3]
    lin = cacc[:, g.bodies, 3:] + tm.cross(ang, rel)
    v, w = _point_vel(m, d, g.bodies, pos)
    return _rot_t(mat, lin + tm.cross(w, v))   # + w x v(p), classical
  if t in (FORCE, TORQUE):
    cfrc = ctx['cfrc']()
    sites = g.objid
    bodies = m.idx.site_bodyid[sites]
    wrench = cfrc[:, bodies]
    force = wrench[..., 3:]
    smat = d.site_xmat[:, sites]
    if t == FORCE:
      return _rot_t(smat, force)
    com_r = d.subtree_com[:, m.idx.body_rootid[bodies]]
    torque = wrench[..., :3] - tm.cross(d.site_xpos[:, sites] - com_r, force)
    return _rot_t(smat, torque)
  if t == TOUCH:
    return _touch(m, d, g, ctx['contacts']())[..., None]
  if t == SUBTREECOM:
    return d.subtree_com[:, g.objid]
  if t == SUBTREELINVEL:
    return torch.stack([support.subtree_linvel(m, d, m.sensor_objid[s])
                        for s in g.sensors], 1)
  if t == SUBTREEANGMOM:
    return torch.stack([support.subtree_angmom(m, d, m.sensor_objid[s])
                        for s in g.sensors], 1)
  if t == ACTUATORPOS:
    return d.actuator_length[:, g.objid][..., None]
  if t == ACTUATORVEL:
    return d.actuator_velocity[:, g.objid][..., None]
  if t == ACTUATORFRC:
    return d.actuator_force[:, g.objid][..., None]
  if t == BALLQUAT:
    q = d.qpos[:, g.adr[:, None] + torch.arange(4, device=m.device)]
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
  if t == BALLANGVEL:
    return d.qvel[:, g.adr[:, None] + torch.arange(3, device=m.device)]
  if t == TENDONPOS:
    return d.ten_length[:, g.objid][..., None]
  if t == TENDONVEL:
    return d.ten_velocity[:, g.objid][..., None]
  if t == RANGEFINDER:
    # a ray from the site along its +z axis, the site's own body excluded
    return torch.stack([support.raycast(
        m, d, d.site_xpos[:, m.sensor_objid[s]],
        d.site_xmat[:, m.sensor_objid[s], :, 2],
        exclude_body=int(m.site_bodyid[m.sensor_objid[s]]))
                        for s in g.sensors], 1)[..., None]
  if t == CLOCK:
    return d.time[:, None, None].expand(bsz, len(g.sensors), 1)
  raise NotImplementedError(f'mjtSensor {t}')


def sensordata(m: Model, d: Data) -> torch.Tensor:
  """All sensors (B, nsensordata) of post-forward (or post-inverse) Data;
  USER sensors read zero."""
  plan = _plan(m)
  bsz = d.qpos.shape[0]
  cache = {}

  def once(key, fn):
    def get():
      if key not in cache:
        cache[key] = fn()
      return cache[key]
    return get

  ctx = {'frames': once('frames', lambda: _frames(m, d)),
         'cacc': once('cacc', lambda: _cacc(m, d)),
         'cfrc': once('cfrc', lambda: _cfrc_int(m, d)),
         'contacts': once('contacts', lambda: constraint.contact_forces(m, d))}
  vals = [_values(m, d, t, g, ctx).reshape(bsz, -1).to(d.qpos.dtype)
          for t, g in plan.groups.items()]
  vals.append(torch.zeros_like(d.qpos[:, :1]))
  return torch.cat(vals, -1)[:, plan.perm]
