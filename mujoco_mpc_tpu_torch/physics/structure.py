"""Static kinematic-structure masks and gathers, and their device tensors.

Port of mujoco_mpc_tpu/physics/structure.py. The mask functions (subtree_mask
:27, body_ancestor_dof_mask :43, dof_vel_mask :60, cdof_gather :108,
dof_body_gather :176, scalar_joint_limits :181, joint_coords :196,
kinematic_levels :247) are numpy-only copies: the JAX module imports
physics/model.py, which imports jax and flax, so the port cannot reuse it.

`build_indices` turns them into torch tensors once, when a Model is built,
on the model's device. The physics step only indexes with these tensors;
it never builds an index tensor from host data, which would be a
host-to-device copy per rollout step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

# mjtJoint values (physics/model.py JointType)
FREE, BALL, SLIDE, HINGE = 0, 1, 2, 3


def subtree_mask(body_parentid) -> np.ndarray:
  """D[a, b] = 1 iff a is ancestor-or-self of b."""
  n = len(body_parentid)
  d = np.zeros((n, n), dtype=np.float64)
  for b in range(n):
    a = b
    while True:
      d[a, b] = 1.0
      if a == 0:
        break
      a = body_parentid[a]
  return d


def body_ancestor_dof_mask(body_parentid, body_dofadr, body_dofnum,
                           nv: int) -> np.ndarray:
  """A[b, i] = 1 iff dof i belongs to an ancestor-or-self body of b."""
  n = len(body_parentid)
  a = np.zeros((n, nv), dtype=np.float64)
  for b in range(n):
    c = b
    while c > 0:
      a[b, body_dofadr[c]:body_dofadr[c] + body_dofnum[c]] = 1.0
      c = body_parentid[c]
  return a


def dof_vel_mask(body_parentid, body_jntadr, body_jntnum, jnt_type,
                 jnt_dofadr, nv: int) -> np.ndarray:
  """V[i, j] = 1 iff dof j's velocity enters cdof_dot[i] (mj_comVel order)."""
  nbody = len(body_parentid)
  v = np.zeros((nv, nv), dtype=np.float64)
  body_dofs = [[] for _ in range(nbody)]
  for b in range(1, nbody):
    for j in range(body_jntadr[b], body_jntadr[b] + body_jntnum[b]):
      nd = {FREE: 6, BALL: 3}.get(jnt_type[j], 1)
      body_dofs[b].extend(range(jnt_dofadr[j], jnt_dofadr[j] + nd))
  for b in range(1, nbody):
    anc = []
    c = body_parentid[b]
    while c > 0:
      anc.extend(body_dofs[c])
      c = body_parentid[c]
    seen = list(anc)
    for j in range(body_jntadr[b], body_jntadr[b] + body_jntnum[b]):
      jt = jnt_type[j]
      adr = jnt_dofadr[j]
      if jt == FREE:
        seen.extend(range(adr, adr + 3))
        for k in range(3, 6):
          v[adr + k, seen] = 1.0
        seen.extend(range(adr + 3, adr + 6))
      elif jt == BALL:
        for k in range(3):
          v[adr + k, seen] = 1.0
        seen.extend(range(adr, adr + 3))
      else:
        v[adr, seen] = 1.0
        seen.append(adr)
  return v


def cdof_gather(body_rootid, jnt_type, jnt_dofadr, jnt_bodyid, nv: int):
  """(ang_idx, pt_idx, lin_idx, dof_rootid) into the candidate tables
  ANG = [0, xaxis, xmat columns], PT = [0, xanchor, xpos],
  LINC = [0, xaxis, e_x, e_y, e_z] (structure.py:108)."""
  njnt = len(jnt_type)
  ang_idx = np.zeros(nv, dtype=np.int64)
  pt_idx = np.zeros(nv, dtype=np.int64)
  lin_idx = np.zeros(nv, dtype=np.int64)
  dof_rootid = np.zeros(nv, dtype=np.int64)
  for j in range(njnt):
    jt = jnt_type[j]
    adr = jnt_dofadr[j]
    b = jnt_bodyid[j]
    root = body_rootid[b]
    if jt == FREE:
      for k in range(3):
        lin_idx[adr + k] = 1 + njnt + k
        dof_rootid[adr + k] = root
      for k in range(3):
        ang_idx[adr + 3 + k] = 1 + njnt + 3 * b + k
        pt_idx[adr + 3 + k] = 1 + njnt + b
        dof_rootid[adr + 3 + k] = root
    elif jt == BALL:
      for k in range(3):
        ang_idx[adr + k] = 1 + njnt + 3 * b + k
        pt_idx[adr + k] = 1 + j
        dof_rootid[adr + k] = root
    elif jt == SLIDE:
      lin_idx[adr] = 1 + j
      dof_rootid[adr] = root
    else:
      ang_idx[adr] = 1 + j
      pt_idx[adr] = 1 + j
      dof_rootid[adr] = root
  return ang_idx, pt_idx, lin_idx, dof_rootid


def dof_body_gather(dof_bodyid) -> np.ndarray:
  return np.asarray(dof_bodyid, dtype=np.int64)


def scalar_joint_limits(jnt_limited, jnt_type, jnt_qposadr, jnt_dofadr):
  """(joint ids, qpos addresses, dof addresses) of limited hinge/slide
  joints."""
  ids = [j for j in range(len(jnt_type))
         if jnt_limited[j] and jnt_type[j] in (HINGE, SLIDE)]
  return (np.asarray(ids, dtype=np.int64),
          np.asarray([jnt_qposadr[j] for j in ids], dtype=np.int64),
          np.asarray([jnt_dofadr[j] for j in ids], dtype=np.int64))


def joint_coords(jnt_type, jnt_qposadr, jnt_dofadr):
  """(sq, sd, sj, quat_q, quat_d, qj): 1-D coordinates (qpos index, dof
  index, joint id) and quaternion blocks (qpos indices (n, 4), dof indices
  (n, 3), joint ids)."""
  sq, sd, sj = [], [], []
  quat_q, quat_d, qj = [], [], []
  for j, jt in enumerate(jnt_type):
    qadr, dadr = jnt_qposadr[j], jnt_dofadr[j]
    if jt == FREE:
      for k in range(3):
        sq.append(qadr + k)
        sd.append(dadr + k)
        sj.append(j)
      quat_q.append([qadr + 3 + k for k in range(4)])
      quat_d.append([dadr + 3 + k for k in range(3)])
      qj.append(j)
    elif jt == BALL:
      quat_q.append([qadr + k for k in range(4)])
      quat_d.append([dadr + k for k in range(3)])
      qj.append(j)
    else:
      sq.append(qadr)
      sd.append(dadr)
      sj.append(j)
  return (np.asarray(sq, dtype=np.int64), np.asarray(sd, dtype=np.int64),
          np.asarray(sj, dtype=np.int64),
          np.asarray(quat_q, dtype=np.int64).reshape(-1, 4),
          np.asarray(quat_d, dtype=np.int64).reshape(-1, 3),
          np.asarray(qj, dtype=np.int64))


def kinematic_levels(body_parentid, body_jntadr, body_jntnum, body_mocapid,
                     jnt_type, jnt_qposadr):
  """Bodies grouped by tree depth, as plain dicts of index lists:
  {'bodies', 'parents', 'free': [(pos, jnt, qadr)], 'mocap': [(pos, id)],
  'slots': [{jnt_type: [(pos, jnt, qadr)]}]} (structure.py:247)."""
  nbody = len(body_parentid)
  depth = [0] * nbody
  for b in range(1, nbody):
    depth[b] = depth[body_parentid[b]] + 1
  maxd = max(depth) if nbody > 1 else 0
  plans = []
  for lvl in range(1, maxd + 1):
    bodies = [b for b in range(1, nbody) if depth[b] == lvl]
    plan = {'bodies': bodies, 'parents': [body_parentid[b] for b in bodies],
            'free': [], 'mocap': [], 'slots': []}
    max_slots = 0
    for i, b in enumerate(bodies):
      jadr, jnum = body_jntadr[b], body_jntnum[b]
      if jnum == 1 and jnt_type[jadr] == FREE:
        plan['free'].append((i, jadr, jnt_qposadr[jadr]))
        continue
      if body_mocapid[b] >= 0:
        plan['mocap'].append((i, body_mocapid[b]))
      max_slots = max(max_slots, jnum)
    for s in range(max_slots):
      slot = {}
      for i, b in enumerate(bodies):
        jadr, jnum = body_jntadr[b], body_jntnum[b]
        if jnum == 1 and jnt_type[jadr] == FREE:
          continue
        if s < jnum:
          j = jadr + s
          slot.setdefault(jnt_type[j], []).append((i, j, jnt_qposadr[j]))
      plan['slots'].append(slot)
    plans.append(plan)
  return plans


# ---------------------------------------------------------------------------
# Device tensors, built once per Model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Gather:
  """Index triple (positions in level, joint ids, qpos addresses)."""
  pos: torch.Tensor
  jnt: torch.Tensor
  qadr: torch.Tensor


@dataclasses.dataclass(frozen=True)
class Level:
  """One tree-depth level of the kinematics sweep, as device tensors."""
  bodies: torch.Tensor
  parents: torch.Tensor
  free: Gather | None
  mocap: Tuple[torch.Tensor, torch.Tensor] | None   # (pos, mocap ids)
  slots: Tuple[Dict[int, Gather], ...]


@dataclasses.dataclass(frozen=True)
class Indices:
  """Every static mask and gather the step uses, on the model's device."""
  levels: Tuple[Level, ...]
  d_sub: torch.Tensor          # (nbody, nbody) float
  a_body: torch.Tensor         # (nbody, nv) float
  v_dof: torch.Tensor          # (nv, nv) float
  ang_idx: torch.Tensor        # (nv,) cdof candidate-table gathers
  pt_idx: torch.Tensor
  lin_idx: torch.Tensor
  dof_rootid: torch.Tensor
  dof_body: torch.Tensor       # (nv,)
  body_rootid: torch.Tensor    # (nbody,)
  geom_bodyid: torch.Tensor    # (ngeom,)
  site_bodyid: torch.Tensor    # (nsite,)
  eye3: torch.Tensor           # (3, 3) float
  box_signs: torch.Tensor      # (8, 3) float: box corner signs, x outermost
  lim_ids: torch.Tensor        # limited hinge/slide joints
  lim_qadr: torch.Tensor
  lim_dof: torch.Tensor
  lim_dof2: torch.Tensor       # (2L,) int32 one-hot limit rows: dof
  lim_sign: torch.Tensor       # (2L,) float: +1 lower, -1 upper side
  sq: torch.Tensor             # joint_coords
  sd: torch.Tensor
  sj: torch.Tensor
  quat_q: torch.Tensor
  quat_d: torch.Tensor
  qj: torch.Tensor
  act_sel: torch.Tensor        # (nu, nv, 6) joint-transmission moment selector
  act_qadr: torch.Tensor       # (nu,)
  act_scalar: torch.Tensor     # (nu,) float: hinge/slide transmission
  ctrl_limited: torch.Tensor   # (nu,) bool
  force_limited: torch.Tensor  # (nu,) bool
  gain_affine: torch.Tensor    # (nu,) bool
  bias_on: torch.Tensor        # (nu,) bool
  has_act: torch.Tensor        # (nu,) bool
  is_integ: torch.Tensor       # (nu,) bool
  act_gather: torch.Tensor     # (nu,) act slot per actuator (0 if none)
  act_scatter_u: torch.Tensor  # actuators with an activation slot
  act_scatter_a: torch.Tensor  # ... and their slots


def tree_to(x, device):
  """Move every tensor inside a tree of dataclasses, tuples and dicts."""
  if isinstance(x, torch.Tensor):
    return x.to(device)
  if dataclasses.is_dataclass(x):
    return dataclasses.replace(x, **{
        f.name: tree_to(getattr(x, f.name), device)
        for f in dataclasses.fields(x)})
  if isinstance(x, tuple):
    return tuple(tree_to(v, device) for v in x)
  if isinstance(x, dict):
    return {k: tree_to(v, device) for k, v in x.items()}
  return x


def build_indices(s: dict, device, dtype) -> Indices:
  """Device tensors for the static structure `s` (a dict of the Model's
  static fields, see physics/model.py)."""
  li = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64).reshape(-1),  # noqa: E731
                                 device=device)
  fl = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64),  # noqa: E731
                                 dtype=dtype, device=device)
  bo = lambda a: torch.as_tensor(np.asarray(a, dtype=bool).reshape(-1),  # noqa: E731
                                 device=device)

  def gather(entries):
    return Gather(li([e[0] for e in entries]), li([e[1] for e in entries]),
                  li([e[2] for e in entries]))

  levels = []
  for p in kinematic_levels(s['body_parentid'], s['body_jntadr'],
                            s['body_jntnum'], s['body_mocapid'],
                            s['jnt_type'], s['jnt_qposadr']):
    levels.append(Level(
        bodies=li(p['bodies']), parents=li(p['parents']),
        free=gather(p['free']) if p['free'] else None,
        mocap=((li([i for i, _ in p['mocap']]),
                li([k for _, k in p['mocap']])) if p['mocap'] else None),
        slots=tuple({jt: gather(e) for jt, e in slot.items()}
                    for slot in p['slots'])))

  nv, nu = s['nv'], s['nu']
  ang_idx, pt_idx, lin_idx, dof_rootid = cdof_gather(
      s['body_rootid'], s['jnt_type'], s['jnt_dofadr'], s['jnt_bodyid'], nv)
  lim_ids, lim_qadr, lim_dof = scalar_joint_limits(
      s['jnt_limited'], s['jnt_type'], s['jnt_qposadr'], s['jnt_dofadr'])
  nl = len(lim_ids)
  sq, sd, sj, quat_q, quat_d, qj = joint_coords(
      s['jnt_type'], s['jnt_qposadr'], s['jnt_dofadr'])

  # joint transmissions (smooth.transmission fast path, smooth.py:358-373)
  sel = np.zeros((nu, nv, 6))
  qadr_arr = np.zeros(nu, dtype=np.int64)
  scalar_mask = np.zeros(nu)
  for u in range(nu):
    if s['actuator_trntype'][u] != 0:   # not a joint transmission
      continue
    j = s['actuator_trnid'][u]
    jtype = s['jnt_type'][j]
    dofadr = s['jnt_dofadr'][j]
    if jtype in (HINGE, SLIDE):
      sel[u, dofadr, 0] = 1.0
      qadr_arr[u] = s['jnt_qposadr'][j]
      scalar_mask[u] = 1.0
    elif jtype == BALL:
      for k in range(3):
        sel[u, dofadr + k, k] = 1.0
    else:
      for k in range(6):
        sel[u, dofadr + k, k] = 1.0

  dyn = np.asarray(s['actuator_dyntype'], dtype=np.int64)
  has_act = dyn != 0
  aadr = np.asarray(s['actuator_actadr'], dtype=np.int64)
  return Indices(
      levels=tuple(levels),
      d_sub=fl(subtree_mask(s['body_parentid'])),
      a_body=fl(body_ancestor_dof_mask(s['body_parentid'], s['body_dofadr'],
                                       s['body_dofnum'], nv)),
      v_dof=fl(dof_vel_mask(s['body_parentid'], s['body_jntadr'],
                            s['body_jntnum'], s['jnt_type'],
                            s['jnt_dofadr'], nv)),
      ang_idx=li(ang_idx), pt_idx=li(pt_idx), lin_idx=li(lin_idx),
      dof_rootid=li(dof_rootid),
      dof_body=li(dof_body_gather(s['dof_bodyid'])),
      body_rootid=li(s['body_rootid']),
      geom_bodyid=li(s['geom_bodyid']),
      site_bodyid=li(s['site_bodyid']),
      eye3=fl(np.eye(3)),
      box_signs=fl([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                    for sz in (-1, 1)]),
      lim_ids=li(lim_ids), lim_qadr=li(lim_qadr), lim_dof=li(lim_dof),
      lim_dof2=li(np.concatenate([lim_dof, lim_dof])).to(torch.int32),
      lim_sign=fl(np.concatenate([np.ones(nl), -np.ones(nl)])),
      sq=li(sq), sd=li(sd), sj=li(sj), quat_q=li(quat_q).reshape(-1, 4),
      quat_d=li(quat_d).reshape(-1, 3), qj=li(qj),
      act_sel=fl(sel), act_qadr=li(qadr_arr), act_scalar=fl(scalar_mask),
      ctrl_limited=bo(s['actuator_ctrllimited']),
      force_limited=bo(s['actuator_forcelimited']),
      gain_affine=bo([t != 0 for t in s['actuator_gaintype']]),
      bias_on=bo([t != 0 for t in s['actuator_biastype']]),
      has_act=bo(has_act),
      is_integ=bo(dyn == 1),
      act_gather=li(np.where(has_act, aadr, 0)),
      act_scatter_u=li(np.nonzero(has_act)[0]),
      act_scatter_a=li(aadr[has_act]),
  )
