"""Smooth dynamics: mass matrix, bias, passive, transmission, actuation.

Port of mujoco_mpc_tpu/physics/smooth.py (crb :22, rne :46, _wrap_2d
:75, _wrap_geom :142, tendon :197, passive :278, _body_jac :327,
transmission :348, actuation :473, xfrc_accumulate :525), batch-first.
Dense mass matrix; tree sums are matmuls against the static masks in
Model.idx.

Tendons: fixed ones are matmuls against ten_qmat and ten_moment; spatial
ones walk their static wrap plan (site waypoints, sphere and cylinder
wraps with and without a side site, pulley divisors), so their moment
rows ten_J are per sample (B, ntendon, nv). passive adds the tendon
springs (a deadband) and dampers and gravity compensation (:309-324).

Transmissions: joints (a static moment, as JAX's fast path), tendons
(:460-463) and sites (:430-460: a wrench in the site frame, or the site's
pose in a reference site's frame); a tendon or site transmission makes
the moment arms per sample (B, nu, nv). Rows are stacked, never written
into batched tensors, so that torch.func transforms pass through.

Not ported yet, and refused where reached: slider-crank and body
transmissions (ROADMAP A8).
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_mpc_tpu_torch.physics.model import Data, Model, TrnType
from mujoco_mpc_tpu_torch.utils import math as tm


def crb(m: Model, d: Data) -> Data:
  """Composite-rigid-body mass matrix, dense (mj_crb)."""
  crb_inert = m.idx.d_sub @ d.cinert                      # (B, nbody, 10)
  f = tm.inert_vec(crb_inert[:, m.idx.dof_body], d.cdof)  # (B, nv, 6)
  lower = (f @ d.cdof.transpose(-1, -2)) * m.dof_ancestor_mask
  qm = (lower + lower.transpose(-1, -2)
        - torch.diag_embed(torch.diagonal(lower, dim1=-2, dim2=-1)))
  qm = qm + torch.diag(m.dof_armature)
  return d.replace(qM=qm)


def rne(m: Model, d: Data) -> Data:
  """Bias force C(q, qvel) qvel + gravity (mj_rne)."""
  base = torch.cat([torch.zeros_like(m.opt.gravity), -m.opt.gravity])
  cacc = base + m.idx.a_body @ (d.cdof_dot * d.qvel[..., None])
  iv = tm.inert_vec(d.cinert, d.cvel)
  cfrc = tm.inert_vec(d.cinert, cacc) + tm.force_cross(d.cvel, iv)
  cfrc_total = m.idx.d_sub @ cfrc                         # (B, nbody, 6)
  qfrc_bias = torch.sum(d.cdof * cfrc_total[:, m.idx.dof_body], dim=-1)
  return d.replace(qfrc_bias=qfrc_bias)


def _wrap_2d(a2, b2, r, side2, has_side: bool):
  """Circle wrap in 2D (mju_wrap's core), batch-first: the tangent path
  from a2 (B, 2) around the radius-r circle at the origin to b2 (B, 2).
  Returns (t0 (B, 2), t1 (B, 2), arc length (B,), wrapped (B,)). With a
  side site (side2 (B, 2), has_side static) the path wraps where the
  chord meets the circle, passes the centre on the far side from the
  side site, or the side site is inside, and takes the arc whose touch
  points align with the side site; without one it wraps where the chord
  meets the circle and takes the shorter arc. No wrap with an endpoint
  inside the circle."""
  eps = 1e-12
  da, db = tm.norm(a2), tm.norm(b2)
  ab = b2 - a2
  denom = torch.clamp(tm.dot(ab, ab), min=eps)
  tstar = torch.clamp(-tm.dot(a2, ab) / denom, 0.0, 1.0)
  foot = a2 + tstar[..., None] * ab
  cross = tm.norm(foot) < r
  if has_side:
    cross = cross | (tm.norm(side2) < r) | (tm.dot(foot, side2) < 0.0)
  wrapped = (da > r * (1.0 + 1e-9)) & (db > r * (1.0 + 1e-9)) & cross
  alpha_a = torch.atan2(a2[..., 1], a2[..., 0])
  alpha_b = torch.atan2(b2[..., 1], b2[..., 0])
  ha = torch.arccos(torch.clamp(r / torch.clamp(da, min=r + eps), 0.0, 1.0))
  hb = torch.arccos(torch.clamp(r / torch.clamp(db, min=r + eps), 0.0, 1.0))

  def arc_for(sgn):
    th_a = alpha_a + sgn * ha          # the touch point leaving a
    th_b = alpha_b - sgn * hb          # the touch point arriving at b
    return th_a, th_b, torch.remainder(sgn * (th_b - th_a), 2.0 * np.pi)

  th_a_p, th_b_p, d_p = arc_for(1.0)
  th_a_m, th_b_m, d_m = arc_for(-1.0)
  if has_side:
    sn = side2 / torch.clamp(tm.norm(side2), min=eps)[..., None]

    def touch_score(th_a, th_b):
      return ((torch.cos(th_a) + torch.cos(th_b)) * sn[..., 0]
              + (torch.sin(th_a) + torch.sin(th_b)) * sn[..., 1])
    use_p = touch_score(th_a_p, th_b_p) >= touch_score(th_a_m, th_b_m)
  else:
    use_p = d_p <= d_m
  th_a = torch.where(use_p, th_a_p, th_a_m)
  th_b = torch.where(use_p, th_b_p, th_b_m)
  delta = torch.where(use_p, d_p, d_m)
  t0 = r * torch.stack([torch.cos(th_a), torch.sin(th_a)], -1)
  t1 = r * torch.stack([torch.cos(th_b), torch.sin(th_b)], -1)
  return t0, t1, r * delta, wrapped


def _wrap_geom(m: Model, d: Data, x1, x2, g: int, kind: int, side: int):
  """The tangent points (B, 3) and arc length (B,) of the path x1 ->
  (wrap geom g) -> x2 in the world frame, and whether it wraps (mju_wrap):
  a cylinder (kind 1) wraps in its local xy-plane with z along the
  unrolled surface; a sphere (kind 0) in the plane through x1, x2 and
  its centre, the side site's plane where x1 x x2 degenerates."""
  gpos, gmat = d.geom_xpos[:, g], d.geom_xmat[:, g]
  r = m.geom_size[g, 0]
  p1 = torch.einsum('bji,bj->bi', gmat, x1 - gpos)
  p2 = torch.einsum('bji,bj->bi', gmat, x2 - gpos)
  has_side = side >= 0
  if has_side:
    s_loc = torch.einsum('bji,bj->bi', gmat, d.site_xpos[:, side] - gpos)
  else:
    s_loc = torch.ones_like(p1)
  if kind == 1:
    a2, b2 = p1[..., :2], p2[..., :2]
    t0_2, t1_2, arc2, wrapped = _wrap_2d(a2, b2, r, s_loc[..., :2], has_side)
    la = tm.norm(a2 - t0_2)
    lb = tm.norm(b2 - t1_2)
    l2d = torch.clamp(la + arc2 + lb, min=1e-12)
    dz = p2[..., 2] - p1[..., 2]
    z0 = p1[..., 2] + dz * la / l2d
    z1 = p1[..., 2] + dz * (la + arc2) / l2d
    t0_l = torch.cat([t0_2, z0[..., None]], -1)
    t1_l = torch.cat([t1_2, z1[..., None]], -1)
    arc = torch.sqrt(arc2 * arc2 + (z1 - z0) ** 2)
  else:
    n = tm.cross(p1, p2)
    n_side = tm.cross(p1, s_loc)
    up = torch.tensor([0.0, 0.0, 1.0], dtype=n.dtype, device=n.device)
    n = torch.where((tm.norm(n) < 1e-9)[..., None],
                    torch.where((tm.norm(n_side) > 1e-9)[..., None], n_side,
                                up), n)
    ez = n / torch.clamp(tm.norm(n), min=1e-12)[..., None]
    ex = p1 - tm.dot(p1, ez)[..., None] * ez
    ex = ex / torch.clamp(tm.norm(ex), min=1e-12)[..., None]
    ey = tm.cross(ez, ex)

    def to2(p):
      return torch.stack([tm.dot(p, ex), tm.dot(p, ey)], -1)
    t0_2, t1_2, arc, wrapped = _wrap_2d(to2(p1), to2(p2), r, to2(s_loc),
                                        has_side)
    t0_l = t0_2[..., :1] * ex + t0_2[..., 1:] * ey
    t1_l = t1_2[..., :1] * ex + t1_2[..., 1:] * ey
  t0_w = gpos + torch.einsum('bij,bj->bi', gmat, t0_l)
  t1_w = gpos + torch.einsum('bij,bj->bi', gmat, t1_l)
  return t0_w, t1_w, arc, wrapped


def point_jac(m: Model, d: Data, pos3, bodies):
  """Translational and rotational Jacobians (B, P, nv, 3) of world points
  pos3 (B, P, 3) on per-sample bodies (B, P) (JAX's _body_jac :327 and
  the traced-index batch_jac of constraint.py): the bodies' ancestor
  dofs' columns of cdof, composed about their roots' subtree centres of
  mass."""
  off = pos3 - torch.gather(
      d.subtree_com, 1,
      m.idx.body_rootid[bodies][..., None].expand(-1, -1, 3))
  mask = m.idx.a_body[bodies][..., None]                       # (B, P, nv, 1)
  jp = (d.cdof[:, None, :, 3:]
        + tm.cross(d.cdof[:, None, :, :3], off[:, :, None, :]))
  return jp * mask, d.cdof[:, None, :, :3] * mask


def _body_jac(m: Model, d: Data, body: int, point: torch.Tensor):
  """point_jac (B, nv, 3) of world points (B, 3) on one body."""
  bodies = torch.full((point.shape[0], 1), int(body), dtype=torch.long,
                      device=point.device)
  jp, jr = point_jac(m, d, point[:, None], bodies)
  return jp[:, 0], jr[:, 0]


def _spatial_tendon(m: Model, d: Data, branches):
  """Length (B,) and moment row (B, nv) of one spatial tendon: per branch
  with pulley divisor v, the path length / v, and the analytic dL/dq: a
  straight segment u^T (Jp2 - Jp1) / v, a wrap through its two tangent
  segments with the tangent points on the wrap geom's body (the arc's own
  derivative vanishes). Without a wrap both tangent points sit at the
  segment's midpoint, the straight segment exactly."""
  length = torch.zeros_like(d.qpos[:, 0])
  jac = torch.zeros_like(d.qvel)
  for divisor, elems in branches:
    inv = 1.0 / divisor
    i = 0
    while i + 1 < len(elems):
      s1 = elems[i][1]
      if elems[i + 1][0] == 'g':
        _, g, kind, side = elems[i + 1]
        s2 = elems[i + 2][1]
        i += 2
      else:
        g, kind, side = -1, 0, -1
        s2 = elems[i + 1][1]
        i += 1
      x1, x2 = d.site_xpos[:, s1], d.site_xpos[:, s2]
      jp1, _ = _body_jac(m, d, m.site_bodyid[s1], x1)
      jp2, _ = _body_jac(m, d, m.site_bodyid[s2], x2)
      if g < 0:
        diff = x2 - x1
        ln = tm.norm(diff)
        u = diff / torch.clamp(ln, min=1e-12)[..., None]
        length = length + ln * inv
        jac = jac + torch.einsum('bns,bs->bn', jp2 - jp1, u) * inv
        continue
      t1, t2, arc, wrapped = _wrap_geom(m, d, x1, x2, g, kind, side)
      midpt = 0.5 * (x1 + x2)
      t1 = torch.where(wrapped[..., None], t1, midpt)
      t2 = torch.where(wrapped[..., None], t2, midpt)
      arc = torch.where(wrapped, arc, torch.zeros_like(arc))
      d1, d2 = t1 - x1, x2 - t2
      l1, l2 = tm.norm(d1), tm.norm(d2)
      u1 = d1 / torch.clamp(l1, min=1e-12)[..., None]
      u2 = d2 / torch.clamp(l2, min=1e-12)[..., None]
      jg1, _ = _body_jac(m, d, m.geom_bodyid[g], t1)
      jg2, _ = _body_jac(m, d, m.geom_bodyid[g], t2)
      length = length + (l1 + arc + l2) * inv
      jac = jac + (torch.einsum('bns,bs->bn', jg1 - jp1, u1)
                   + torch.einsum('bns,bs->bn', jp2 - jg2, u2)) * inv
  return length, jac


def tendon(m: Model, d: Data) -> Data:
  """Tendon lengths, velocities and moment rows (mj_tendon): ten_length
  and ten_velocity (B, ntendon), ten_J (B, ntendon, nv). A model without
  tendons passes through."""
  if m.ntendon == 0:
    return d
  bsz = d.qpos.shape[0]
  fixed_len = d.qpos @ m.ten_qmat.T                         # (B, ntendon)
  if not any(m.ten_spatial):
    return d.replace(ten_length=fixed_len, ten_velocity=d.qvel @ m.ten_moment.T,
                     ten_J=m.ten_moment.expand(bsz, -1, -1))
  lengths, jacs = [], []
  for ti, branches in enumerate(m.ten_spatial):
    if branches:
      length, jac = _spatial_tendon(m, d, branches)
    else:
      length, jac = fixed_len[:, ti], m.ten_moment[ti].expand(bsz, -1)
    lengths.append(length)
    jacs.append(jac)
  ten_j = torch.stack(jacs, 1)
  return d.replace(ten_length=torch.stack(lengths, 1),
                   ten_velocity=(ten_j @ d.qvel[..., None])[..., 0],
                   ten_J=ten_j)


def passive(m: Model, d: Data) -> Data:
  """Damper, tendon and joint-spring forces and gravity compensation
  (mj_passive; fluid in forward.py). A tendon springs on its deadband
  [lo, hi] and damps on ten_J qvel (recomputed from this qvel, so that
  the implicit integrator sees its derivative); ball and free joints
  spring on the quaternion difference (smooth.py:304-307); a body with
  gravcomp g gets -g m gravity at its centre of mass (:309-324)."""
  qfrc = -m.dof_damping * d.qvel
  idx = m.idx
  if m.ntendon:
    length = d.ten_length
    vel = (d.ten_J @ d.qvel[..., None])[..., 0]
    lo, hi = m.tendon_lengthspring[:, 0], m.tendon_lengthspring[:, 1]
    zero = torch.zeros_like(length)
    displacement = torch.where(length > hi, hi - length,
                               torch.where(length < lo, lo - length, zero))
    frc = m.tendon_stiffness * displacement - m.tendon_damping * vel
    qfrc = qfrc + (frc[:, None, :] @ d.ten_J)[:, 0]
  if len(idx.sq):
    dif = d.qpos[:, idx.sq] - m.qpos_spring[idx.sq]
    qfrc = qfrc.index_add(1, idx.sd, -m.jnt_stiffness[idx.sj] * dif)
  if len(idx.qj):
    rot = tm.quat_sub(d.qpos[:, idx.quat_q], m.qpos_spring[idx.quat_q])
    qfrc = qfrc.index_add(
        1, idx.quat_d.reshape(-1),
        (-m.jnt_stiffness[idx.qj][:, None] * rot).reshape(d.qpos.shape[0],
                                                          -1))
  if m.any_gravcomp:
    # the lift -gravcomp mass gravity at each body's centre of mass
    f = (-(m.body_gravcomp * m.body_mass)[:, None]
         * m.opt.gravity[None, :])                           # (nbody, 3)
    wrench = torch.cat([f, torch.zeros_like(f)], -1).expand(
        d.xipos.shape[0], -1, -1)
    qfrc = qfrc + xfrc_accumulate(m, d.replace(xfrc_applied=wrench))
  return d.replace(qfrc_passive=qfrc)


def _site_jac(m: Model, d: Data, s: int):
  """Translational and rotational Jacobians (B, nv, 3) of site s's world
  position on its body (JAX's _body_jac :327)."""
  return _body_jac(m, d, m.site_bodyid[s], d.site_xpos[:, s])


def _site_transmission(m: Model, d: Data, u: int):
  """Length (B,) and moment (B, nv) of actuator u's site transmission.
  Without a reference site, the gear's wrench in the site frame at zero
  length; with one, gear . [the site's translation; its rotation vector]
  in the reference site's frame, the moment with that frame held fixed
  (mj_transmission's convention)."""
  gear = m.actuator_gear[u]
  s = m.actuator_trnid[u]
  jacp, jacr = _site_jac(m, d, s)
  smat = d.site_xmat[:, s]
  refid = m.actuator_refid[u]
  if refid < 0:
    force = smat @ gear[:3]
    torque = smat @ gear[3:]
    moment = (torch.einsum('bns,bs->bn', jacp, force)
              + torch.einsum('bns,bs->bn', jacr, torque))
    return torch.zeros_like(moment[:, 0]), moment
  rmat = d.site_xmat[:, refid]
  rjacp, rjacr = _site_jac(m, d, refid)
  trans = torch.einsum('bji,bj->bi', rmat,
                       d.site_xpos[:, s] - d.site_xpos[:, refid])
  rot = tm.quat_sub(tm.mat_to_quat(smat), tm.mat_to_quat(rmat))
  length = trans @ gear[:3] + rot @ gear[3:]
  moment = ((jacp - rjacp) @ rmat @ gear[:3]
            + (jacr - rjacr) @ rmat @ gear[3:])
  return length, moment


def transmission(m: Model, d: Data) -> Data:
  """Actuator lengths, velocities and moment arms for joint, tendon and
  site transmissions (mj_transmission). Joint transmissions alone give
  one static moment (nu, nv), expanded over the batch; a tendon or site
  transmission makes it per sample, its rows stacked (no write into a
  batched tensor, so that torch.func transforms pass through)."""
  if m.nu == 0:
    return d
  other = sorted({TrnType(t).name.lower() for t in m.actuator_trntype
                  if t not in (TrnType.JOINT, TrnType.SITE, TrnType.TENDON)})
  if other:
    raise NotImplementedError(
        f'{", ".join(other)} actuator transmissions are not ported yet '
        f'(ROADMAP A8)')
  bsz = d.qpos.shape[0]
  gear = m.actuator_gear                                  # (nu, 6)
  moment = torch.einsum('unk,uk->un', m.idx.act_sel, gear)
  length = d.qpos[:, m.idx.act_qadr] * gear[:, 0] * m.idx.act_scalar
  if all(t == TrnType.JOINT for t in m.actuator_trntype):
    velocity = d.qvel @ moment.T
    return d.replace(actuator_length=length, actuator_velocity=velocity,
                     actuator_moment=moment.expand(bsz, -1, -1))
  lengths, moments = [], []
  for u in range(m.nu):
    if m.actuator_trntype[u] == TrnType.SITE:
      length_u, moment_u = _site_transmission(m, d, u)
    elif m.actuator_trntype[u] == TrnType.TENDON:
      ti, g0 = m.actuator_trnid[u], m.actuator_gear[u, 0]
      length_u, moment_u = d.ten_length[:, ti] * g0, d.ten_J[:, ti] * g0
    else:
      length_u, moment_u = length[:, u], moment[u].expand(bsz, -1)
    lengths.append(length_u)
    moments.append(moment_u)
  moment = torch.stack(moments, 1)                        # (B, nu, nv)
  velocity = (moment @ d.qvel[..., None])[..., 0]
  return d.replace(actuator_length=torch.stack(lengths, 1),
                   actuator_velocity=velocity, actuator_moment=moment)


def actuation(m: Model, d: Data) -> Data:
  """Actuator forces and activation derivatives (mj_fwdActuation)."""
  if m.nu == 0:
    return d.replace(qfrc_actuator=torch.zeros_like(d.qvel),
                     act_dot=d.act)
  idx = m.idx
  ctrl = d.ctrl
  clamped = torch.clamp(ctrl, m.actuator_ctrlrange[:, 0],
                        m.actuator_ctrlrange[:, 1])
  ctrl = torch.where(idx.ctrl_limited, clamped, ctrl)

  if m.na:
    tau = torch.clamp(m.actuator_dynprm[:, 0], min=1e-8)
    act_u = d.act[:, idx.act_gather]
    dot_u = torch.where(idx.is_integ, ctrl, (ctrl - act_u) / tau)
    act_dot = torch.zeros_like(d.act).index_copy(
        1, idx.act_scatter_a, dot_u[:, idx.act_scatter_u])
    inp = torch.where(idx.has_act, act_u, ctrl)
  else:
    act_dot = d.act
    inp = ctrl

  gp, bp = m.actuator_gainprm, m.actuator_biasprm
  affine_g = (gp[:, 0] + gp[:, 1] * d.actuator_length
              + gp[:, 2] * d.actuator_velocity)
  gains = torch.where(idx.gain_affine, affine_g, gp[:, 0])
  affine_b = (bp[:, 0] + bp[:, 1] * d.actuator_length
              + bp[:, 2] * d.actuator_velocity)
  biases = torch.where(idx.bias_on, affine_b, torch.zeros_like(affine_b))
  force = gains * inp + biases
  fclamped = torch.clamp(force, m.actuator_forcerange[:, 0],
                         m.actuator_forcerange[:, 1])
  force = torch.where(idx.force_limited, fclamped, force)
  qfrc_actuator = (force[:, None, :] @ d.actuator_moment)[:, 0]
  return d.replace(actuator_force=force, act_dot=act_dot,
                   qfrc_actuator=qfrc_actuator)


def xfrc_accumulate(m: Model, d: Data) -> torch.Tensor:
  """Per-body applied world wrenches mapped to generalized forces."""
  off = d.xipos - d.subtree_com[:, m.idx.body_rootid]     # (B, nbody, 3)
  # jacp[b, i] = cdof[i, 3:] + cdof[i, :3] x off[b]
  jacp = (d.cdof[:, None, :, 3:]
          + tm.cross(d.cdof[:, None, :, :3], off[:, :, None, :]))
  contrib = (torch.einsum('zbis,zbs->zbi', jacp, d.xfrc_applied[..., :3])
             + d.xfrc_applied[..., 3:] @ d.cdof[..., :3].transpose(-1, -2))
  return torch.sum(m.idx.a_body * contrib, dim=1)
