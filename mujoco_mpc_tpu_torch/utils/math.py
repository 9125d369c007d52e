"""Quaternion and spatial-algebra helpers on batch-first tensors.

Port of mujoco_mpc_tpu/utils/tpu_math.py (quat_mul :28, quat_rot :46,
quat_to_mat :60, mat_to_quat :73, quat_conj :42, quat_normalize :24, quat_integrate :118,
quat_sub :128, axis_angle_to_quat :94, motion_cross :160, force_cross
:167, inert_vec :174, inert_from_body_quat :197). Quaternions are (w, x, y, z); spatial
vectors are 6D with the angular part first. Every function broadcasts over
leading dimensions.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Inner product along the last axis."""
  return torch.sum(a * b, -1)


def norm(x: torch.Tensor) -> torch.Tensor:
  """Euclidean norm along the last axis."""
  return torch.linalg.vector_norm(x, dim=-1)


def normalize(v: torch.Tensor) -> torch.Tensor:
  """Normalize along the last axis, guarding against zero norm."""
  n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
  return v / torch.clamp(n, min=_EPS)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
  return normalize(q)


def quat_mul(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """Hamilton product u * v."""
  u0, u1, u2, u3 = u.unbind(-1)
  v0, v1, v2, v3 = v.unbind(-1)
  return torch.stack([
      u0 * v0 - u1 * v1 - u2 * v2 - u3 * v3,
      u0 * v1 + u1 * v0 + u2 * v3 - u3 * v2,
      u0 * v2 - u1 * v3 + u2 * v0 + u3 * v1,
      u0 * v3 + u1 * v2 - u2 * v1 + u3 * v0,
  ], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
  return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """3-vector cross product over the last axis, broadcasting."""
  a, b = torch.broadcast_tensors(a, b)
  return torch.linalg.cross(a, b, dim=-1)


def quat_rot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """Rotate v by q: v + w t + r x t with t = 2 r x v."""
  r = q[..., 1:]
  w = q[..., :1]
  t = 2.0 * cross(r, v)
  return v + w * t + cross(r, t)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
  """Quaternion to (..., 3, 3) rotation matrix."""
  w, x, y, z = q.unbind(-1)
  return torch.stack([
      torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                   2 * (x * z + w * y)], dim=-1),
      torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                   2 * (y * z - w * x)], dim=-1),
      torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                   1 - 2 * (x * x + y * y)], dim=-1),
  ], dim=-2)


def mat_to_quat(r: torch.Tensor) -> torch.Tensor:
  """Rotation matrices (..., 3, 3) to unit quaternions (..., 4), JAX's
  branchless Shepperd: the four candidates computed, the one of the
  first largest pivot kept, its w made non-negative."""
  r00, r01, r02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
  r10, r11, r12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
  r20, r21, r22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]
  tr = r00 + r11 + r22
  cand = torch.stack([
      torch.stack([1.0 + tr, r21 - r12, r02 - r20, r10 - r01], -1),
      torch.stack([r21 - r12, 1.0 + 2.0 * r00 - tr, r01 + r10, r02 + r20],
                  -1),
      torch.stack([r02 - r20, r01 + r10, 1.0 + 2.0 * r11 - tr, r12 + r21],
                  -1),
      torch.stack([r10 - r01, r02 + r20, r12 + r21, 1.0 + 2.0 * r22 - tr],
                  -1)], -2)                                # (..., 4, 4)
  pivots = torch.stack([1.0 + tr, 1.0 + 2.0 * r00 - tr,
                        1.0 + 2.0 * r11 - tr, 1.0 + 2.0 * r22 - tr], -1)
  # the first maximum, as jnp.argmax picks it among equals
  ar = torch.arange(4, device=r.device)
  k = torch.amin(torch.where(
      pivots >= torch.amax(pivots, -1, keepdim=True), ar, 4), -1)
  q = torch.gather(cand, -2, k[..., None, None].expand(
      k.shape + (1, 4)))[..., 0, :]
  q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
  return normalize(q)


def axis_angle_to_quat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
  """Unit axis (..., 3) and angle (...) to a quaternion."""
  half = 0.5 * angle
  s = torch.sin(half)
  return torch.cat([torch.cos(half)[..., None], axis * s[..., None]], dim=-1)


def quat_exp(phi: torch.Tensor) -> torch.Tensor:
  """Rotation vector (..., 3) to a quaternion (tpu_math.py:102)."""
  sq = torch.sum(phi * phi, dim=-1, keepdim=True)
  small = sq < 1e-16
  angle = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
  half = 0.5 * angle
  w = torch.where(small, 1.0 - sq / 8.0 + sq * sq / 384.0, torch.cos(half))
  k = torch.where(small, 0.5 - sq / 48.0, torch.sin(half) / angle)
  return torch.cat([w, phi * k], dim=-1)


def quat_integrate(q: torch.Tensor, omega_local: torch.Tensor,
                   dt) -> torch.Tensor:
  """q * exp(omega_local dt), renormalized (mj_integratePos for quats)."""
  return quat_normalize(quat_mul(q, quat_exp(omega_local * dt)))


def quat_sub(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
  """Rotation vector phi (local frame) with qa = qb * exp(phi)
  (mju_subQuat), the angle wrapped to (-pi, pi]."""
  dq = quat_mul(quat_conj(qb), qa)
  sin_half = torch.linalg.vector_norm(dq[..., 1:], dim=-1, keepdim=True)
  angle = 2.0 * torch.atan2(sin_half, dq[..., :1])
  angle = torch.where(angle > torch.pi, angle - 2 * torch.pi, angle)
  axis = dq[..., 1:] / torch.clamp(sin_half, min=_EPS)
  return torch.where(sin_half < 1e-10, torch.zeros_like(axis), axis * angle)


def motion_cross(v: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
  """Spatial motion cross product v x u."""
  ang = cross(v[..., :3], u[..., :3])
  lin = cross(v[..., :3], u[..., 3:]) + cross(v[..., 3:], u[..., :3])
  return torch.cat([ang, lin], dim=-1)


def force_cross(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
  """Spatial force cross product v x* f."""
  ang = cross(v[..., :3], f[..., :3]) + cross(v[..., 3:], f[..., 3:])
  lin = cross(v[..., :3], f[..., 3:])
  return torch.cat([ang, lin], dim=-1)


def inert_vec(ci: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """Spatial inertia in MuJoCo's 10-vector layout times a motion vector."""
  i11, i22, i33, i12, i13, i23 = ci[..., :6].unbind(-1)
  h = ci[..., 6:9]
  m = ci[..., 9:10]
  w = v[..., :3]
  vl = v[..., 3:]
  w0, w1, w2 = w.unbind(-1)
  iw = torch.stack([
      i11 * w0 + i12 * w1 + i13 * w2,
      i12 * w0 + i22 * w1 + i23 * w2,
      i13 * w0 + i23 * w1 + i33 * w2,
  ], dim=-1)
  f_ang = iw + cross(h, vl)
  f_lin = m * vl - cross(h, w)
  return torch.cat([f_ang, f_lin], dim=-1)


def inert_from_body_quat(mass: torch.Tensor, diag_inertia: torch.Tensor,
                         xiquat: torch.Tensor, xipos: torch.Tensor,
                         origin: torch.Tensor) -> torch.Tensor:
  """cinert 10-vector of a body about `origin`, from its inertial quat."""
  w, x, y, z = xiquat.unbind(-1)
  d1, d2, d3 = diag_inertia.unbind(-1)
  r00 = 1 - 2 * (y * y + z * z)
  r01 = 2 * (x * y - w * z)
  r02 = 2 * (x * z + w * y)
  r10 = 2 * (x * y + w * z)
  r11 = 1 - 2 * (x * x + z * z)
  r12 = 2 * (y * z - w * x)
  r20 = 2 * (x * z - w * y)
  r21 = 2 * (y * z + w * x)
  r22 = 1 - 2 * (x * x + y * y)
  i11 = d1 * r00 * r00 + d2 * r01 * r01 + d3 * r02 * r02
  i22 = d1 * r10 * r10 + d2 * r11 * r11 + d3 * r12 * r12
  i33 = d1 * r20 * r20 + d2 * r21 * r21 + d3 * r22 * r22
  i12 = d1 * r00 * r10 + d2 * r01 * r11 + d3 * r02 * r12
  i13 = d1 * r00 * r20 + d2 * r01 * r21 + d3 * r02 * r22
  i23 = d1 * r10 * r20 + d2 * r11 * r21 + d3 * r12 * r22
  dv = xipos - origin
  dx, dy, dz = dv.unbind(-1)
  dd = dx * dx + dy * dy + dz * dz
  i11 = i11 + mass * (dd - dx * dx)
  i22 = i22 + mass * (dd - dy * dy)
  i33 = i33 + mass * (dd - dz * dz)
  i12 = i12 - mass * dx * dy
  i13 = i13 - mass * dx * dz
  i23 = i23 - mass * dy * dz
  h = mass[..., None] * dv
  mass_b = torch.broadcast_to(mass, i11.shape)
  return torch.cat([torch.stack([i11, i22, i33, i12, i13, i23], dim=-1), h,
                    mass_b[..., None]], dim=-1)


def jacfwd_batched(f, x: torch.Tensor, has_aux: bool = False):
  """Per-sample Jacobian (B, m, n) of a batch-first f: (B, n) -> (B, m)
  whose samples are independent, by forward-mode AD: `torch.func.jacfwd`
  restricted to the batch diagonal. One tangent direction e_k, applied to
  every sample at once, gives column k of every sample's Jacobian, so the
  n directions are one torch.func.vmap of torch.func.jvp (not B * n).
  With has_aux, f returns (output, aux) and the result is (Jacobian, aux):
  aux is computed once, in the same pass, with no tangent (as
  torch.func.jacfwd's has_aux)."""
  n = x.shape[-1]
  basis = torch.eye(n, dtype=x.dtype, device=x.device)[:, None, :]
  basis = basis.expand(n, x.shape[0], n)
  if not has_aux:
    cols = torch.func.vmap(lambda v: torch.func.jvp(f, (x,), (v,))[1])(
        basis)                                            # (n, B, m)
    return cols.permute(1, 2, 0)
  cols, aux = torch.func.vmap(
      lambda v: torch.func.jvp(f, (x,), (v,), has_aux=True)[1:],
      out_dims=(0, None))(basis)
  return cols.permute(1, 2, 0), aux
