"""Batched primal-Newton constraint solve: the CUDA kernel B2 and its plain
version.

Port of mujoco_mpc_tpu/ops/pallas_newton.py: the fused Pallas kernel
_newton_kernel (:222) behind newton_batched (:631), for the dense +
one-hot-scalar operand set, and the reference loop _newton_reference
(:792) as `newton_reference`, batch first. The kernel is csrc/newton.cu.

Dispatch is by device only: a CPU tensor takes `newton_reference`, a CUDA
tensor the kernel, and anything the kernel cannot take raises. Not ported
yet: the factored contact-point groups (ROADMAP A6), elliptic-cone and
frictionloss rows (A8), and the implicit-function tangent make_newton's
custom_jvp supplies (:1053; A9).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mujoco_mpc_tpu_torch.ops import cuda_build
from mujoco_mpc_tpu_torch.ops import linalg

MAX_NV = 32
_DAMP = 1e-10
_ALPHAS = (0.0, 1.0, 0.5, 0.25, 0.0625)


def newton_reference(qm, qs, j, aref, dvec, eqf, s_aref, s_dvec, dof, sign,
                     *, cap: int, tol: float):
  """Plain batch-first Newton solve.

  qm (B, nv, nv), qs (B, nv), j (B, n, nv), aref/dvec/eqf (B, n),
  s_aref/s_dvec (B, ns), dof (ns,) int, sign (ns,) float ->
  (qacc (B, nv), jar_d (B, n), jar_s (B, ns)).

  Runs `cap` iterations with per-sample done masks and frozen finished
  samples, which is what the vmapped while_loop computes, and never reads
  a tensor value on the host, so on the card it queues without a sync."""
  bsz, nv = qs.shape
  n = j.shape[1]
  ns = s_aref.shape[1]
  eq = eqf > 0.5
  dof = dof.long()
  zero = torch.zeros((), dtype=qs.dtype, device=qs.device)
  eye = torch.eye(nv, dtype=qs.dtype, device=qs.device)
  jt = j.transpose(1, 2)

  def mv(a, x):
    return (a @ x[..., None])[..., 0]

  qacc = qs
  jar_d = mv(j, qs) - aref
  jar_s = sign * qs[:, dof] - s_aref
  done = torch.zeros(bsz, dtype=torch.bool, device=qs.device)
  prev_exact = done
  for _ in range(cap):
    e = qacc - qs
    me = mv(qm, e)
    g = me
    h = qm + _DAMP * eye
    if n:
      active_d = torch.logical_or(jar_d < 0, eq)
      w_d = torch.where(active_d, dvec, zero)
      g = g + mv(jt, w_d * jar_d)
      h = h + (jt * w_d[:, None, :]) @ j
    if ns:
      active_s = jar_s < 0
      w_s = torch.where(active_s, s_dvec, zero)
      g = g.index_add(1, dof, sign * (w_s * jar_s))
      h = h + torch.diag_embed(torch.zeros_like(qs).index_add(1, dof, w_s))
    step = linalg.solve_spd(h, g)
    js_d = mv(j, step)
    js_s = sign * step[:, dof]
    sme = torch.sum(step * me, -1)
    sms = torch.sum(step * mv(qm, step), -1)
    eme = torch.sum(e * me, -1)
    costs = []
    for a in _ALPHAS:
      pen = zero
      if n:
        jc = jar_d - a * js_d
        pc = torch.where(torch.logical_or(jc < 0, eq), dvec, zero)
        pen = pen + 0.5 * torch.sum(pc * jc * jc, -1)
      if ns:
        jc = jar_s - a * js_s
        pc = torch.where(jc < 0, s_dvec, zero)
        pen = pen + 0.5 * torch.sum(pc * jc * jc, -1)
      costs.append(0.5 * eme - a * sme + 0.5 * a * a * sms + pen)
    best = torch.argmin(torch.stack(costs, -1), -1)
    alpha = torch.zeros_like(sme)
    for i, a in enumerate(_ALPHAS):
      alpha = torch.where(best == i, a, alpha)
    qacc_new = qacc - alpha[:, None] * step
    jar_d_new = jar_d - alpha[:, None] * js_d
    jar_s_new = jar_s - alpha[:, None] * js_s
    stable = torch.ones_like(done)
    if n:
      stable = stable & torch.all(
          torch.logical_or(jar_d_new < 0, eq) == active_d, -1)
    if ns:
      stable = stable & torch.all((jar_s_new < 0) == active_s, -1)
    exact = (best == 1) & stable
    small = (torch.linalg.vector_norm(step, dim=-1)
             <= tol * (1.0 + torch.linalg.vector_norm(qacc_new, dim=-1)))
    live = ~done
    qacc = torch.where(live[:, None], qacc_new, qacc)
    jar_d = torch.where(live[:, None], jar_d_new, jar_d)
    jar_s = torch.where(live[:, None], jar_s_new, jar_s)
    prev_exact_new = torch.where(live, exact, prev_exact)
    done = done | ((exact & prev_exact) | small)
    prev_exact = prev_exact_new
  return qacc, jar_d, jar_s


@functools.lru_cache(maxsize=None)
def _entry():
  fn = cuda_build.load('newton').mjpc_newton_f32
  p = ctypes.c_void_p
  i = ctypes.c_int
  fn.argtypes = [p] * 13 + [i, i, i, i, i, ctypes.c_float, p]
  fn.restype = ctypes.c_int
  return fn


def _check(qm, qs, j, aref, dvec, eqf, s_aref, s_dvec, dof, sign, cap):
  """Refuse what the kernel does not take (it never falls back)."""
  floats = (qm, qs, j, aref, dvec, eqf, s_aref, s_dvec, sign)
  cuda_build.require_cuda(*floats, dof)
  if any(t.device != qs.device for t in floats + (dof,)):
    raise ValueError('all operands must be on one device')
  if any(t.dtype != torch.float32 for t in floats):
    raise TypeError('the kernel takes float32 operands, got '
                    f'{sorted({str(t.dtype) for t in floats})}')
  if dof.dtype != torch.int32:
    raise TypeError(f'dof must be int32, got {dof.dtype}')
  if qs.dim() != 2:
    raise ValueError(f'qs must be (B, nv), got {tuple(qs.shape)}')
  bsz, nv = qs.shape
  n = j.shape[1] if j.dim() == 3 else -1
  ns = s_aref.shape[1] if s_aref.dim() == 2 else -1
  want = {'qm': (qm, (bsz, nv, nv)), 'j': (j, (bsz, n, nv)),
          'aref': (aref, (bsz, n)), 'dvec': (dvec, (bsz, n)),
          'eqf': (eqf, (bsz, n)), 's_aref': (s_aref, (bsz, ns)),
          's_dvec': (s_dvec, (bsz, ns)), 'dof': (dof, (ns,)),
          'sign': (sign, (ns,))}
  for name, (t, shape) in want.items():
    if n < 0 or ns < 0 or tuple(t.shape) != shape:
      raise ValueError(f'{name}: expected shape {shape}, got '
                       f'{tuple(t.shape)}')
  if not 1 <= nv <= MAX_NV:
    raise ValueError(f'the kernel takes 1 <= nv <= {MAX_NV}, got {nv}')
  if cap < 0:
    raise ValueError(f'cap must be >= 0, got {cap}')
  if not all(t.is_contiguous() for t in floats + (dof,)):
    raise ValueError('the kernel takes contiguous tensors')


def newton(qm, qs, j, aref, dvec, eqf, s_aref, s_dvec, dof, sign, *groups,
           cap: int, tol: float):
  """Newton solve over dense and one-hot rows; shapes as newton_reference.

  On the CPU, newton_reference; on CUDA, the kernel, which adds one to
  `newton.launches` per launch. `groups` (the factored contact-point
  operands of newton_batched) are not ported yet and raise. The kernel
  reads dof only to compare it with 0..nv-1, so an out-of-range dof drops
  the row instead of reaching outside the sample's memory."""
  if groups:
    raise NotImplementedError(
        'factored contact-point groups are not ported yet (ROADMAP A6)')
  operands = (qm, qs, j, aref, dvec, eqf, s_aref, s_dvec, dof, sign)
  if all(t.device.type == 'cpu' for t in operands):
    return newton_reference(*operands, cap=cap, tol=tol)
  _check(*operands, cap)
  bsz, nv = qs.shape
  n, ns = j.shape[1], s_aref.shape[1]
  qacc = torch.empty_like(qs)
  jar_d = torch.empty_like(aref)
  jar_s = torch.empty_like(s_aref)
  if bsz == 0:
    return qacc, jar_d, jar_s
  err = _entry()(
      *(t.data_ptr() for t in operands), qacc.data_ptr(), jar_d.data_ptr(),
      jar_s.data_ptr(), bsz, nv, n, ns, int(cap), float(tol),
      torch.cuda.current_stream(qs.device).cuda_stream)
  cuda_build.check(err, 'newton kernel')
  newton.launches += 1
  return qacc, jar_d, jar_s


newton.launches = 0
