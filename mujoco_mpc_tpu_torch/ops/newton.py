"""Batched primal-Newton constraint solve: the CUDA kernel B2 and its plain
version.

Port of mujoco_mpc_tpu/ops/pallas_newton.py: the fused Pallas kernel
_newton_kernel (:222) behind newton_batched (:631), for dense rows,
one-hot-scalar rows and the factored pyramidal contact-point groups; the
facet table PYRAMID_FACETS (:79), expand_group (:90) and materialize_jd
(:126), the group stacking of _newton_reference (:807-815) as
`expand_groups`; and the reference loop _newton_reference (:792) as
`newton_reference`, batch first. The kernel is csrc/newton.cu.

Dispatch is by device only: a CPU tensor takes `newton_reference`, a CUDA
tensor the kernel, and anything the kernel cannot take raises.

`NewtonSolve` is the torch.autograd.Function every caller goes through
(physics/constraint.solve). Its `jvp` is make_newton's custom_jvp
(_newton_jvp :1053-1190): the implicit-function tangent with the converged
active set frozen, over dense rows, one-hot rows (:1130-1136) and the
point groups, folded into the dense block first as :1083-1111 does. Its
H solve goes through ops/spd_solve.SpdSolve, so on the card the tangent
runs on the kernel B1, and under `torch.func.jacfwd` the tangent
directions fold into one B1 launch. Its `vmap` rule folds the mapped
dimension into the batch: one B2 launch. The kernel is launched only from
`forward`, which sees plain tensors. Not ported yet: elliptic-cone and
frictionloss rows and their tangents (ROADMAP A8).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mujoco_mpc_tpu_torch.ops import cuda_build
from mujoco_mpc_tpu_torch.ops import linalg
from mujoco_mpc_tpu_torch.ops import spd_solve

MAX_NV = 32
MAX_GROUPS = 4
# The kernel's compile-time dof buckets, and the shared memory one block
# may hold on Hopper (cudaDevAttrMaxSharedMemoryPerBlockOptin, 227 KB).
NV_BUCKETS = (2, 4, 8, 12, 18, 24, 32)
SMEM_LIMIT = 232448
_DAMP = 1e-10
_ALPHAS = (0.0, 1.0, 0.5, 0.25, 0.0625)

# Pyramidal contact facets in point-direction form: a condim-c contact
# contributes one one-sided facet row per entry (di, mucol, sign),
# row = jd[0] + sign * mu[mucol] * jd[di] over its direction Jacobians
# jd = (normal, t1, t2[, rn, rt1, rt2]); condim 1 is the bare normal.
PYRAMID_FACETS = {
    1: ((0, 0, 0.0),),
    3: ((1, 0, 1.0), (1, 0, -1.0), (2, 0, 1.0), (2, 0, -1.0)),
    4: ((1, 0, 1.0), (1, 0, -1.0), (2, 0, 1.0), (2, 0, -1.0),
        (3, 1, 1.0), (3, 1, -1.0)),
    6: ((1, 0, 1.0), (1, 0, -1.0), (2, 0, 1.0), (2, 0, -1.0),
        (3, 1, 1.0), (3, 1, -1.0),
        (4, 2, 1.0), (4, 2, -1.0), (5, 2, 1.0), (5, 2, -1.0)),
}


def expand_group(jd, aref, dvec, mu, condim):
  """Facet-expand one point group to dense one-sided rows, facet-major.

  jd (B, P, ndirs, nv), aref (B, nrep, P), dvec (B, P), mu (B, 3, P) ->
  (j (B, nrep*P, nv), aref (B, nrep*P), dvec (B, nrep*P))."""
  facets = PYRAMID_FACETS[condim]
  jn = jd[:, :, 0]
  rows = [jn + sgn * mu[:, col, :, None] * jd[:, :, di] if sgn else jn
          for (di, col, sgn) in facets]
  bsz, p = dvec.shape
  return (torch.cat(rows, 1), aref.reshape(bsz, len(facets) * p),
          dvec.repeat(1, len(facets)))


def materialize_jd(g, cdofc, dmask):
  """jd (B, P, ndirs, nv) from factored G (B, P, ndirs, 6), cdofc
  (B, nv, 6) and the model constant dmask (P, nv):
  jd[p, d, n] = (G[p, d] . cdofc[n]) * dmask[p, n]."""
  jd = torch.einsum('bpdj,bnj->bpdn', g, cdofc)
  return jd * dmask.to(jd.dtype)[:, None, :]


def expand_groups(j, aref, dvec, eqf, gargs, condims, dmasks):
  """The dense rows (j, aref, dvec, eqf) with every point group's facet
  rows appended in group order, as _newton_reference stacks them
  (:807-815) -> (j, aref, dvec, eqf, [(nrep, P) of each group])."""
  gsizes = []
  for gi, cdim in enumerate(condims):
    g, garef, gdvec, gmu = gargs[1 + 4 * gi:5 + 4 * gi]
    ej, ea, ed = expand_group(materialize_jd(g, gargs[0], dmasks[gi]),
                              garef, gdvec, gmu, cdim)
    gsizes.append(tuple(garef.shape[1:]))
    j = torch.cat([j, ej], 1)
    aref = torch.cat([aref, ea], 1)
    dvec = torch.cat([dvec, ed], 1)
    eqf = torch.cat([eqf, torch.zeros_like(ea)], 1)
  return j, aref, dvec, eqf, gsizes


def newton_reference(qm, qs, j, aref, dvec, eqf, s_aref, s_dvec, dof, sign,
                     *gargs, cap: int, tol: float, condims=(), dmasks=()):
  """Plain batch-first Newton solve.

  qm (B, nv, nv), qs (B, nv), j (B, n, nv), aref/dvec/eqf (B, n),
  s_aref/s_dvec (B, ns), dof (ns,) int, sign (ns,) float; with point
  groups (`condims` non-empty), gargs = (cdofc (B, nv, 6), then per group
  g (B, P, ndirs, 6), aref (B, nrep, P), dvec (B, P), mu (B, 3, P)) and
  `dmasks` the groups' (P, nv) masks -> (qacc (B, nv), jar_d (B, n),
  jar_s (B, ns), *jar_g (B, nrep, P)).

  The groups are facet-expanded into the dense block and their jars split
  back out, as _newton_reference does (:799-815). Runs `cap` iterations
  with per-sample done masks and frozen finished samples, which is what
  the vmapped while_loop computes, and never reads a tensor value on the
  host, so on the card it queues without a sync."""
  bsz, nv = qs.shape
  n_dense = j.shape[1]
  j, aref, dvec, eqf, gsizes = expand_groups(j, aref, dvec, eqf, gargs,
                                             condims, dmasks)
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
  jar_groups = []
  off = n_dense
  for (nrep, p) in gsizes:
    jar_groups.append(jar_d[:, off:off + nrep * p].reshape(bsz, nrep, p))
    off += nrep * p
  return (qacc, jar_d[:, :n_dense], jar_s) + tuple(jar_groups)


class _Group(ctypes.Structure):
  """One contact-point group at the kernel's C interface (MjpcNewtonGroup
  in csrc/newton.cu)."""
  _fields_ = [('g', ctypes.c_void_p), ('aref', ctypes.c_void_p),
              ('dvec', ctypes.c_void_p), ('mu', ctypes.c_void_p),
              ('dmask', ctypes.c_void_p), ('jar', ctypes.c_void_p),
              ('p', ctypes.c_int), ('condim', ctypes.c_int)]


@functools.lru_cache(maxsize=None)
def _entry():
  fn = cuda_build.load('newton').mjpc_newton_f32
  p = ctypes.c_void_p
  i = ctypes.c_int
  fn.argtypes = ([p] * 13 + [i, i, i, i, i, ctypes.c_float]
                 + [p, ctypes.POINTER(_Group), i, p])
  fn.restype = ctypes.c_int
  return fn


def kernel_lanes(nv):
  """Lanes of the tile that solves one sample: the smallest power of two
  >= nv's bucket (csrc/newton.cu `lanes`)."""
  bucket = next(b for b in NV_BUCKETS if b >= nv)
  return max(2, 1 << (bucket - 1).bit_length())


def sample_smem_bytes(nv, n, ns, groups=()):
  """Shared memory the kernel stages one sample into, in bytes, for n
  dense rows, ns one-hot rows and point groups ((condim, P), ...): its
  rows (dense, then facet) at a stride of the bucket plus one, five floats
  per row, M, the factor or (while staging) one group's G and mu, the
  step, and two floats per one-hot row (csrc/newton.cu `layout`)."""
  bucket = next(b for b in NV_BUCKETS if b >= nv)
  rows = n + sum(len(PYRAMID_FACETS[c]) * p for c, p in groups)
  stage = max([bucket * (bucket + 1)]
              + [p * (6 * c + 3) for c, p in groups])
  return 4 * (rows * (bucket + 6) + bucket * (bucket + 2) + stage + 2 * ns)


def _check(qm, qs, j, aref, dvec, eqf, s_aref, s_dvec, dof, sign, cap,
           gargs, condims, dmasks):
  """Refuse what the kernel does not take (it never falls back)."""
  floats = (qm, qs, j, aref, dvec, eqf, s_aref, s_dvec, sign) + tuple(
      gargs) + tuple(dmasks)
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
  if len(condims) > MAX_GROUPS or len(set(condims)) != len(condims) \
     or any(c not in PYRAMID_FACETS for c in condims):
    raise ValueError(f'the kernel takes at most one group per condim in '
                     f'{sorted(PYRAMID_FACETS)}, got condims {condims}')
  if len(gargs) != (1 + 4 * len(condims) if condims else 0) \
     or len(dmasks) != len(condims):
    raise ValueError(f'{len(condims)} groups need '
                     f'{1 + 4 * len(condims) if condims else 0} group '
                     f'operands and {len(condims)} dmasks, got '
                     f'{len(gargs)} and {len(dmasks)}')
  if condims:
    want['cdofc'] = (gargs[0], (bsz, nv, 6))
  for gi, cdim in enumerate(condims):
    g, garef, gdvec, gmu = gargs[1 + 4 * gi:5 + 4 * gi]
    p = g.shape[1] if g.dim() == 4 else -1
    nrep = len(PYRAMID_FACETS[cdim])
    want.update({
        f'g[{gi}]': (g, (bsz, p, cdim, 6)),     # condim directions a point
        f'aref[{gi}]': (garef, (bsz, nrep, p)),
        f'dvec[{gi}]': (gdvec, (bsz, p)), f'mu[{gi}]': (gmu, (bsz, 3, p)),
        f'dmask[{gi}]': (dmasks[gi], (p, nv))})
  for name, (t, shape) in want.items():
    if min(shape) < 0 or tuple(t.shape) != shape:
      raise ValueError(f'{name}: expected shape {shape}, got '
                       f'{tuple(t.shape)}')
  if not 1 <= nv <= MAX_NV:
    raise ValueError(f'the kernel takes 1 <= nv <= {MAX_NV}, got {nv}')
  # a block holds at least one warp of samples
  warp = 32 // kernel_lanes(nv) * sample_smem_bytes(
      nv, n, ns, [(c, gargs[1 + 4 * gi].shape[1])
                  for gi, c in enumerate(condims)])
  if warp > SMEM_LIMIT:
    raise ValueError(f'one warp of samples needs {warp} bytes of shared '
                     f'memory, more than the {SMEM_LIMIT} a block may hold '
                     f'on Hopper')
  if cap < 0:
    raise ValueError(f'cap must be >= 0, got {cap}')
  if not all(t.is_contiguous() for t in floats + (dof,)):
    raise ValueError('the kernel takes contiguous tensors')


def _newton(qm, qs, j, aref, dvec, eqf, s_aref, s_dvec, dof, sign, *gargs,
            cap: int, tol: float, condims=(), dmasks=()):
  """The device dispatch on plain tensors: newton_reference on the CPU,
  the kernel on CUDA."""
  operands = (qm, qs, j, aref, dvec, eqf, s_aref, s_dvec, dof, sign)
  if all(t.device.type == 'cpu'
         for t in operands + tuple(gargs) + tuple(dmasks)):
    return newton_reference(*operands, *gargs, cap=cap, tol=tol,
                            condims=condims, dmasks=dmasks)
  _check(*operands, cap, gargs, condims, dmasks)
  bsz, nv = qs.shape
  n, ns = j.shape[1], s_aref.shape[1]
  qacc = torch.empty_like(qs)
  jar_d = torch.empty_like(aref)
  jar_s = torch.empty_like(s_aref)
  jar_g = tuple(torch.empty_like(gargs[2 + 4 * gi])
                for gi in range(len(condims)))
  if bsz == 0:
    return (qacc, jar_d, jar_s) + jar_g
  groups = (_Group * MAX_GROUPS)()
  for gi, cdim in enumerate(condims):
    g, garef, gdvec, gmu = gargs[1 + 4 * gi:5 + 4 * gi]
    groups[gi] = _Group(g.data_ptr(), garef.data_ptr(), gdvec.data_ptr(),
                        gmu.data_ptr(), dmasks[gi].data_ptr(),
                        jar_g[gi].data_ptr(), g.shape[1], cdim)
  err = _entry()(
      *(t.data_ptr() for t in operands), qacc.data_ptr(), jar_d.data_ptr(),
      jar_s.data_ptr(), bsz, nv, n, ns, int(cap), float(tol),
      gargs[0].data_ptr() if condims else None, groups, len(condims),
      torch.cuda.current_stream(qs.device).cuda_stream)
  cuda_build.check(err, 'newton kernel')
  newton.launches += 1
  return (qacc, jar_d, jar_s) + jar_g


def _mv(a, x):
  return (a @ x[..., None])[..., 0]


def _expand_group_jvp(g, garef, gdvec, gmu, cdofc, dmask, tangents, condim):
  """Tangent of expand_group(materialize_jd(g, cdofc, dmask), garef, gdvec,
  gmu, condim) (bilinear in jd and mu): (dj, daref, ddvec); `tangents`
  (dg, dgaref, dgdvec, dgmu, dcdofc), None for no tangent."""
  dg, dgaref, dgdvec, dgmu, dcdofc = tangents
  jd = materialize_jd(g, cdofc, dmask)
  djd = 0.0
  if dg is not None:
    djd = djd + materialize_jd(dg, cdofc, dmask)
  if dcdofc is not None:
    djd = djd + materialize_jd(g, dcdofc, dmask)
  if not torch.is_tensor(djd):
    djd = torch.zeros_like(jd)
  rows = []
  for (di, col, sgn) in PYRAMID_FACETS[condim]:
    row = djd[:, :, 0]
    if sgn:
      row = row + sgn * gmu[:, col, :, None] * djd[:, :, di]
      if dgmu is not None:
        row = row + sgn * dgmu[:, col, :, None] * jd[:, :, di]
    rows.append(row)
  bsz, p = gdvec.shape
  nrep = len(PYRAMID_FACETS[condim])
  daref = (dgaref.reshape(bsz, nrep * p) if dgaref is not None
           else torch.zeros_like(garef).reshape(bsz, nrep * p))
  ddvec = (dgdvec.repeat(1, nrep) if dgdvec is not None
           else torch.zeros_like(gdvec).repeat(1, nrep))
  return torch.cat(rows, 1), daref, ddvec


class NewtonSolve(torch.autograd.Function):
  """The Newton solve (operands and results as newton_reference) with the
  frozen-active-set tangent and a vmap rule that folds the mapped
  dimension into B. `apply(cap, tol, condims, qm, qs, j, aref, dvec, eqf,
  s_aref, s_dvec, dof, sign, *gargs, *dmasks)`."""

  @staticmethod
  def forward(cap, tol, condims, *operands):
    k = len(operands) - len(condims)
    out = _newton(*operands[:k], cap=cap, tol=tol, condims=condims,
                  dmasks=operands[k:])
    # an output may not be an input (cap 0 returns qs itself)
    return tuple(o.clone() if any(o is t for t in operands) else o
                 for o in out)

  @staticmethod
  def setup_context(ctx, inputs, output):
    cap, tol, condims, *operands = inputs
    ctx.condims = condims
    ctx.save_for_forward(*operands, *output)

  @staticmethod
  def jvp(ctx, _dcap, _dtol, _dcondims, *tangents):
    condims = ctx.condims
    saved = ctx.saved_tensors
    nin = len(tangents)
    operands, outs = saved[:nin], saved[nin:]
    k = nin - len(condims)
    qm, qs, j, aref, dvec, eqf, s_aref, s_dvec, dof, sign = operands[:10]
    gargs, dmasks = operands[10:k], operands[k:]
    dqm, dqs, dj, daref, ddvec, _, ds_aref, ds_dvec = tangents[:8]
    dgargs = tangents[10:k]
    qacc, jar_d, jar_s = outs[:3]
    jar_groups = outs[3:]
    if dj is None:
      dj = torch.zeros_like(j)
    if daref is None:
      daref = torch.zeros_like(aref)
    if ddvec is None:
      ddvec = torch.zeros_like(dvec)

    # fold the point groups into the dense block (primal and tangent rows)
    n_dense = j.shape[1]
    bsz, nv = qs.shape
    gsizes = []
    for gi, cdim in enumerate(condims):
      gp = gargs[1 + 4 * gi:5 + 4 * gi]
      gt = tuple(dgargs[1 + 4 * gi:5 + 4 * gi]) + (dgargs[0],)
      ej, ea, ed = expand_group(materialize_jd(gp[0], gargs[0], dmasks[gi]),
                                *gp[1:], cdim)
      dej, dea, ded = _expand_group_jvp(*gp, gargs[0], dmasks[gi], gt, cdim)
      gsizes.append(tuple(gp[1].shape[1:]))
      j = torch.cat([j, ej], 1)
      dj = torch.cat([dj, dej], 1)
      aref = torch.cat([aref, ea], 1)
      daref = torch.cat([daref, dea], 1)
      dvec = torch.cat([dvec, ed], 1)
      ddvec = torch.cat([ddvec, ded], 1)
      eqf = torch.cat([eqf, torch.zeros_like(ea)], 1)
      jar_d = torch.cat([jar_d, jar_groups[gi].reshape(bsz, -1)], 1)

    n, ns = j.shape[1], s_aref.shape[1]
    dof = dof.long()
    e = qacc - qs
    h = qm + _DAMP * torch.eye(nv, dtype=qs.dtype, device=qs.device)
    rhs = torch.zeros_like(qs)
    if dqm is not None:
      rhs = rhs + _mv(dqm, e)
    if dqs is not None:
      rhs = rhs - _mv(qm, dqs)
    if n:
      active_d = torch.logical_or(jar_d < 0, eqf > 0.5)
      zero = torch.zeros_like(dvec)
      w_d = torch.where(active_d, dvec, zero)
      dw_d = torch.where(active_d, ddvec, zero)
      jt = j.transpose(1, 2)
      h = h + (jt * w_d[:, None, :]) @ j
      rhs = rhs + (_mv(dj.transpose(1, 2), w_d * jar_d)
                   + _mv(jt, dw_d * jar_d)
                   + _mv(jt, w_d * (_mv(dj, qacc) - daref)))
    if ns:
      active_s = jar_s < 0
      zero = torch.zeros_like(s_dvec)
      w_s = torch.where(active_s, s_dvec, zero)
      h = h + torch.diag_embed(torch.zeros_like(qs).index_add(1, dof, w_s))
      ds = 0.0
      if ds_dvec is not None:
        ds = ds + torch.where(active_s, ds_dvec, zero) * jar_s
      if ds_aref is not None:
        ds = ds - w_s * ds_aref
      if torch.is_tensor(ds):
        rhs = rhs.index_add(1, dof, sign * ds)
    dqacc = -spd_solve.SpdSolve.apply(h, rhs)
    if n:
      djar_d = _mv(dj, qacc) + _mv(j, dqacc) - daref
    else:
      djar_d = torch.zeros_like(jar_d)
    djar_s = sign * dqacc[:, dof]
    if ds_aref is not None:
      djar_s = djar_s - ds_aref
    djar_groups = []
    off = n_dense
    for (nrep, p) in gsizes:
      djar_groups.append(djar_d[:, off:off + nrep * p].reshape(-1, nrep, p))
      off += nrep * p
    return (dqacc, djar_d[:, :n_dense], djar_s) + tuple(djar_groups)

  @staticmethod
  def vmap(info, in_dims, cap, tol, condims, *operands):
    size = info.batch_size
    dims = in_dims[3:]
    k = len(operands) - len(condims)
    # dof, sign and the dmasks are model constants, shared by every sample
    shared = {8, 9} | set(range(k, len(operands)))
    if any(dims[i] is not None for i in shared):
      raise ValueError('dof, sign and the dmasks must not be mapped')
    folded = [t if i in shared else spd_solve.fold_batch(t, dims[i], size)
              for i, t in enumerate(operands)]
    out = NewtonSolve.apply(cap, tol, condims, *folded)
    return (tuple(o.reshape(size, o.shape[0] // size, *o.shape[1:])
                  for o in out), (0,) * len(out))


def newton(qm, qs, j, aref, dvec, eqf, s_aref, s_dvec, dof, sign, *gargs,
           cap: int, tol: float, condims=(), dmasks=()):
  """Newton solve over dense rows, one-hot rows and factored point groups;
  operands and results as newton_reference, through `NewtonSolve`.

  On the CPU, newton_reference; on CUDA, the kernel, which adds one to
  `newton.launches` per launch and expands each sample's facet rows from
  (G, cdofc, dmask) into shared memory itself: the (B, nrep*P, nv) facet
  block never reaches device memory. The kernel
  reads dof only to compare it with 0..nv-1, so an out-of-range dof drops
  the row instead of reaching outside the sample's memory."""
  return NewtonSolve.apply(int(cap), float(tol), tuple(condims), qm, qs, j,
                           aref, dvec, eqf, s_aref, s_dvec, dof, sign,
                           *gargs, *dmasks)


newton.launches = 0
