"""Batched small SPD solve: the CUDA kernel B1 and its plain version.

Port of mujoco_mpc_tpu/ops/pallas_linalg.py (the Pallas kernel
_chol_solve_kernel :32 behind solve_spd_batched :70, and the solve_spd
dispatch seam :114-145), and the implicit-function rule the JAX callers
wrap it in (`jax.lax.custom_linear_solve`, physics/forward.py:25-36 and
ops/pallas_newton.py:1166-1169). The kernel is csrc/chol_solve.cu; its
plain PyTorch version is ops/linalg.solve_spd.

`SpdSolve` is the torch.autograd.Function every caller goes through. Its
tangent is dx = a^-1 (db - da x), one more call of the same Function, so
on the card the tangent runs on the kernel too. Its `vmap` rule folds the
mapped dimension into the batch: under `torch.func.jacfwd` (a vmap of
jvp) the D tangent directions of a (B, n) solve share `a` and become one
launch at B * D. The kernel is launched only from `forward`, which always
sees plain tensors; `jvp` and `vmap` call the Function again.

Dispatch is by device only: a CPU tensor takes the plain version, a CUDA
tensor the kernel, and anything the kernel cannot take raises. There is
no size gate: the TPU's MIN_PALLAS_N = 12 (:28) was a TPU measurement, and
on the card the kernel takes every n from 1 to 32 (a gate that sent small
n to the plain version or a library call would be a fallback).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mujoco_mpc_tpu_torch.ops import cuda_build
from mujoco_mpc_tpu_torch.ops import linalg

MAX_N = 32
# the kernel's compile-time sizes: n runs in the smallest bucket >= n
N_BUCKETS = (1, 2, 3, 4, 6, 8, 12, 18, 24, 32)
THREADS = 64


@functools.lru_cache(maxsize=None)
def _entry():
  fn = cuda_build.load('chol_solve').mjpc_chol_solve_f32
  p = ctypes.c_void_p
  fn.argtypes = [p, p, p, ctypes.c_int, ctypes.c_int, p]
  fn.restype = ctypes.c_int
  return fn


def _bucket(n: int) -> int:
  if not 1 <= n <= MAX_N:
    raise ValueError(f'the kernel takes 1 <= n <= {MAX_N}, got {n}')
  return next(k for k in N_BUCKETS if k >= n)


def kernel_lanes(n: int) -> int:
  """Lanes of the tile that solves one system: the smallest power of two
  >= n's bucket, at least 2 and at most 8 (csrc/chol_solve.cu `lanes`);
  a lane holds ceil(bucket / lanes) rows."""
  return min(8, max(2, 1 << (_bucket(n) - 1).bit_length()))


def block_smem_bytes(n: int) -> int:
  """Static shared memory a block of the kernel takes, in bytes: THREADS
  / L systems, each an (N, N + 1) float32 block for the bucket N
  (csrc/chol_solve.cu `block_floats`)."""
  bucket = _bucket(n)
  return 4 * THREADS // kernel_lanes(n) * bucket * (bucket + 1)


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
  """Refuse what the kernel does not take (it never falls back)."""
  cuda_build.require_cuda(a, b)
  if a.device != b.device:
    raise ValueError(f'a on {a.device}, b on {b.device}')
  if a.dtype != torch.float32 or b.dtype != torch.float32:
    raise TypeError(f'the kernel takes float32, got {a.dtype}, {b.dtype}')
  if a.dim() != 3 or b.dim() != 2 or a.shape[1] != a.shape[2] \
     or tuple(b.shape) != tuple(a.shape[:2]):
    raise ValueError(f'expected a (B, n, n), b (B, n); got {tuple(a.shape)}'
                     f', {tuple(b.shape)}')
  _bucket(a.shape[-1])
  if not (a.is_contiguous() and b.is_contiguous()):
    raise ValueError('the kernel takes contiguous tensors')


def _solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """The device dispatch on plain tensors: the plain version on the CPU,
  the kernel on CUDA (which adds one to `solve_spd.launches` a launch)."""
  if a.device.type == 'cpu' and b.device.type == 'cpu':
    return linalg.solve_spd(a, b)
  _check(a, b)
  x = torch.empty_like(b)
  if b.shape[0] == 0:
    return x
  err = _entry()(a.data_ptr(), b.data_ptr(), x.data_ptr(), b.shape[0],
                 b.shape[1], torch.cuda.current_stream(a.device).cuda_stream)
  cuda_build.check(err, 'chol_solve kernel')
  solve_spd.launches += 1
  return x


def fold_batch(x: torch.Tensor, dim, size: int) -> torch.Tensor:
  """x with its mapped dimension `dim` moved to the front (or, unmapped,
  broadcast to `size`) and folded into the batch dimension after it."""
  x = x.movedim(dim, 0) if dim is not None else x.expand(size, *x.shape)
  return x.reshape(-1, *x.shape[2:])


class SpdSolve(torch.autograd.Function):
  """x = a^-1 b, a (B, n, n) SPD, b (B, n), with the implicit-function
  tangent of `custom_linear_solve` and a vmap rule that folds the mapped
  dimension into B."""

  @staticmethod
  def forward(a, b):
    return _solve(a, b)

  @staticmethod
  def setup_context(ctx, inputs, output):
    ctx.save_for_forward(inputs[0], output)

  @staticmethod
  def jvp(ctx, da, db):
    a, x = ctx.saved_tensors
    rhs = db if db is not None else torch.zeros_like(x)
    if da is not None:
      rhs = rhs - (da @ x[..., None])[..., 0]
    return SpdSolve.apply(a, rhs)

  @staticmethod
  def vmap(info, in_dims, a, b):
    size = info.batch_size
    x = SpdSolve.apply(fold_batch(a, in_dims[0], size),
                       fold_batch(b, in_dims[1], size))
    return x.reshape(size, x.shape[0] // size, x.shape[-1]), 0


def solve_spd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """x = a^-1 b for a batch of SPD systems: a (B, n, n), b (B, n), through
  `SpdSolve`: on the CPU the plain version, on CUDA the kernel, which adds
  one to `solve_spd.launches` per launch."""
  return SpdSolve.apply(a, b)


solve_spd.launches = 0
