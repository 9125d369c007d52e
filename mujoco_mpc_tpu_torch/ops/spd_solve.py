"""Batched small SPD solve: the CUDA kernel B1 and its plain version.

Port of mujoco_mpc_tpu/ops/pallas_linalg.py (the Pallas kernel
_chol_solve_kernel :32 behind solve_spd_batched :70, and the solve_spd
dispatch seam :114-145). The kernel is csrc/chol_solve.cu; its plain
PyTorch version is ops/linalg.solve_spd.

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


def solve_spd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """x = a^-1 b for a batch of SPD systems: a (B, n, n), b (B, n).

  On the CPU, the plain version; on CUDA, the kernel, which adds one to
  `solve_spd.launches` per launch."""
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


solve_spd.launches = 0
