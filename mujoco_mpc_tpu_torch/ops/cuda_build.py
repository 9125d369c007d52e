"""Build the CUDA kernels of csrc/ with nvcc and load them with ctypes.

No JAX counterpart: it stands in for the compile step `pl.pallas_call`
does. Each source compiles on first use, for Hopper (sm_90a), into a
shared library with a plain C interface under build/kernels/ at the root
of the checkout, named by a hash of the source and the flags, so a changed
source never loads a stale library. Also the device check the kernel
wrappers share. Nothing here runs when a module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG), 'build', 'kernels')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


def _nvcc() -> str:
  path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
  if not os.path.exists(path):
    raise RuntimeError('nvcc not found: the CUDA kernels build only on a '
                       'machine with the CUDA toolkit')
  return path


def build(name: str) -> str:
  """Compile csrc/<name>.cu if its library is missing; return its path.
  The compiler's register/spill report goes to <library>.log."""
  src = os.path.join(CSRC, name + '.cu')
  with open(src, 'rb') as f:
    digest = hashlib.sha256(f.read() + ' '.join(NVCC_FLAGS).encode())
  lib = os.path.join(BUILD_DIR, f'{name}-{digest.hexdigest()[:16]}.so')
  if os.path.exists(lib):
    return lib
  nvcc = _nvcc()
  os.makedirs(BUILD_DIR, exist_ok=True)
  tmp = f'{lib}.{os.getpid()}.tmp'
  proc = subprocess.run([nvcc, *NVCC_FLAGS, '-o', tmp, src],
                        capture_output=True, text=True, check=False)
  with open(lib + '.log', 'w') as f:
    f.write(proc.stdout + proc.stderr)
  if proc.returncode != 0:
    raise RuntimeError(f'nvcc failed on {src}:\n{proc.stderr[-4000:]}')
  os.replace(tmp, lib)
  return lib


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
  """The loaded library of csrc/<name>.cu, built on first use."""
  return ctypes.CDLL(build(name))


def require_cuda(*tensors) -> None:
  """Raise unless every tensor lies on a CUDA device."""
  for t in tensors:
    if t.device.type != 'cuda':
      raise ValueError(f'expected a CUDA tensor, got one on {t.device}')


def check(err: int, what: str) -> None:
  """Raise if a C entry point returned a CUDA error code."""
  if err != 0:
    raise RuntimeError(f'{what}: CUDA error {err} at launch')
