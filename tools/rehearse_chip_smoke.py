"""Rehearse chip_smoke.py on the CPU, at a small size, without a card.

Every phase runs in order on CPU tensors: the kernel wrappers take their
plain versions (and count launches as the kernels would), the build step
and nvidia-smi are stubbed, CUDA-event timings become host timings and the
profiler's device times are 0. It checks the script's paths, shapes and
control flow before a run on the card; none of its numbers is a device
measurement. Run from the repository root (a few minutes):

    python tools/rehearse_chip_smoke.py [candidates] [ilqg | planners]

With `ilqg` it rehearses tools/ilqg_check.py (the iLQG phases) instead,
with `planners` tools/planner_check.py (phases 21-24: the other planners
at `candidates`, goldens at 32 candidates, 2 timed iterations, testspeed
over 0.05 s at 8 samples).
"""

import os
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from mujoco_mpc_tpu_torch.ops import cuda_build, newton, spd_solve  # noqa: E402
from mujoco_mpc_tpu_torch.tasks import registry  # noqa: E402


class _Event:
  """Host-clock stand-in for torch.cuda.Event."""

  def __init__(self, **_):
    self.t = 0.0

  def record(self):
    self.t = time.perf_counter()

  def synchronize(self):
    pass

  def elapsed_time(self, end):
    return (end.t - self.t) * 1e3


def _counted(fn, owner):
  """A kernel's dispatch, on the CPU its plain version, counting each call
  as a launch in `owner.launches` (the wrapper's count)."""
  def dispatch(*args, **kwargs):
    owner.launches += 1
    return fn(*args, **kwargs)
  return dispatch


def _fake_build(name):
  """No nvcc here: an empty library path and a ptxas log that reports
  every bucket instance in ptxas's format, with no registers or spills."""
  lib = os.path.join(ROOT, 'build', 'rehearsal', name + '.so')
  os.makedirs(os.path.dirname(lib), exist_ok=True)
  kernel, buckets = (('chol_solve_kernel', spd_solve.N_BUCKETS)
                     if name == 'chol_solve'
                     else ('newton_kernel', newton.NV_BUCKETS))
  with open(lib + '.log', 'w') as f:
    for nb in buckets:
      f.write(f"ptxas info : Compiling entry function '{kernel}ILi{nb}E' "
              "(rehearsal)\n"
              'ptxas info : 0 bytes stack frame, 0 bytes spill stores, 0 '
              'bytes spill loads\nptxas info : Used 0 registers\n')
  return lib


def main():
  modes = ('ilqg', 'planners')
  args = [a for a in sys.argv[1:] if a not in modes]
  mode = next((a for a in sys.argv[1:] if a in modes), None)
  samples = int(args[0]) if args else 32
  chip_smoke.DEV = 'cpu'
  chip_smoke.CART_SAMPLES = chip_smoke.QUAD_SAMPLES = samples
  chip_smoke.HUMAN_SAMPLES = chip_smoke.SHADOW_SAMPLES = samples
  chip_smoke.SHADOW_QPOS0 = samples // 4
  chip_smoke.CART_PLANS = chip_smoke.QUAD_PLANS = chip_smoke.HUMAN_PLANS = 2
  chip_smoke.SHADOW_PLANS = 2
  chip_smoke.TIME_REPS = 2
  chip_smoke.HUMAN_PLAIN_REPS = 1
  chip_smoke.PLANNER_SAMPLES = chip_smoke.ROBUST_SAMPLES = samples
  chip_smoke.GOLDEN_SAMPLES = 32
  chip_smoke.PLANNER_ITERS = chip_smoke.ROBUST_ITERS = 2
  chip_smoke.FORCED_ITERS = 1
  chip_smoke.TESTSPEED_TIME = 0.05
  chip_smoke.TESTSPEED_SAMPLES = 8
  chip_smoke.resident_blocks = lambda nv, threads, smem: 0
  chip_smoke.device_us = lambda fn, reps=2, top=0, **_: (
      fn(), (0.0, 0, []) if top else 0.0)[1]
  run = subprocess.run
  chip_smoke.subprocess = types.SimpleNamespace(run=lambda cmd, **kw: (
      types.SimpleNamespace(stdout='CPU rehearsal, no card\n')
      if cmd[0] == 'nvidia-smi' else run(cmd, **kw)))
  torch.cuda.is_available = lambda: True
  torch.cuda.synchronize = lambda *a: None
  torch.cuda.get_device_name = lambda *a: 'CPU rehearsal'
  torch.cuda.device_count = lambda: 1
  torch.cuda.Event = _Event
  cuda_build.build = _fake_build
  cuda_build.load = lambda name: None
  newton._newton = _counted(newton._newton, newton.newton)
  spd_solve._solve = _counted(spd_solve._solve, spd_solve.solve_spd)
  get_task = registry.get_task
  registry.get_task = lambda name, device='cuda', dtype=torch.float32: (
      get_task(name, device='cpu', dtype=dtype))
  if mode == 'ilqg':
    from tools import ilqg_check
    sys.argv = sys.argv[:1]
    ilqg_check.main()
  elif mode == 'planners':
    from tools import planner_check
    planner_check.main()
  else:
    chip_smoke.main()


if __name__ == '__main__':
  main()
