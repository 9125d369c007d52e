"""Build and check the SPD-solve kernel (B1) alone on the card, in about two minutes.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/chol_check.py [timing]

It builds csrc/chol_solve.cu only and prints ptxas's register, stack and
spill report for every bucket instance (N 1 to 32) with the shared memory
a block takes, then runs chip_smoke.py's B1 checks against the plain
version (phase 3a: every n from 1 to 32 at B 1, 8192 and 8193; 3c, 3e, 3f
and 3g: the Cartpole, Quadruped, Humanoid Track and Shadow Reorient
steps' inputs, same tolerances) and times the kernel, the plain version
and torch.linalg's cholesky_ex + cholesky_solve at n 2 (B 8192, the
Cartpole step's systems), n 18 (B 4096, the Quadruped's), n 23 (B 512,
the Humanoid's), n 21 (B 8192, Shadow's) and n 24 and 32 (B 4096, random
systems), each with its
bound, beside the card's name and power limit. A failed check exits
non-zero at once; a spilling instance, after the timing. With `timing` it
skips the checks.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mujoco_mpc_tpu_torch.ops import cuda_build  # noqa: E402
from mujoco_mpc_tpu_torch.tasks import registry  # noqa: E402


def main():
  if not torch.cuda.is_available():
    raise SystemExit('chol_check: no CUDA device')
  print(cs.smi_line(), f'(torch {torch.__version__})')
  torch.backends.cuda.matmul.allow_tf32 = False
  t0 = time.perf_counter()
  lib = cuda_build.build('chol_solve')
  cuda_build.load('chol_solve')
  print(f'build: chol_solve.cu in {time.perf_counter() - t0:.1f} s')
  lines, spilled = cs.ptxas_lines('chol_solve', lib)
  print('\n'.join(lines))

  checks = sys.argv[1:] != ['timing']
  gen = torch.Generator(device=cs.DEV).manual_seed(0)
  if checks:
    cs.check_spd_random(gen)
  shapes = []
  for name, states, tol, phase, plain_reps in (
      ('Cartpole', cs.cartpole_states, 1e-5, '3c', cs.TIME_REPS),
      ('Quadruped Flat', cs.quadruped_states, 1e-4, '3e', cs.TIME_REPS),
      ('Humanoid Track', cs.humanoid_states, 1e-4, '3f',
       cs.HUMAN_PLAIN_REPS),
      ('Shadow Reorient', cs.shadow_states, 1e-4, '3g',
       cs.SHADOW_PLAIN_REPS)):
    task = registry.get_task(name, device=cs.DEV)
    spd_in, _ = cs.solver_inputs(task, states(task, gen))
    if checks:
      _, err = cs.check_spd_inputs(spd_in, tol, name)
      print(f'phase {phase} {name} step inputs (B {spd_in[0].shape[0]}, n '
            f'{spd_in[0].shape[1]}): chol_solve rel err {err:.3g} (tol '
            f'{tol:g})')
    shapes.append((spd_in, plain_reps))
  shapes += [
      (cs.random_spd(gen, cs.QUAD_SAMPLES, n), cs.SPD_EXTRA_PLAIN_REPS)
      for n in cs.SPD_EXTRA_N]
  for spd_in, plain_reps in shapes:
    print(f'timing per call, wall (median of {cs.TIME_REPS}, CUDA events) / '
          'device only (profiler): '
          + cs.spd_timing_line(*cs.time_spd(spd_in, plain_reps), spd_in[0]))
  cs.check(spilled == 0, f'chol_solve: the instances spill {spilled} bytes')
  done = 'all checks passed' if checks else 'timed'
  print(f'chol_check: {done} in {time.perf_counter() - t0:.1f} s')


if __name__ == '__main__':
  main()
