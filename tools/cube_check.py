"""Run the Cube Solving phases of chip_smoke.py alone on the card.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/cube_check.py

It builds both kernels (csrc/chol_solve.cu and csrc/newton.cu, at once),
prints ptxas's registers, stack and spills of every bucket instance (a
spill fails it after the checks), then runs chip_smoke's phases 3j (B1's
block instance on random systems, n 33-96), 3k (B2's block instance on
random dense, one-hot and frictionloss rows at nv 33 and 96), 3l (both
kernels on the Cube Solving step's inputs, B 512, nv 87), phase 4's Cube
Solving rows (kernel, plain version, B1's library call, bounds), 25 (the
512 x 26 Predictive Sampling plan from `home`) and 26 (its card-vs-CPU
golden at 64 candidates), beside the card's name and power limit. A
failed check exits non-zero.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mujoco_mpc_tpu_torch.tasks import registry  # noqa: E402


def main():
  elapsed, spilled = cs.tool_start('cube_check')
  gen = torch.Generator(device=cs.DEV).manual_seed(0)
  cs.check_spd_wide(gen)
  cs.check_newton_wide(gen)
  cube = registry.get_task('Cube Solving', device=cs.DEV)
  spd_in, n_in, _ = cs.check_cube_kernels(cube, gen)
  elapsed('the checks')
  cs.check(spilled == 0, f'an instance spills ({spilled} bytes)')
  cs.time_cube_kernels(cube, spd_in, n_in, gen, {})
  elapsed('the timing')
  cs.cube_phases(cube, registry.get_task('Cube Solving', device='cpu'), gen,
                 elapsed)


if __name__ == '__main__':
  main()
