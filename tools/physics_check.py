"""Run the physics slice's phases of chip_smoke.py alone on the card.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/physics_check.py

It builds both kernels (csrc/chol_solve.cu and csrc/newton.cu, at once),
prints ptxas's registers, stack and spills of every bucket instance (a
spill fails it after the checks), then runs chip_smoke's phase 3q (both
kernels on the step inputs of every model of assets/physics_models.npz:
the cylinder and ellipsoid pairs, tendons, equality constraints, RK4 and
gravity compensation, B 4096 each after 10 steps of rollouts; the new
pairs' contact points card vs CPU under the conditioning tie rule),
phase 4's rows of the five families (kernel, plain version, B1's library
call, bounds, at each family's largest row set) and phases 50-54 (each
model's 4096 x 100 rollout through forward.step, its launches a step
against the prediction, a profiled rollout, card vs CPU and the JAX
golden), beside the card's name and power limit. A failed check exits
non-zero.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
  elapsed, spilled = cs.tool_start('physics_check')
  gen = torch.Generator(device=cs.DEV).manual_seed(cs.PHYS_SEED)
  models, checked = cs.check_physics(gen)
  elapsed('3q')
  cs.check(spilled == 0, f'an instance spills ({spilled} bytes)')
  cs.physics_timing(models, checked, {})
  elapsed('the timing')
  cs.physics_phases(models, gen, elapsed)


if __name__ == '__main__':
  main()
