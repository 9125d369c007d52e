"""Run the box-pair phases of chip_smoke.py alone on the card.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/box_pairs_check.py

It builds both kernels (csrc/chol_solve.cu and csrc/newton.cu, at once),
prints ptxas's registers, stack and spills of every bucket instance (a
spill fails it after the checks), then runs chip_smoke's phase 3o (both
kernels on the step inputs of Walker, Bimanual Insert, Allegro Cube and
Humanoid Interact, B 4096 each, and their contact points card vs CPU
under the tie rule), phase 4's rows of those paths (kernel, plain
version, B1's library call, bounds, at each task's rollout batch and at
Allegro Cube's B 8193) and phases 38-43 (each task's plans at its own
settings and its card-vs-CPU golden, Humanoid Interact's plan-act loop
with a mode switch, Allegro Cube's 8192-candidate plan), beside the
card's name and power limit. A failed check exits non-zero.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mujoco_mpc_tpu_torch.tasks import registry  # noqa: E402


def main():
  elapsed, spilled = cs.tool_start('box_pairs_check')
  gen = torch.Generator(device=cs.DEV).manual_seed(0)
  specs = {n: registry.get_task(n, device=cs.DEV) for n in cs.BOX_TASKS}
  cpu = {n: registry.get_task(n, device='cpu') for n in cs.BOX_TASKS}
  states = {n: cs.check_box_kernels(specs[n], cpu[n], gen)
            for n in cs.BOX_TASKS}
  elapsed('the checks')
  cs.check(spilled == 0, f'an instance spills ({spilled} bytes)')
  cs.box_timing(specs, states, {})
  elapsed('the timing')
  cs.box_phases(specs, cpu, gen, elapsed)


if __name__ == '__main__':
  main()
