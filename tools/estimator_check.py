"""Run the estimator phases of chip_smoke.py alone on the card.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/estimator_check.py

It builds both kernels (csrc/chol_solve.cu and csrc/newton.cu, at once),
prints ptxas's registers, stack and spills of every bucket instance (a
spill fails it after the checks), then runs chip_smoke's phase 3m (both
kernels against their plain versions on the operands of one EKF and one
UKF update on Quadruped Flat), phase 4's estimator rows (kernel, plain
version, B1's library call, bounds at B1's B 1, 36 and 73 and B2's B 1
and 73), and phases 27 (sensordata card vs CPU), 28 (EKF), 29 (UKF) and
30 (the batch estimator), beside the card's name and power limit. A
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
  elapsed, spilled = cs.tool_start('estimator_check')
  gen = torch.Generator(device=cs.DEV).manual_seed(0)
  quad = registry.get_task('Quadruped Flat', device=cs.DEV)
  truth = cs.estimator_truth(quad, max(cs.EST_UPDATES, cs.BATCH_WINDOW), 17)
  start_state = cs.filter_start(quad, truth, 19)
  inputs = cs.estimator_kernel_inputs(quad, truth, start_state)
  cs.check_estimator_kernels(inputs)
  elapsed('the checks')
  cs.check(spilled == 0, f'an instance spills ({spilled} bytes)')
  cs.time_estimator_kernels(inputs, {})
  elapsed('the timing')
  cs.estimator_phases(quad, registry.get_task('Quadruped Flat', device='cpu'),
                      gen, elapsed, truth, start_state)


if __name__ == '__main__':
  main()
