"""Run the planner phases of chip_smoke.py (21-24) alone on the card.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/planner_check.py

It builds both kernels (csrc/chol_solve.cu and csrc/newton.cu, at once),
checks and times both at the Cartpole step's inputs (chip_smoke's phases
3c and 4 at B 8192, whose shapes Cross Entropy's, Sample Gradient's and
Gradient's line search share) and at the shapes the planner paths add
(phase 4's rows for them), then runs phases 21-24: Cross Entropy,
Sample Gradient, Gradient and iLQS on Cartpole at 8192 candidates x 101
steps (and iLQS with its iLQG branch forced), their card-vs-CPU goldens
with Robust Sampling's on Quadruped Flat, Robust Sampling on Quadruped
Flat at 4096 x 36, and testspeed for all seven planner ids, beside the
card's name and power limit. A failed check exits non-zero.
"""

import concurrent.futures
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mujoco_mpc_tpu_torch.ops import cuda_build  # noqa: E402
from mujoco_mpc_tpu_torch.physics.model import make_data  # noqa: E402
from mujoco_mpc_tpu_torch.tasks import registry  # noqa: E402


def main():
  if not torch.cuda.is_available():
    raise SystemExit('planner_check: no CUDA device')
  print(cs.smi_line(), f'(torch {torch.__version__})')
  torch.backends.cuda.matmul.allow_tf32 = False
  start = time.perf_counter()

  def elapsed(phases):
    print(f'elapsed after {phases}: {time.perf_counter() - start:.1f} s')

  with concurrent.futures.ThreadPoolExecutor(2) as pool:
    list(pool.map(cuda_build.build, ('chol_solve', 'newton')))
  elapsed('the build')
  gen = torch.Generator(device=cs.DEV).manual_seed(0)
  cart = registry.get_task('Cartpole', device=cs.DEV)
  cart_cpu = registry.get_task('Cartpole', device='cpu')
  quad = registry.get_task('Quadruped Flat', device=cs.DEV)
  quad_cpu = registry.get_task('Quadruped Flat', device='cpu')
  spd_in, (n_args, _, _, _) = cs.solver_inputs(cart, cs.cartpole_states(
      cart, gen))
  cap = cart.model.opt.iterations
  spd_abs = cs.check_spd_inputs(spd_in, 1e-5, 'Cartpole')[0]
  newton_abs = cs.check_newton_cartpole(n_args, cap)[0]
  spd_times = cs.time_spd(spd_in, cs.PLAIN_REPS)
  n_wall, n_dev, n_bound, iters = cs.time_newton(
      n_args, (), dict(cap=cap, tol=1e-5), cs.PLAIN_REPS)
  kern = {'cartpole': dict(wall={**spd_times[0], **n_wall},
                           dev={**spd_times[1], **n_dev},
                           spd_bound=spd_times[2], newton_bound=n_bound)}
  print('Cartpole step inputs, wall / device only: '
        + cs.spd_timing_line(*spd_times, spd_in[0]) + '; '
        + cs.newton_timing_line(f'B {cs.CART_SAMPLES} nv 2 cap {cap}',
                                n_wall, n_dev, n_bound, iters,
                                cs.PLAIN_REPS))
  cs.planner_path_kernels(cart, quad, gen, kern, (spd_abs, newton_abs))
  elapsed('the kernels at the new paths\' shapes')
  d0 = make_data(cart.model).replace(qpos=torch.tensor([cs.CART_QPOS0],
                                                       device=cs.DEV))
  d0_cpu = make_data(cart_cpu.model).replace(
      qpos=torch.tensor([cs.CART_QPOS0]))
  home = quad.model.keyframe_qpos('home')[None]
  q_d0 = make_data(quad.model).replace(qpos=home)
  q_d0_cpu = make_data(quad_cpu.model).replace(qpos=home.cpu())
  cs.planner_phases(cart, cart_cpu, d0, d0_cpu, quad, quad_cpu, q_d0,
                    q_d0_cpu, gen, elapsed)


if __name__ == '__main__':
  main()
