"""Run the iLQG phases of chip_smoke.py alone on the card, in a few minutes.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/ilqg_check.py [iterations]

It builds both kernels (csrc/chol_solve.cu and csrc/newton.cu, at once),
then runs chip_smoke.py's phase 3i (both Functions' jvp through the
kernels against the same Functions through the plain versions, at
Swimmer's derivative shapes and the Quadruped step's inputs), phase 4's
iLQG rows (B1 at the line search and at the derivative tangent, B2 at the
line search, with their bounds) and phases 17-20 (Particle and Swimmer
iLQG at 8 candidates x 51 and 201 steps, each with its card-vs-CPU
golden), beside the card's name and power limit. `iterations` sets the
timed iterations of both main paths (default: chip_smoke's 10 and 5). A
failed check exits non-zero.
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
from mujoco_mpc_tpu_torch.tasks import registry  # noqa: E402


def main():
  if not torch.cuda.is_available():
    raise SystemExit('ilqg_check: no CUDA device')
  print(cs.smi_line(), f'(torch {torch.__version__})')
  torch.backends.cuda.matmul.allow_tf32 = False
  start = time.perf_counter()
  with concurrent.futures.ThreadPoolExecutor(2) as pool:
    list(pool.map(cuda_build.build, ('chol_solve', 'newton')))
  print(f'build: both kernels in {time.perf_counter() - start:.1f} s')
  iters = int(sys.argv[1]) if len(sys.argv) > 1 else None
  gen = torch.Generator(device=cs.DEV).manual_seed(0)
  swim = registry.get_task('Swimmer', device=cs.DEV)
  part = registry.get_task('Particle', device=cs.DEV)
  quad = registry.get_task('Quadruped Flat', device=cs.DEV)
  _, (q_args, q_gargs, q_condims, q_dmasks) = cs.solver_inputs(
      quad, cs.quadruped_states(quad, gen))
  cs.check_tangents(gen, swim, (q_args, q_gargs, dict(
      cap=quad.model.opt.iterations, tol=1e-5, condims=q_condims,
      dmasks=q_dmasks)))
  print(f'elapsed after 3i: {time.perf_counter() - start:.1f} s')
  cs.time_ilqg_kernels(gen, part, swim, {})
  print(f'elapsed after 4: {time.perf_counter() - start:.1f} s')
  for phase, name, spec, n in ((17, 'Particle', part, cs.PARTICLE_ITERS),
                               (19, 'Swimmer', swim, cs.SWIMMER_ITERS)):
    n = iters or n
    r = cs.ilqg_main_path(spec, n, cs.ILQG_CANDIDATES)
    cs.print_ilqg_path(phase, name, cs.ILQG_CANDIDATES, n, r)
    print(f'elapsed after {phase}: {time.perf_counter() - start:.1f} s')
    cs.print_ilqg_golden(phase + 1, name, cs.ilqg_golden(
        spec, registry.get_task(name, device='cpu'), r['first'],
        cs.ILQG_CANDIDATES))
    print(f'elapsed after {phase}-{phase + 1}: '
          f'{time.perf_counter() - start:.1f} s')


if __name__ == '__main__':
  main()
