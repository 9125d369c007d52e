"""Build and check the Newton kernel (B2) alone on the card, in a minute or two.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/newton_check.py [timing]

It builds csrc/newton.cu only and prints ptxas's register, stack and
spill report for each nv bucket (a spill fails the run at its end), then
runs chip_smoke.py's B2 checks against the plain version (phases 3b-3e:
random dense and one-hot rows, the Cartpole step's inputs, random contact
groups, the Quadruped step's inputs) and phase 4's B2 timing at both
paths' shapes, with the bound and the card's name and power limit. Any
failed check exits non-zero. With `timing` it skips the checks (about 6
minutes of plain-version runs) and only builds, reports and times.
"""

import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mujoco_mpc_tpu_torch.ops import cuda_build, newton  # noqa: E402
from mujoco_mpc_tpu_torch.tasks import registry  # noqa: E402


def kernel_us(fn, reps=20):
  """Median device time of what fn() enqueues, in microseconds: CUDA
  events around fn() while the stream is still busy with a sleep kernel,
  so the host's launch overhead falls outside them."""
  times = []
  for _ in range(reps + 2):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2_000_000)
    start.record()
    fn()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end) * 1e3)
  return statistics.median(times[2:])


def main():
  if not torch.cuda.is_available():
    raise SystemExit('newton_check: no CUDA device')
  print(cs.smi_line(), f'(torch {torch.__version__})')
  torch.backends.cuda.matmul.allow_tf32 = False
  t0 = time.perf_counter()
  lib = cuda_build.build('newton')
  cuda_build.load('newton')
  print(f'build: newton.cu in {time.perf_counter() - t0:.1f} s')
  lines, spilled = cs.ptxas_lines('newton', lib)
  print('\n'.join(lines))

  checks = sys.argv[1:] != ['timing']
  gen = torch.Generator(device=cs.DEV).manual_seed(0)
  if checks:
    cs.check_newton_random(gen)
  cart = registry.get_task('Cartpole', device=cs.DEV)
  _, (cart_args, _, _, _) = cs.solver_inputs(
      cart, cs.cartpole_states(cart, gen))
  cart_cap = cart.model.opt.iterations
  if checks:
    _, err, active = cs.check_newton_cartpole(cart_args, cart_cap)
    print(f'phase 3c Cartpole step inputs (B {cs.CART_SAMPLES}, {active} '
          f'active limit rows): newton rel err {err:.3g} (tol 1e-4)')
    cs.check_newton_groups(gen)
  quad = registry.get_task('Quadruped Flat', device=cs.DEV)
  _, (q_args, q_gargs, q_condims, q_dmasks) = cs.solver_inputs(
      quad, cs.quadruped_states(quad, gen))
  q_kw = dict(cap=quad.model.opt.iterations, tol=1e-5, condims=q_condims,
              dmasks=q_dmasks)
  if checks:
    _, line = cs.check_newton_quadruped(q_args, q_gargs, q_kw)
    print(f'phase 3e Quadruped step inputs (B {cs.QUAD_SAMPLES}): {line}')

  for label, args, gargs, kw in (
      (f'Cartpole B {cs.CART_SAMPLES} nv 2 ns 2 cap {cart_cap}', cart_args,
       (), dict(cap=cart_cap, tol=1e-5)),
      (f'Quadruped B {cs.QUAD_SAMPLES} nv 18 ns 24 one condim-3 group P 20 '
       f'cap {q_kw["cap"]}', q_args, q_gargs, q_kw)):
    print(f'phase 4 timing per call, wall (median of {cs.TIME_REPS}, CUDA '
          f'events) / device only (profiler): '
          + cs.newton_timing_line(label, *cs.time_newton(args, gargs, kw)))
  # the kernel's time by iteration cap: cap 0 is the staging and the
  # writes alone, each further cap adds one iteration for the samples
  # that have not yet stopped
  for label, args, gargs, kw in (('Cartpole', cart_args, (), {}),
                                 ('Quadruped', q_args, q_gargs, q_kw)):
    kw = dict(kw, tol=1e-5)
    times = [kernel_us(lambda c=c: newton.newton(*args, *gargs, **dict(
        kw, cap=c))) for c in range(kw.get('cap', cart_cap) + 1)]
    print(f'newton device us by cap (CUDA events behind a busy stream), '
          f'{label}: ' + ', '.join(f'{c}: {us:.1f}'
                                   for c, us in enumerate(times)))
  cs.check(spilled == 0, f'newton: the instances spill {spilled} bytes')
  done = 'all checks passed' if checks else 'timed'
  print(f'newton_check: {done} in {time.perf_counter() - t0:.1f} s')


if __name__ == '__main__':
  main()
