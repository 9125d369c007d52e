"""Build and check the Newton kernel (B2) alone on the card, in a minute or two.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/newton_check.py [timing]

It builds csrc/newton.cu only and prints ptxas's register, stack and
spill report for each nv bucket (a spill fails the run at its end), then
runs chip_smoke.py's B2 checks against the plain version (phases 3b-3g:
random dense and one-hot rows, the Cartpole step's inputs, random contact
groups, the Quadruped, Humanoid Track and Shadow Reorient steps' inputs)
and phase 4's B2 timing at the four paths' shapes, with the bound and the
card's name and power limit; then the time by iteration cap at each shape
(Shadow's at one block of 4 samples an SM), and at the
Quadruped shapes the time on states from three seeds with the iterations
per sample they take, the profiler's records counted both ways. Any
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


def profiled_us(fn, reps=cs.TIME_REPS):
  """B2's device time per call from one profiler pass over `reps` calls,
  counted both ways: its mean over the records the profiler kept times
  its launches a call, and its total over the calls."""
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(reps):
      fn()
    torch.cuda.synchronize()
  ev = [e for e in prof.key_averages() if 'newton_kernel' in e.key]
  cs.check(ev, 'the profiler saw no newton_kernel')
  return ev[0].self_device_time_total / ev[0].count, (
      ev[0].self_device_time_total / reps)


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
  shapes = {}
  for name, states, phase in (('Quadruped Flat', cs.quadruped_states, '3e'),
                              ('Humanoid Track', cs.humanoid_states, '3f'),
                              ('Shadow Reorient', cs.shadow_states, '3g')):
    task = registry.get_task(name, device=cs.DEV)
    _, (args, gargs, condims, dmasks) = cs.solver_inputs(task,
                                                         states(task, gen))
    kw = dict(cap=task.model.opt.iterations, tol=1e-5, condims=condims,
              dmasks=dmasks)
    if checks:
      _, line = cs.check_newton_task(name.split()[0], args, gargs, kw)
      print(f'phase {phase} {name} step inputs (B {args[1].shape[0]}): '
            f'{line}')
    shapes[name] = (task, args, gargs, kw)

  timed = [(f'Cartpole B {cs.CART_SAMPLES} nv 2 ns 2 cap {cart_cap}',
            cart_args, (), dict(cap=cart_cap, tol=1e-5), None)]
  for name, (task, args, gargs, kw) in shapes.items():
    timed.append((
        f'{name.split()[0]} B {args[1].shape[0]} nv {task.model.nv} ns '
        f'{args[6].shape[1]} one condim-3 group P {gargs[1].shape[1]} cap '
        f'{kw["cap"]}', args, gargs, kw,
        {'Humanoid Track': cs.HUMAN_PLAIN_REPS,
         'Shadow Reorient': cs.SHADOW_PLAIN_REPS}.get(name)))
  for label, args, gargs, kw, plain_reps in timed:
    print(f'phase 4 timing per call, wall (median of {cs.TIME_REPS}, CUDA '
          f'events) / device only (profiler): '
          + cs.newton_timing_line(label, *cs.time_newton(args, gargs, kw,
                                                         plain_reps),
                                  plain_reps))
  # the kernel's time by iteration cap: cap 0 is the staging and the
  # writes alone, each further cap adds one iteration for the samples
  # that have not yet stopped
  for label, args, gargs, kw, _ in timed:
    times = [kernel_us(lambda c=c: newton.newton(*args, *gargs, **dict(
        kw, cap=c))) for c in range(kw['cap'] + 1)]
    print(f'newton device us by cap (CUDA events behind a busy stream), '
          f'{label.split()[0]}: ' + ', '.join(f'{c}: {us:.1f}'
                                              for c, us in enumerate(times)))
  # the Quadruped shapes on states from three seeds: B2's time follows the
  # iterations its inputs take, whichever way the profiler's records are
  # counted (per record times the launches, as chip_smoke counts since it
  # compensates for dropped records; over the calls, as it counted before)
  quad = shapes['Quadruped Flat'][0]
  for seed in (0, 1, 2):
    sgen = torch.Generator(device=cs.DEV).manual_seed(seed)
    _, (args, gargs, condims, dmasks) = cs.solver_inputs(
        quad, cs.quadruped_states(quad, sgen))
    kw = dict(cap=quad.model.opt.iterations, tol=1e-5, condims=condims,
              dmasks=dmasks)
    fn = lambda: newton.newton(*args, *gargs, **kw)  # noqa: E731
    per_record, over_calls = profiled_us(fn)
    iters = cs.newton_bound(args, gargs, condims, dmasks, kw['cap'],
                            kw['tol'])[2]
    print(f'newton Quadruped shapes, states of seed {seed}: device us per '
          f'call {per_record:.1f} (profiler, per record x launches), '
          f'{over_calls:.1f} (profiler, over the calls), {kernel_us(fn):.1f}'
          f' (CUDA events behind a busy stream); {iters:.2f} iterations per '
          f'sample')
  cs.check(spilled == 0, f'newton: the instances spill {spilled} bytes')
  done = 'all checks passed' if checks else 'timed'
  print(f'newton_check: {done} in {time.perf_counter() - t0:.1f} s')


if __name__ == '__main__':
  main()
