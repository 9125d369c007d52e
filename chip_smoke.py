"""Drive the PyTorch port on one NVIDIA GPU, through its hand kernels.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: both CUDA kernels from csrc/ with nvcc, for sm_90a;
  3. check: each kernel against its plain PyTorch version on the card,
     on random inputs and on the inputs the Cartpole step gives it;
  4. timing: kernel vs plain at the Cartpole slice's shapes, wall per
     call (CUDA events, median of 30) and device time (profiler); for B1
     also torch.linalg's batched Cholesky;
  5. main path: Cartpole Predictive Sampling, 8192 candidates x 101 steps,
     20 timed plan iterations; both kernels must have been launched, as
     often as the path calls them, and best_return <= nominal_return;
     one profiled plan gives device ops, busy time and the top ops;
  6. golden: a 256-candidate plan on the card vs the plain path on the CPU
     with the same candidates, and a 5-step batched rollout's qpos drift;
  7. plan-act: synchronous MPC on Cartpole at 8192 candidates for 2 s of
     simulated time; its real-time factor.
Then one JSON line with the kernels' launches, errors and times, and as
the last line {"ok": true, "device": {...}}.
"""

import concurrent.futures
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SAMPLES = 8192
SPLINE_POINTS = 10
QPOS0 = (1.0, 3.14159)
PLAN_REPS = 20
TIME_REPS = 30
DEV = 'cuda'


def check(cond, msg):
  if not cond:
    raise RuntimeError(f'chip_smoke check failed: {msg}')


def cuda_time_ms(fn, reps=TIME_REPS):
  """Median ms of one fn() call between two CUDA events: the time a
  caller waits, host launch overhead included."""
  import torch
  for _ in range(3):
    fn()
  times = []
  for _ in range(reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end))
  return statistics.median(times)


def device_us(fn, reps=TIME_REPS, top=0):
  """Device time of fn() per call in microseconds: the CUDA kernels the
  profiler saw over `reps` calls, over `reps` (no host time). With `top`,
  also (device ops per call, [(name, count, us) of the `top` ops with the
  most device time])."""
  import torch
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    for _ in range(reps):
      fn()
    torch.cuda.synchronize()
  dev = [e for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA]
  total = sum(e.self_device_time_total for e in dev) / reps
  if not top:
    return total
  dev.sort(key=lambda e: -e.self_device_time_total)
  return (total, sum(e.count for e in dev) // reps,
          [(e.key, e.count // reps, e.self_device_time_total / reps)
           for e in dev[:top]])


def newton_cost(args, qacc):
  """The Newton solve's objective at qacc, in float64: 0.5 e'M e plus
  0.5 D jar^2 over the active rows, e = qacc - qs."""
  import torch
  qm, qs, j, aref, dvec, eqf, s_aref, s_dvec, dof, sign = (
      t.double() if t.is_floating_point() else t.long() for t in args)
  qacc = qacc.double()
  e = qacc - qs
  cost = 0.5 * torch.sum(e * (qm @ e[..., None])[..., 0], -1)
  jar = (j @ qacc[..., None])[..., 0] - aref
  act = (jar < 0) | (eqf > 0.5)
  cost = cost + 0.5 * torch.sum(torch.where(act, dvec, 0.0) * jar * jar, -1)
  jar = sign * qacc[:, dof] - s_aref
  return cost + 0.5 * torch.sum(torch.where(jar < 0, s_dvec, 0.0) * jar
                                * jar, -1)


def random_spd(gen, bsz, n):
  import torch
  g = torch.randn((bsz, n, n), generator=gen, device=DEV)
  a = g @ g.transpose(1, 2) / n + torch.eye(n, device=DEV)
  return a.contiguous(), torch.randn((bsz, n), generator=gen, device=DEV)


def random_newton(gen, bsz, nv, n, ns):
  """The synthetic problem of tests/test_pallas_newton.py."""
  import torch
  r = lambda *s: torch.randn(s, generator=gen, device=DEV)  # noqa: E731
  a = r(bsz, nv, nv)
  qm = (a @ a.transpose(1, 2) + 2.0 * torch.eye(nv, device=DEV))
  eqf = (torch.rand((bsz, n), generator=gen, device=DEV) < 0.2).float()
  dof = torch.randint(0, nv, (ns,), generator=gen, device=DEV,
                      dtype=torch.int32)
  sign = torch.where(torch.rand((ns,), generator=gen, device=DEV) < 0.5,
                     1.0, -1.0)
  sp = torch.nn.functional.softplus
  return (qm.contiguous(), r(bsz, nv), r(bsz, n, nv), r(bsz, n),
          sp(r(bsz, n)), eqf, r(bsz, ns), sp(r(bsz, ns)), dof, sign)


def slice_inputs(spec, gen):
  """The operands the Cartpole step hands both kernels: 8192 states
  around the start state, some past the slider limit."""
  import torch
  from mujoco_mpc_tpu_torch.physics import constraint, forward as fwd, smooth
  from mujoco_mpc_tpu_torch.physics.model import make_data
  m = spec.model
  qpos = torch.tensor(QPOS0, device=DEV) + torch.randn(
      (SAMPLES, 2), generator=gen, device=DEV) * torch.tensor(
          [1.2, 1.0], device=DEV)
  d = make_data(m, SAMPLES).replace(
      qpos=qpos, qvel=2.0 * torch.randn((SAMPLES, 2), generator=gen,
                                        device=DEV),
      ctrl=torch.rand((SAMPLES, 1), generator=gen, device=DEV) * 2 - 1)
  d = fwd.fwd_actuation(m, fwd.fwd_velocity(m, fwd.fwd_position(m, d)))
  d = smooth.crb(m, d).replace(qfrc_constraint=torch.zeros_like(d.qvel))
  d = fwd.fwd_acceleration(m, d)
  _, rows = constraint.make_rows_split(m, d)
  spd = (d.qM.contiguous(), d.qfrc_smooth.contiguous())
  z = torch.zeros((SAMPLES, 0), device=DEV)
  dvec_s = torch.where(rows.active, rows.d, torch.zeros_like(rows.d))
  newton_args = (d.qM.contiguous(), d.qacc.contiguous(),
                 torch.zeros((SAMPLES, 0, 2), device=DEV), z, z, z,
                 rows.aref.contiguous(), dvec_s.contiguous(), rows.dof,
                 rows.sign)
  return spd, newton_args, rows.active


def errors(got, want):
  """(max abs error, max abs error / max(1, max |want|))."""
  import torch
  err = float(torch.max(torch.abs(got - want)))
  return err, err / max(1.0, float(torch.max(torch.abs(want))))


def main():
  import torch
  if not torch.cuda.is_available():
    raise SystemExit('chip_smoke: torch.cuda.is_available() is False; '
                     'this script needs an NVIDIA GPU')
  sys.path.insert(0, ROOT)
  try:
    from mujoco_mpc_tpu_torch import agent
    from mujoco_mpc_tpu_torch.ops import cuda_build, linalg, newton, spd_solve
    from mujoco_mpc_tpu_torch.ops import spline
    from mujoco_mpc_tpu_torch.physics import forward as fwd
    from mujoco_mpc_tpu_torch.physics.model import make_data
    from mujoco_mpc_tpu_torch.planners import sampling
    from mujoco_mpc_tpu_torch.tasks import registry
  except ImportError as e:
    raise SystemExit(f'chip_smoke: run it from a checkout of the repository'
                     f' ({e})') from e
  # references in full float32 (TF32 would keep ~3 digits)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False

  # 1. device
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip().splitlines()
  print('phase 1 device:', torch.cuda.get_device_name(0),
        f'(torch {torch.__version__}, CUDA {torch.version.cuda}), nvidia-smi:')
  print(smi[0])

  # 2. build, both sources at once (nvcc is one process per file)
  t0 = time.perf_counter()
  kernels = ('chol_solve', 'newton')
  with concurrent.futures.ThreadPoolExecutor(len(kernels)) as pool:
    list(pool.map(cuda_build.build, kernels))
  for name in kernels:
    cuda_build.load(name)
  print(f'phase 2 build: chol_solve.cu + newton.cu with nvcc for sm_90a in '
        f'{time.perf_counter() - t0:.1f} s')

  # 3. kernels vs plain versions, float32 on the card
  gen = torch.Generator(device=DEV).manual_seed(0)
  worst_spd = 0.0
  for n in (2, 8, 18, 24, 32):
    for bsz in (SAMPLES, SAMPLES + 1):
      a, b = random_spd(gen, bsz, n)
      _, err = errors(spd_solve.solve_spd(a, b), linalg.solve_spd(a, b))
      worst_spd = max(worst_spd, err)
  # cond(a) <= ~10 and n <= 32: f32 rounding (kernel fuses multiply-adds
  # and multiplies by 1/L_ii where the plain version divides) < 1e-4
  check(worst_spd <= 1e-4, f'chol_solve vs plain: {worst_spd:.3g} > 1e-4')
  print(f'phase 3a chol_solve vs plain, n in 2/8/18/24/32, B 8192/8193: max '
        f'rel err {worst_spd:.3g} (tol 1e-4)')

  # A sample whose jar sits within f32 rounding of 0 can take the other
  # side of an active-set boundary in the kernel (fused multiply-adds,
  # another summation order) than in the plain loop; the two then follow
  # different Newton paths for a while and may stop at different
  # iterations. Such samples are rare: at most 1% may disagree beyond the
  # tolerance of tests/test_pallas_newton.py (rtol 2e-3, atol 1e-3).
  # Both ends minimise one convex piecewise-quadratic cost, so where qacc
  # differs the two costs must still agree: a wrong kernel would leave an
  # O(1) relative cost gap, two near-minimisers a gap near f32 rounding.
  for (nv, n, ns) in ((2, 0, 2), (8, 16, 4), (18, 24, 8)):
    for bsz in (SAMPLES, SAMPLES + 37):
      args = random_newton(gen, bsz, nv, n, ns)
      got = newton.newton(*args, cap=30, tol=1e-6)
      want = newton.newton_reference(*args, cap=30, tol=1e-6)
      bad = torch.zeros(bsz, dtype=torch.bool, device=DEV)
      for g, w in zip(got, want):
        if g.shape[1]:
          bad |= (torch.abs(g - w) > 1e-3 + 2e-3 * torch.abs(w)).any(-1)
      nbad = int(bad.sum())
      c_got, c_want = newton_cost(args, got[0]), newton_cost(args, want[0])
      gap = float(torch.max(torch.abs(c_got - c_want)
                            / torch.clamp(torch.abs(c_want), min=1.0)))
      check(nbad <= bsz // 100, f'newton (nv {nv}, n {n}, ns {ns}, B {bsz})'
            f': {nbad} samples disagree, more than 1%')
      check(gap <= 1e-3, f'newton (nv {nv}, n {n}, ns {ns}, B {bsz}): '
            f'relative cost gap {gap:.3g} > 1e-3')
      print(f'phase 3b newton vs plain, nv {nv} n {n} ns {ns} B {bsz} cap 30:'
            f' {nbad} of {bsz} samples outside rtol 2e-3/atol 1e-3 '
            f'(bound 1%); max relative cost gap {gap:.3g} (tol 1e-3)')

  spec = registry.get_task('Cartpole', device=DEV)
  spd_in, newton_in, active = slice_inputs(spec, gen)
  spd_abs, spd_err = errors(spd_solve.solve_spd(*spd_in),
                            linalg.solve_spd(*spd_in))
  check(spd_err <= 1e-5, f'chol_solve on Cartpole inputs: {spd_err:.3g}')
  got = newton.newton(*newton_in, cap=spec.model.opt.iterations, tol=1e-5)
  want = newton.newton_reference(*newton_in, cap=spec.model.opt.iterations,
                                 tol=1e-5)
  newton_abs, newton_err = max(errors(g, w) for g, w in zip(got, want)
                               if g.shape[1])
  # one-hot rows and nv = 2: no near-boundary flips seen; f32 rounding of
  # qacc up to ~1e3 past the limit
  check(newton_err <= 1e-4, f'newton on Cartpole inputs: {newton_err:.3g}')
  print(f'phase 3c Cartpole step inputs (B {SAMPLES}, {int(active.sum())} '
        f'active limit rows): chol_solve rel err {spd_err:.3g} (tol 1e-5), '
        f'newton rel err {newton_err:.3g} (tol 1e-4)')

  # 4. timing at the slice's shapes
  cap = spec.model.opt.iterations
  t_spd = cuda_time_ms(lambda: spd_solve.solve_spd(*spd_in))
  t_spd_plain = cuda_time_ms(lambda: linalg.solve_spd(*spd_in))
  t_newton = cuda_time_ms(lambda: newton.newton(*newton_in, cap=cap,
                                                tol=1e-5))
  t_newton_plain = cuda_time_ms(lambda: newton.newton_reference(
      *newton_in, cap=cap, tol=1e-5))

  def library_spd(a, b):
    factor, _ = torch.linalg.cholesky_ex(a)
    return torch.cholesky_solve(b[..., None], factor)[..., 0]
  t_spd_lib = cuda_time_ms(lambda: library_spd(*spd_in))
  dev = {name: device_us(fn) for name, fn in (
      ('chol_solve', lambda: spd_solve.solve_spd(*spd_in)),
      ('chol_plain', lambda: linalg.solve_spd(*spd_in)),
      ('chol_library', lambda: library_spd(*spd_in)),
      ('newton', lambda: newton.newton(*newton_in, cap=cap, tol=1e-5)),
      ('newton_plain', lambda: newton.newton_reference(*newton_in, cap=cap,
                                                       tol=1e-5)))}
  print(f'phase 4 timing per call, wall (median of {TIME_REPS}, CUDA events)'
        f' / device only (profiler): chol_solve B {SAMPLES} n 2: kernel '
        f'{t_spd * 1e3:.1f} / {dev["chol_solve"]:.1f} us, plain '
        f'{t_spd_plain * 1e3:.1f} / {dev["chol_plain"]:.1f} us, '
        f'torch.linalg.cholesky_ex + cholesky_solve {t_spd_lib * 1e3:.1f} / '
        f'{dev["chol_library"]:.1f} us; newton B {SAMPLES} nv 2 ns 2 cap '
        f'{cap}: kernel {t_newton * 1e3:.1f} / {dev["newton"]:.1f} us, plain'
        f' {t_newton_plain * 1e3:.1f} / {dev["newton_plain"]:.1f} us')

  # 5. main path: Cartpole plan iterations at 8192 x 101
  interp = int(spline.Interp.ZERO)
  t_steps = agent.horizon_steps(spec)
  d0 = make_data(spec.model).replace(
      qpos=torch.tensor([QPOS0], device=DEV))
  cfg = sampling.default_config(spec)
  params = spec.default_params

  def plan(pol, num_samples=SAMPLES, generator=gen):
    noise = sampling.sample_noise(spec, SPLINE_POINTS, num_samples, cfg,
                                  generator)
    return sampling.optimize(spec, pol, d0, params, cfg, noise, t_steps,
                             interp)

  pol = sampling.default_policy(spec, SPLINE_POINTS)
  pol, _ = plan(pol)                                    # warm-up
  torch.cuda.synchronize()
  spd_solve.solve_spd.launches = 0
  newton.newton.launches = 0
  lat, infos = [], []
  for _ in range(PLAN_REPS):
    t0 = time.perf_counter()
    pol, info = plan(pol)
    torch.cuda.synchronize()
    lat.append(time.perf_counter() - t0)
    infos.append(info)
  launches = {'chol_solve': spd_solve.solve_spd.launches,
              'newton': newton.newton.launches}
  check(launches['newton'] == PLAN_REPS * t_steps,
        f'newton launched {launches["newton"]} times, expected '
        f'{PLAN_REPS * t_steps} (once per rollout step)')
  check(launches['chol_solve'] == 2 * PLAN_REPS * t_steps,
        f'chol_solve launched {launches["chol_solve"]} times, expected '
        f'{2 * PLAN_REPS * t_steps} (twice per rollout step)')
  best = torch.stack([i['best_return'] for i in infos]).cpu()
  nominal = torch.stack([i['nominal_return'] for i in infos]).cpu()
  check(bool(torch.isfinite(best).all()), f'best_return not finite: {best}')
  check(bool((best <= nominal).all()), 'best_return > nominal_return')
  p50 = statistics.median(lat)

  plan_dev_us, plan_ops, top = device_us(lambda: plan(pol), reps=1,
                                         top=8)
  print(f'phase 5 main path: Cartpole {SAMPLES} candidates x {t_steps} steps,'
        f' {PLAN_REPS} plans: p50 {p50 * 1e3:.2f} ms, '
        f'{1.0 / p50:.2f} plans/s; launches chol_solve '
        f'{launches["chol_solve"]}, newton {launches["newton"]}; '
        f'best_return {float(best[-1]):.5g} <= nominal {float(nominal[-1]):.5g}'
        f'; profiled plan: {plan_ops} device ops, device busy '
        f'{plan_dev_us / 1e3:.2f} ms = {plan_dev_us / 1e4 / p50:.1f}% of p50')
  print('phase 5 device time per plan by op (name: count, ms): ' + '; '.join(
      f'{name[:48]}: {count}, {us / 1e3:.2f}' for name, count, us in top))

  # 6. golden: the card against the plain path on the CPU, from the
  # default plan (after phase 5's plans the nominal tends to win outright,
  # which would make the winner check trivial)
  cpu_spec = registry.get_task('Cartpole', device='cpu')
  cpu_cfg = sampling.default_config(cpu_spec)
  d0_cpu = make_data(cpu_spec.model).replace(qpos=torch.tensor([QPOS0]))
  eps, use2 = sampling.sample_noise(spec, SPLINE_POINTS, 255, cfg, gen)
  pol = sampling.default_policy(spec, SPLINE_POINTS)
  _, info_gpu = sampling.optimize(spec, pol, d0, params, cfg, (eps, use2),
                                  t_steps, interp)
  pol_cpu = sampling.SamplingPolicy(pol.times.cpu(), pol.values.cpu())
  _, info_cpu = sampling.optimize(cpu_spec, pol_cpu, d0_cpu,
                                  cpu_spec.default_params, cpu_cfg,
                                  (eps.cpu(), use2.cpu()), t_steps, interp)
  br_gpu, br_cpu = float(info_gpu['best_return']), float(
      info_cpu['best_return'])
  rel = abs(br_gpu - br_cpu) / max(abs(br_cpu), 1e-9)
  win_gpu, win_cpu = int(info_gpu['winner']), int(info_cpu['winner'])
  near = float(info_cpu['returns'][win_gpu]) <= br_cpu * 1.02 + 1e-9
  ctrl = 0.5 * torch.randn((256, 5, 1), generator=gen, device=DEV)
  qpos_run = []
  for m, c, dev_ in ((spec.model, ctrl, DEV),
                     (cpu_spec.model, ctrl.cpu(), 'cpu')):
    d = make_data(m, 256).replace(qpos=torch.tensor([QPOS0], device=dev_)
                                  .expand(256, 2))
    for k in range(5):
      d = fwd.step(m, d.replace(ctrl=c[:, k]))
    qpos_run.append(d.qpos.cpu())
  drift = float(torch.max(torch.abs(qpos_run[0] - qpos_run[1])))
  # bounds of bench.py's TPU golden check (fused_newton_golden)
  check(rel <= 0.02, f'golden best_return rel err {rel:.3g} > 0.02')
  check(near, 'the card\'s winner is not within 2% of the CPU best')
  check(drift <= 0.05, f'golden qpos drift {drift:.3g} > 0.05')
  print(f'phase 6 golden: 256-candidate plan best_return card {br_gpu:.6g} vs'
        f' CPU plain {br_cpu:.6g}: rel err {rel:.3g} (tol 0.02); winner card '
        f'{win_gpu} vs CPU {win_cpu} (match {win_gpu == win_cpu}); 5-step '
        f'rollout qpos drift {drift:.3g} (tol 0.05)')

  # 7. plan-act loop
  sim_dt = float(spec.model.opt.timestep)
  total_steps = int(round(2.0 / sim_dt))
  steps_per_plan = 4
  sim0 = make_data(spec.model).replace(
      qpos=torch.tensor([QPOS0], device=DEV))
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  carry, costs = agent.synchronous_mpc(
      spec, SAMPLES, total_steps, steps_per_plan,
      torch.Generator(device=DEV).manual_seed(1), sim0=sim0)
  costs = costs.cpu()
  wall = time.perf_counter() - t0
  check(bool(torch.isfinite(costs).all()), 'plan-act costs not finite')
  sim_time = len(costs) * sim_dt
  print(f'phase 7 plan-act: {len(costs)} steps ({sim_time:.2f} s simulated, '
        f'{steps_per_plan} steps per plan, {SAMPLES} candidates) in '
        f'{wall:.2f} s wall: real-time factor {sim_time / wall:.3f}; mean '
        f'cost {float(costs.mean()):.4g}, last {float(costs[-1]):.4g}')

  print(json.dumps({'kernels': [
      {'name': 'chol_solve', 'route': 'cuda',
       'source': 'mujoco_mpc_tpu_torch/csrc/chol_solve.cu',
       'replaces': 'mujoco_mpc_tpu/ops/pallas_linalg.py:90',
       'launches': launches['chol_solve'], 'max_abs_err': spd_abs,
       'ms': t_spd, 'plain_ms': t_spd_plain},
      {'name': 'newton', 'route': 'cuda',
       'source': 'mujoco_mpc_tpu_torch/csrc/newton.cu',
       'replaces': 'mujoco_mpc_tpu/ops/pallas_newton.py:750',
       'launches': launches['newton'], 'max_abs_err': newton_abs,
       'ms': t_newton, 'plain_ms': t_newton_plain},
  ]}))
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
  main()
