"""Drive the PyTorch port on one NVIDIA GPU, through its hand kernels.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: both CUDA kernels from csrc/ with nvcc, for sm_90a, at once;
     ptxas's registers, stack and spills of every bucket instance of both
     kernels (any spill fails) and the shared memory they take;
  3. check: each kernel against its plain PyTorch version on the card:
     3a B1 on random systems, every n from 1 to 32, B 1, 8192 and 8193;
     3b B2 on random dense and one-hot rows, nv 2, 8, 18, 24 and 32;
     3c both on the inputs the Cartpole step gives them; 3d B2's contact
     groups (condim 1, 3, 4, 6, and two groups) on random factored
     problems, task-shaped and dense, with the near ties counted by rows
     per dof; 3e both on the inputs the Quadruped step gives them; 3f
     both on the inputs the Humanoid Track step gives them (B1 on both of
     its systems, qM and the Euler system with the joint damping, B2 in
     its nv-24 bucket), from states as deep in the floor as a step goes
     and from far deeper ones, held to 3d's rule for dense problems; 3g
     both on the inputs the Shadow Reorient step gives them (B 8192, nv
     21, 228 facet rows a sample, B2 at one block an SM), 256 samples at
     qpos0 and the rest from 15 steps of rollouts (held to 3e's rule), or
     with the cube pressed 0-10 mm into the palm and the fingers spread,
     deeper than a step goes (held to 3d's rule for dense problems); 3h
     the contact points the card's step stacks at both sets against the
     CPU's plain path: the same tied hull vertices at qpos0, depths and
     positions within f32 tolerance; 3i both kernels' tangents: each
     Function's jvp, vmapped over tangent directions, through the kernels
     against the same Function through the plain versions on the card,
     at Swimmer's derivative shapes (B1 and B2 at the 200 knots, 21
     directions, B1's tangent at B 4,200 in one launch) and at the
     Quadruped step's inputs (B2's condim-3 group tangent, 4 directions;
     3d's near-tie rule);
  4. timing: kernel, plain version and (B1) torch.linalg's batched
     Cholesky at the four Predictive Sampling paths' shapes and at the
     two iLQG paths' (B1 at the line search, B 8, and at the derivative
     tangent, B (T - 1) D; B2 at the line search), at the shapes the
     planner paths of phases 21 and 23 add (iLQS's iLQG line search at B
     2048 with the derivative tangent at B 500, Robust's re-rollouts at B
     60 under body wrenches; each also checked against its plain
     version), and B1 at n 24 and 32
     (B 4096, random systems), wall per call (CUDA events, median of 30;
     the plain versions over 3 calls, at the Shadow shapes over one) and
     device time (profiler), with each kernel's bound and its device time
     as a multiple of the bound;
  5. Cartpole main path: Predictive Sampling, 8192 candidates x 101
     steps, 5 timed plans; both kernels launched as often as the path
     calls them, best_return <= nominal_return; one profiled plan;
  6. Cartpole golden: a 256-candidate plan on the card vs the plain path
     on the CPU with the same candidates, and a 5-step rollout's drift;
  7. Cartpole plan-act: synchronous MPC at 8192 candidates, 0.5 s
     simulated;
  8. Quadruped Flat main path: 4096 candidates x 36 steps, 10 knots, 3
     timed plans from `home`, checked and profiled as in phase 5;
  9. Quadruped golden: the bounds of bench.py's fused_newton_golden;
  10. Quadruped plan-act: synchronous MPC at 128 candidates, 8 plans of
     4 steps, the task's transition on;
  11. Humanoid Track main path: 512 candidates x 41 steps, 10 knots, 3
     timed plans from `home` (the clip's first pose), checked and profiled
     as in phase 5 (bench.py's humanoid_track_ps512);
  12. Humanoid Track golden: the bounds of phase 9;
  13. Humanoid Track plan-act: as phase 10;
  14. Shadow Reorient main path: 8192 candidates x 31 steps, 10 knots, 3
     timed plans from qpos0, checked and profiled as in phase 5
     (bench.py's shadow_ps8192);
  15. Shadow Reorient golden: the bounds of phase 9;
  16. Shadow Reorient plan-act: as phase 10;
  17. Particle iLQG main path: make_planner(spec, ILQG, 8, 51, 10) from
     the task's start (bench.py's particle_ilqg), a warm-up and 5 timed
     iterations: p50, plans/s, the wall split into line search,
     derivatives and Riccati, both kernels' launches per iteration (and
     B1 at B (T - 1) D in the derivative pass), the escalation's host
     reads, backward_pass_ok and best_return <= nominal_return; one
     profiled iteration;
  18. Particle iLQG golden: the second iteration (the first to apply an
     improvement) on the card and on the CPU plain path, from the same
     state and policy (phase 17's first iteration's): A and B per knot
     within 1e-3 relative, best_return within 0.02, the same winning
     scale;
  19. Swimmer iLQG main path: 8 x 201 (bench.py's swimmer_ilqg), 2 timed
     iterations, as phase 17;
  20. Swimmer iLQG golden: as phase 18;
  21. the other planners on Cartpole at the flagship's width, 8192
     candidates x 101 steps, 10 knots, from (1.0, 3.14159): Cross
     Entropy, Sample Gradient, Gradient and iLQS through make_planner, a
     warm-up and 5 timed iterations each: p50, plans/s, both kernels'
     launches per iteration (checked against the path's rollouts and
     derivative pass), B1 at the derivative tangent's batch, iLQS's host
     reads and iLQG runs, best_return finite and <= nominal_return, and
     the first timed iteration replayed under the profiler (device ops,
     busy share); then iLQS once with exploration 0, so that its iLQG
     branch (line search at B 2048) runs; both kernels checked and timed
     at the shapes these paths add (B 2048, and B1 at B (T - 1) D);
  22. goldens: one 256-candidate iteration of each of the five new
     planners on the card and on the CPU plain path from the same state
     and plan with the same noise (drawn on the CPU): best_return within
     0.02 relative, the card's winner within 2 % of the CPU best on the
     CPU; Gradient's and iLQS's (exploration 0) A and B per knot within
     1e-3 relative; Robust Sampling on Quadruped Flat;
  23. Robust Sampling on Quadruped Flat, 4096 x 36 from `home`, 12
     candidates x 5 repetitions over Sampling (bench.py's
     quadruped_ps4096 with the reference's Robust instantiation): as
     phase 21, B2's group branch under body wrenches at B 60, both
     kernels checked and timed there;
  24. testspeed for all seven planner ids on Cartpole: 128 samples, 0.1 s
     simulated, 4 steps a plan; x_realtime and avg_cost (finite).
Then one JSON line with the kernels' launches, errors, times and bounds
(top-level keys: the Quadruped path; "paths": all eleven, the iLQG ones at
the line search's shapes with B1's derivative tangent under "tangent",
the planner paths of phases 21-23 with their launches per iteration and
their golden's best_return relative error), and as the last line
{"ok": true, "device": {...}}.
"""

import concurrent.futures
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CART_SAMPLES = 8192
QUAD_SAMPLES = 4096
HUMAN_SAMPLES = 512
SHADOW_SAMPLES = 8192
SPLINE_POINTS = 10
CART_QPOS0 = (1.0, 3.14159)
# timed plans and plan-act depth, cut to make room for phases 21-24
# inside the run's time limit (Cartpole's plans were 10, the others 5;
# the plan-act loops 1 s at Cartpole and 25 plans elsewhere; Particle's
# and Swimmer's iLQG iterations 10 and 5)
CART_PLANS = 5
QUAD_PLANS = 3
HUMAN_PLANS = 3
SHADOW_PLANS = 3
CART_PLAN_ACT_TIME = 0.5   # simulated seconds
PLAN_ACT_STEPS = 32        # 8 plans of 4 steps
# Shadow states at qpos0 itself (phase 3g's first samples): the cube rests
# unrotated there, and 8 of its hull vertices tie for the floor's 4 points
SHADOW_QPOS0 = 256
# phase 3g's task-shaped states: this many planning steps from qpos0
SHADOW_ROLLOUT_STEPS = 15
# the plain versions at the Shadow shapes, timed over one call
SHADOW_PLAIN_REPS = 1
# phase 3h: contact points on the card against the CPU's, float32 both;
# positions and depths are O(0.3 m) after a chain of 4 bodies
POINT_ATOL = 1e-5
NORMAL_ATOL = 1e-4
# the plain versions at the Humanoid shapes, timed over a few calls: B1's
# unrolls ~5,000 launches a call at n 23, B2's ~6 times as many
HUMAN_PLAIN_REPS = 3
TIME_REPS = 30
# B1 beyond the paths' sizes: the buckets the mesh-hull hands will use,
# its plain version there timed over a few calls
# iLQG, bench.py's particle_ilqg / swimmer_ilqg: make_planner(spec, ILQG,
# 8, T, 10), timed iterations from the task's start
ILQG_CANDIDATES = 8
PARTICLE_ITERS = 5
SWIMMER_ITERS = 2
# calls the plain versions are timed over in phase 4 at the Cartpole,
# Quadruped and iLQG shapes (one plain Newton call is up to ~5,000
# launches, and the profiler's passes over 30 of them dominated phase 4)
PLAIN_REPS = 3
# phases 21-24: the other planners
PLANNER_SAMPLES = 8192     # Cartpole's flagship width
PLANNER_ITERS = 5
FORCED_ITERS = 1           # iLQS with its iLQG branch forced
GOLDEN_SAMPLES = 256
ROBUST_SAMPLES = 4096      # Quadruped Flat (bench.py's quadruped_ps4096)
ROBUST_ITERS = 5
ROBUST_REROLLOUTS = 60     # DEFAULT_NCANDIDATES x DEFAULT_NREPETITIONS
TESTSPEED_TIME = 0.1       # simulated seconds a planner (0.2 asked; cut
                           # to keep the run inside its time limit)
TESTSPEED_SAMPLES = 128    # Cartpole's sampling_trajectories
SPD_EXTRA_N = (24, 32)
SPD_EXTRA_PLAIN_REPS = 3
DEV = 'cuda'
# NVIDIA H100 SXM: 3.35 TB/s of HBM, 67 TFLOP/s float32 outside the
# tensor cores (data sheet, 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def smi_line():
  """The card's name and power limit, as nvidia-smi gives them."""
  return subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip().splitlines(
          )[0]


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


def device_us(fn, reps=TIME_REPS, top=0, kernel=None, warm=True,
              host=True):
  """Device time of fn() per call in microseconds, from the CUDA kernels
  the profiler saw over `reps` calls (no host time). With `top`, also
  (device ops per call, [(name, count, us) of the `top` ops with the most
  device time]). The profiler drops kernel records of the hand kernels
  (on an H100 it kept 28 or 29 of 30 of B1's, pass after pass; in other
  processes 7 of 30 of B1's at n 32 and 11 of 30 of B2's at the Humanoid
  shapes, in every pass), so each op counts as its mean time over the
  records it has, times the launches it makes a call: its record count
  over `reps`, rounded, or for `kernel`, the name of a hand kernel that
  fn launches once a call, one. A pass in which the op with the most
  device time (with `kernel`, that kernel) has too few records to count
  (fewer than half the calls; with `kernel`, none) is taken again, up to
  five passes, and then fails; a line says how many records of `kernel`
  the profiler kept when it kept fewer than the calls. `warm=False` skips
  the unprofiled warm-up call (for an fn that has run already);
  `host=False` traces the device's activity only (an iLQG iteration is
  ~600,000 launches, and tracing the host's side of each as well took
  minutes)."""
  import torch
  from torch.profiler import ProfilerActivity, profile

  def launches(e):
    return 1 if kernel and kernel in e.key else round(e.count / reps)

  def counted(dev):
    if kernel:
      return [e for e in dev if kernel in e.key]
    return dev[:1] if dev and 2 * dev[0].count >= reps else []

  if warm:
    fn()
  torch.cuda.synchronize()
  for _ in range(5):
    with profile(activities=[ProfilerActivity.CPU] * host
                 + [ProfilerActivity.CUDA]) as prof:
      for _ in range(reps):
        fn()
      torch.cuda.synchronize()
    dev = device_ops(prof)
    if counted(dev):
      break
  check(counted(dev), 'the profiler saw '
        + (f'no {kernel}' if kernel else
           f'{dev[0].key[:60]} {dev[0].count} times' if dev else 'no kernel')
        + f' over {reps} calls, in five passes')
  if kernel and counted(dev)[0].count < reps:
    print(f'device_us: the profiler kept {counted(dev)[0].count} of {reps} '
          f'records of {kernel}')
  ops = [(e.key, launches(e),
          e.self_device_time_total / e.count * launches(e)
          if launches(e) else e.self_device_time_total / reps)
         for e in dev]
  total = sum(us for _, _, us in ops)
  if not top:
    return total
  return total, sum(k for _, k, _ in ops), ops[:top]


class DeviceOp:
  """One device op's records in a trace: key (name), count (records) and
  self_device_time_total (us), as key_averages() gives them."""
  __slots__ = ('key', 'count', 'self_device_time_total')

  def __init__(self, key):
    self.key, self.count, self.self_device_time_total = key, 0, 0.0


def device_ops(prof):
  """The CUDA ops of a finished trace, by name, most device time first:
  the sums key_averages() computes over prof.events(), grouped in one
  pass (key_averages() took seconds per 100,000 records)."""
  import torch
  ops = {}
  cuda = torch.autograd.DeviceType.CUDA
  for e in prof.events():
    if e.device_type == cuda:
      op = ops.get(e.key)
      if op is None:
        op = ops[e.key] = DeviceOp(e.key)
      op.count += 1
      op.self_device_time_total += e.self_device_time_total
  return sorted(ops.values(), key=lambda op: -op.self_device_time_total)


def bound(bytes_, flops):
  """(ms, 'bytes' or 'operations'): the least time the card could take
  to move `bytes_` and compute `flops` in float32."""
  t_bytes, t_ops = bytes_ / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
  return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops
                                     else 'operations')


def spd_bound(a):
  """B1's bound on a (B, n, n): read the lower triangle of a (all the
  factor needs) and b, write x; n^3/3 flops for the factor and 2 n^2 for
  the two triangular solves, per system."""
  bsz, n = a.shape[0], a.shape[1]
  return bound(4 * bsz * (n * (n + 1) // 2 + 2 * n),
               bsz * (n ** 3 / 3 + 2 * n * n))


def expanded(args, gargs=(), condims=(), dmasks=()):
  """The Newton operands with every contact group facet-expanded into the
  dense rows, in float64."""
  from mujoco_mpc_tpu_torch.ops import newton
  qm, qs, j, aref, dvec, eqf, s_aref, s_dvec, dof, sign = (
      t.double() if t.is_floating_point() else t.long() for t in args)
  j, aref, dvec, eqf, _ = newton.expand_groups(
      j, aref, dvec, eqf, [t.double() for t in gargs], condims,
      [t.double() for t in dmasks])
  return qm, qs, j, aref, dvec, eqf, s_aref, s_dvec, dof, sign


def newton_cost(ex, qacc):
  """The Newton solve's objective at qacc on expanded operands `ex`, in
  float64: 0.5 e'M e plus 0.5 D jar^2 over the active rows, contact
  facets included, e = qacc - qs."""
  import torch
  qm, qs, j, aref, dvec, eqf, s_aref, s_dvec, dof, sign = ex
  qacc = qacc.double()
  e = qacc - qs
  cost = 0.5 * torch.sum(e * (qm @ e[..., None])[..., 0], -1)
  jar = (j @ qacc[..., None])[..., 0] - aref
  act = (jar < 0) | (eqf > 0.5)
  cost = cost + 0.5 * torch.sum(torch.where(act, dvec, 0.0) * jar * jar, -1)
  jar = sign * qacc[:, dof] - s_aref
  return cost + 0.5 * torch.sum(torch.where(jar < 0, s_dvec, 0.0) * jar
                                * jar, -1)


def newton_bound(args, gargs, condims, dmasks, cap, tol):
  """B2's bound for these inputs, float32.

  Bytes: each operand read once, each output written once. Of qm only the
  lower triangle (the kernel reads no more); an operand that is the same
  for every sample (dof, sign, the dmasks, and mu, which the contact rows
  broadcast from the pair parameters) once for the batch.

  Flops (a multiply-add is 2), for the iterations each sample takes in the
  plain version (the smallest cap that already gives its final answer),
  with the active set at the answer. Per iteration: 4 nv^2 (M e, M step)
  + nv^3/3 + 2 nv^2 (factor, two triangular solves); 16 per one-hot row;
  2 nv + 15 per dense row (J step, the 5-point line search); per point,
  the factored J step 12 nnz (w = sum_k dmask_k x_k cdofc_k over the
  point's nnz nonzero dmask entries) + 24 per facet (GF = G0 + s mu Gd,
  GF . w), and 15 per facet of a point in contact (line search); per
  active dense row nv^2 + 3 nv (Hessian lower triangle, gradient), per
  active facet the same + 12 + 12 nnz (GF, its row from cdofc)."""
  import torch
  from mujoco_mpc_tpu_torch.ops import newton
  run = lambda c: newton.newton_reference(  # noqa: E731
      *args, *gargs, cap=c, tol=tol, condims=condims, dmasks=dmasks)
  final = run(cap)
  qm, qs, j, _, _, eqf, _, _, _, _ = args
  bsz, nv = qs.shape
  iters = torch.full((bsz,), cap, device=qs.device)
  for c in range(cap - 1, 0, -1):
    same = torch.ones(bsz, dtype=torch.bool, device=qs.device)
    for g, w in zip(run(c), final):
      same &= (g.reshape(bsz, -1) == w.reshape(bsz, -1)).all(-1)
    iters = torch.where(same, c, iters)
  row_cost = nv * nv + 3 * nv
  active_d = ((final[1] < 0) | (eqf > 0.5)).sum(-1)
  per_iter = (6 * nv * nv + nv ** 3 / 3 + 16 * args[6].shape[1]
              + j.shape[1] * (2 * nv + 15) + active_d * row_cost)
  for gi in range(len(condims)):
    nnz = (dmasks[gi] != 0).sum(-1)                          # (P,)
    contact = gargs[3 + 4 * gi] > 0                          # (B, P)
    active = (final[3 + gi] < 0) & contact[:, None, :]       # (B, nrep, P)
    nrep = active.shape[1]
    per_iter = (per_iter + float(12 * nnz.sum() + 24 * nrep * nnz.numel())
                + 15 * nrep * contact.sum(-1)
                + (active * (row_cost + 12 + 12 * nnz)).sum((1, 2)))
  flops = float(torch.sum(iters * per_iter))

  def read(t):
    if t.dim() and t.shape[0] == bsz and torch.equal(t, t[:1].expand_as(t)):
      return t[0].numel() * t.element_size()
    return t.numel() * t.element_size()

  bytes_ = (bsz * nv * (nv + 1) // 2 * qm.element_size()
            + sum(read(t) for t in list(args[1:]) + list(gargs)
                  + list(dmasks))
            + sum(t.numel() * t.element_size() for t in final))
  return bound(bytes_, flops) + (float(iters.float().mean()),)


def random_spd(gen, bsz, n):
  import torch
  g = torch.randn((bsz, n, n), generator=gen, device=DEV)
  a = g @ g.transpose(1, 2) / n + torch.eye(n, device=DEV)
  return a.contiguous(), torch.randn((bsz, n), generator=gen, device=DEV)


def check_spd_random(gen):
  """Phase 3a: B1 against its plain version on random systems, every n
  from 1 to 32 (each bucket's padding rows) at B 1, 8192 and 8193 (a
  last block and warp that hold one system). cond(a) <= ~10 and n <= 32: f32
  rounding (the kernel fuses multiply-adds and multiplies by rsqrt where
  the plain version divides by a square root) stays < 1e-4."""
  from mujoco_mpc_tpu_torch.ops import linalg, spd_solve
  worst = 0.0
  for n in range(1, 33):
    for bsz in (1, CART_SAMPLES, CART_SAMPLES + 1):
      a, b = random_spd(gen, bsz, n)
      _, err = errors(spd_solve.solve_spd(a, b), linalg.solve_spd(a, b))
      check(err <= 1e-4, f'chol_solve vs plain, n {n} B {bsz}: {err:.3g} '
            f'> 1e-4')
      worst = max(worst, err)
  print(f'phase 3a chol_solve vs plain, every n in 1..32, B 1/{CART_SAMPLES}'
        f'/{CART_SAMPLES + 1}: max rel err {worst:.3g} (tol 1e-4)')


def check_spd_inputs(args, tol, what):
  """B1 against its plain version on a step's (qM, rhs): (max abs error,
  max relative error), the latter within `tol`."""
  from mujoco_mpc_tpu_torch.ops import linalg, spd_solve
  err_abs, err = errors(spd_solve.solve_spd(*args), linalg.solve_spd(*args))
  check(err <= tol, f'chol_solve on {what} inputs: {err:.3g} > {tol:g}')
  return err_abs, err


def library_spd(a, b):
  """torch.linalg's batched Cholesky and solve: B1's yardstick, never
  called by the port."""
  import torch
  factor, _ = torch.linalg.cholesky_ex(a)
  return torch.cholesky_solve(b[..., None], factor)[..., 0]


def time_spd(args, plain_reps=None):
  """B1's wall (CUDA events) and device (profiler) times on (a, b), its
  plain version's (over `plain_reps` calls: at n 24 and 32 one call is
  ~5,000-11,000 launches) and the library call's, and its bound."""
  from mujoco_mpc_tpu_torch.ops import linalg, spd_solve
  fns = {'chol_solve': lambda: spd_solve.solve_spd(*args),
         'chol_plain': lambda: linalg.solve_spd(*args),
         'chol_library': lambda: library_spd(*args)}
  reps = {k: plain_reps if k == 'chol_plain' and plain_reps else TIME_REPS
          for k in fns}
  wall = {k: cuda_time_ms(f, reps[k]) for k, f in fns.items()}
  dev = {k: device_us(f, reps[k], kernel='chol_solve_kernel'
                      if k == 'chol_solve' else None)
         for k, f in fns.items()}
  return wall, dev, spd_bound(args[0]), reps['chol_plain']


def spd_timing_line(wall, dev, bound_, plain_reps, a):
  b_ms, by = bound_
  return (f'chol_solve B {a.shape[0]} n {a.shape[1]}: kernel '
          f'{wall["chol_solve"] * 1e3:.1f} / {dev["chol_solve"]:.1f} us, '
          f'plain{"" if plain_reps == TIME_REPS else f" ({plain_reps} calls)"}'
          f' {wall["chol_plain"] * 1e3:.1f} / {dev["chol_plain"]:.1f} '
          f'us, torch.linalg.cholesky_ex + cholesky_solve '
          f'{wall["chol_library"] * 1e3:.1f} / {dev["chol_library"]:.1f} '
          f'us, bound {b_ms * 1e3:.2f} us ({by}); kernel device time '
          f'{dev["chol_solve"] / (b_ms * 1e3):.1f}x its bound')


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


def random_groups(gen, bsz, nv, groups, share):
  """Factored contact groups ((condim, P), ...) as tests/
  test_torch_newton.py makes them: cdofc, then per group (g, aref, dvec,
  mu), and the groups' (P, nv) dmasks in {-1, 0, 1}. A `share` of the
  points are in contact (dvec > 0); the rest carry dvec 0."""
  import torch
  from mujoco_mpc_tpu_torch.ops import newton
  r = lambda *s: torch.randn(s, generator=gen, device=DEV)  # noqa: E731
  u = lambda *s: torch.rand(s, generator=gen, device=DEV)  # noqa: E731
  gargs, dmasks = [0.5 * r(bsz, nv, 6)], []
  for condim, p in groups:
    nrep = len(newton.PYRAMID_FACETS[condim])
    dvec = torch.nn.functional.softplus(r(bsz, p))
    gargs += [r(bsz, p, condim, 6), r(bsz, nrep, p),
              torch.where(u(bsz, p) < share, dvec, 0.0),
              0.2 + 0.8 * u(bsz, 3, p)]
    dmasks.append(torch.randint(-1, 2, (p, nv), generator=gen, device=DEV
                                ).float())
  return tuple(gargs), tuple(dmasks)


def compare_newton(args, gargs=(), condims=(), dmasks=(), cap=30,
                   tol=1e-6):
  """Kernel vs plain version: (samples outside rtol 2e-3/atol 1e-3 of the
  plain version, max relative objective gap, max abs error, max relative
  objective gap over the samples outside the tolerance)."""
  import torch
  from mujoco_mpc_tpu_torch.ops import newton
  kw = dict(cap=cap, tol=tol, condims=condims, dmasks=dmasks)
  got = newton.newton(*args, *gargs, **kw)
  want = newton.newton_reference(*args, *gargs, **kw)
  bsz = args[1].shape[0]
  bad = torch.zeros(bsz, dtype=torch.bool, device=DEV)
  err = 0.0
  for g, w in zip(got, want):
    if g.numel():
      g, w = g.reshape(bsz, -1), w.reshape(bsz, -1)
      bad |= (torch.abs(g - w) > 1e-3 + 2e-3 * torch.abs(w)).any(-1)
      err = max(err, float(torch.max(torch.abs(g - w))))
  ex = expanded(args, gargs, condims, dmasks)
  c_got, c_want = newton_cost(ex, got[0]), newton_cost(ex, want[0])
  gap = torch.abs(c_got - c_want) / torch.clamp(torch.abs(c_want), min=1.0)
  return (int(bad.sum()), float(gap.max()), err,
          float(torch.where(bad, gap, 0.0).max()))


# A sample whose jar sits within f32 rounding of 0 can take the other side
# of an active-set boundary in the kernel (fused multiply-adds, another
# summation order) than in the plain loop; the two then follow different
# Newton paths for a while and may stop at different iterations, beyond
# the tolerance of tests/test_pallas_newton.py (rtol 2e-3, atol 1e-3).
# Both ends minimise one convex piecewise-quadratic cost, so such a sample
# must still be a near tie: a wrong kernel leaves an O(1) relative cost
# gap, two near-minimisers one near f32 rounding. So every sample outside
# the tolerance must have a relative cost gap <= 1e-5, and every sample
# one <= 1e-3; on problems shaped like a task's (`share`), at most 1% may
# be outside the tolerance.
def newton_ok(label, bsz, nbad, gap, bad_gap, share=True):
  check(gap <= 1e-3, f'newton ({label}, B {bsz}): relative cost gap '
        f'{gap:.3g} > 1e-3')
  check(bad_gap <= 1e-5, f'newton ({label}, B {bsz}): a sample outside '
        f'the tolerance has relative cost gap {bad_gap:.3g} > 1e-5')
  if share:
    check(nbad <= bsz // 100, f'newton ({label}, B {bsz}): {nbad} samples '
          f'disagree, more than 1% (each a near tie: their relative cost '
          f'gaps <= {bad_gap:.3g})')


def newton_line(nbad, bsz, gap, bad_gap, share=True):
  return (f'{nbad} of {bsz} samples outside rtol 2e-3/atol 1e-3'
          f'{" (bound 1%)" if share else ""}, their max relative cost '
          f'gap {bad_gap:.3g} (tol 1e-5); max relative cost gap {gap:.3g} '
          f'(tol 1e-3)')


def check_newton_random(gen):
  """Phase 3b: B2 on random dense and one-hot rows at nv 2, 8, 18, 24 and
  32, so that the buckets above the Quadruped's run on the card too."""
  for (nv, n, ns) in ((2, 0, 2), (8, 16, 4), (18, 24, 8), (24, 24, 8),
                      (32, 24, 8)):
    for bsz in (CART_SAMPLES, CART_SAMPLES + 37):
      nbad, gap, _, bad_gap = compare_newton(
          random_newton(gen, bsz, nv, n, ns))
      newton_ok(f'nv {nv}, n {n}, ns {ns}', bsz, nbad, gap, bad_gap)
      print(f'phase 3b newton vs plain, nv {nv} n {n} ns {ns} B {bsz} cap 30:'
            f' {newton_line(nbad, bsz, gap, bad_gap)}')


def check_newton_cartpole(args, cap):
  """Phase 3c's B2 part: (max abs error, max relative error, active limit
  rows) on the Cartpole step's inputs. One-hot rows and nv = 2: no
  near-boundary flips seen; f32 rounding of qacc up to ~1e3 past the
  limit, so 1e-4 relative."""
  from mujoco_mpc_tpu_torch.ops import newton
  got = newton.newton(*args, cap=cap, tol=1e-5)
  want = newton.newton_reference(*args, cap=cap, tol=1e-5)
  err_abs, err = max(errors(g, w) for g, w in zip(got, want) if g.shape[1])
  check(err <= 1e-4, f'newton on Cartpole inputs: {err:.3g}')
  return err_abs, err, int((got[2] < 0).sum())


def check_newton_groups(gen):
  """Phase 3d: B2's contact groups at two densities. Task-shaped: P per
  group at nv 18 as in the Quadruped (one condim-3 group of 20 points, 80
  facet rows beside 24 limit rows), scaled with nv, a quarter of the
  points in contact (its step has ~18%). Dense: the same P at both nv and
  half the points in contact, as tests/test_torch_newton.py makes them. A
  random problem with many more rows than dofs sits on many kinks at its
  optimum, where f32 near ties multiply; the last line counts them by rows
  per dof."""
  from mujoco_mpc_tpu_torch.ops import newton
  group_sets = {'condim 1': ((1, 20),), 'condim 3': ((3, 20),),
                'condim 4': ((4, 12),), 'condim 6': ((6, 8),),
                'condim 3 + 6': ((3, 12), (6, 4))}
  ties = {}
  for density, share, task in (('task-shaped', 0.25, True),
                               ('dense', 0.5, False)):
    for label, groups18 in group_sets.items():
      for nv in (8, 18):
        groups = tuple((c, max(1, round(p * nv / 18)) if task else p)
                       for c, p in groups18)
        rows = 4 + 8 + sum(len(newton.PYRAMID_FACETS[c]) * p
                           for c, p in groups)
        for bsz in (QUAD_SAMPLES, QUAD_SAMPLES + 1):
          gargs, dmasks = random_groups(gen, bsz, nv, groups, share)
          nbad, gap, _, bad_gap = compare_newton(
              random_newton(gen, bsz, nv, 4, 8), gargs,
              tuple(c for c, _ in groups), dmasks)
          newton_ok(f'{density} {label}, nv {nv}', bsz, nbad, gap, bad_gap,
                    task)
          tie = ties.setdefault((round(rows / nv, 1), share), [0, 0])
          tie[0], tie[1] = tie[0] + nbad, tie[1] + bsz
          print(f'phase 3d newton groups vs plain, {density} {label} (P '
                f'{"+".join(str(p) for _, p in groups)}, {share:g} in '
                f'contact, {rows / nv:.1f} rows per dof), nv {nv} n 4 ns 8 '
                f'B {bsz} cap 30: '
                + newton_line(nbad, bsz, gap, bad_gap, task))
  print('phase 3d near ties by rows per dof (rows per dof, share in '
        'contact: samples outside the tolerance of all): ' + '; '.join(
            f'{r:.1f}, {sh:g}: {nb} of {b}'
            for (r, sh), (nb, b) in sorted(ties.items())))


def check_newton_task(label, args, gargs, kw, share=True):
  """Phases 3e and 3f's B2 part on a task step's inputs: (max abs error,
  the line's text, with the rows per dof and the share of the points in
  contact, by which phase 3d counts the near ties). `share` as in
  newton_ok: False for states far deeper in contact than a step reaches,
  which are held to the near-tie rule of phase 3d's dense problems."""
  from mujoco_mpc_tpu_torch.ops import newton
  bsz, nv = args[1].shape
  nbad, gap, err_abs, bad_gap = compare_newton(args, gargs, **kw)
  newton_ok(f'{label} inputs', bsz, nbad, gap, bad_gap, share)
  want = newton.newton_reference(*args, *gargs, **kw)
  in_contact = int((gargs[3] > 0).sum())
  facets = int(((want[3] < 0) & (gargs[3][:, None, :] > 0)).sum())
  violated = int((args[7] > 0).sum())
  limits = int(((want[2] < 0) & (args[7] > 0)).sum())
  rows = args[2].shape[1] + args[6].shape[1] + sum(
      len(newton.PYRAMID_FACETS[c]) * g.shape[-1]
      for c, g in zip(kw['condims'], gargs[3::4]))
  return err_abs, (
      f'{in_contact} points in contact ({in_contact / gargs[3].numel():.3f}'
      f' of all), {facets} of their facets active at the solution; '
      f'{violated} limit rows violated, {limits} active at the solution; '
      f'{rows / nv:.1f} rows per dof; newton cap {kw["cap"]}: '
      f'{newton_line(nbad, bsz, gap, bad_gap, share)}')


def time_newton(args, gargs, kw, plain_reps=None):
  """Phase 4's B2 part: wall (CUDA events) and device (profiler) times of
  the kernel and its plain version (over `plain_reps` calls), and the
  bound for these inputs."""
  from mujoco_mpc_tpu_torch.ops import newton
  fns = {'newton': lambda: newton.newton(*args, *gargs, **kw),
         'newton_plain': lambda: newton.newton_reference(*args, *gargs,
                                                         **kw)}
  reps = {k: plain_reps if k == 'newton_plain' and plain_reps else TIME_REPS
          for k in fns}
  wall = {k: cuda_time_ms(f, reps[k]) for k, f in fns.items()}
  dev = {k: device_us(f, reps[k], kernel='newton_kernel'
                      if k == 'newton' else None)
         for k, f in fns.items()}
  b_ms, by, iters = newton_bound(args, gargs, kw.get('condims', ()),
                                 kw.get('dmasks', ()), kw['cap'], kw['tol'])
  return wall, dev, (b_ms, by), iters


def newton_timing_line(label, wall, dev, bound_, iters, plain_reps=None):
  b_ms, by = bound_
  return (f'newton {label}: kernel {wall["newton"] * 1e3:.1f} / '
          f'{dev["newton"]:.1f} us, plain'
          f'{f" ({plain_reps} calls)" if plain_reps else ""} '
          f'{wall["newton_plain"] * 1e3:.1f} / '
          f'{dev["newton_plain"]:.1f} us, bound {b_ms * 1e3:.2f} us ({by}; '
          f'{iters:.2f} iterations per sample); kernel device time '
          f'{dev["newton"] / (b_ms * 1e3):.1f}x its bound')


def resident_blocks(nv, threads, smem):
  """Blocks of B2's nv-bucket instance that one SM holds at once, with
  `threads` threads and `smem` bytes of dynamic shared memory a block (the
  CUDA occupancy calculator, through the kernel's library)."""
  import ctypes
  from mujoco_mpc_tpu_torch.ops import cuda_build
  blocks = ctypes.c_int(0)
  cuda_build.check(cuda_build.load('newton').mjpc_newton_blocks_per_sm(
      nv, threads, smem, ctypes.byref(blocks)), 'newton occupancy')
  return blocks.value


def newton_smem():
  """[(nv, text)]: the dynamic shared memory B2 takes at the four paths'
  shapes (the kernel sizes it at launch, 128 threads a block) and the
  samples an SM then holds. The Humanoid's and Shadow's blocks are past
  48 KB, through the kernel's opt-in attribute; Shadow's 228 facet rows
  leave room for one block an SM."""
  from mujoco_mpc_tpu_torch.ops import newton
  out = []
  for nv, shape, smem in (
      (2, 'Cartpole nv 2 ns 2', newton.sample_smem_bytes(2, 0, 2)),
      (18, 'Quadruped nv 18 ns 24, condim-3 P 20',
       newton.sample_smem_bytes(18, 0, 24, [(3, 20)])),
      (23, 'Humanoid nv 23 ns 34, condim-3 P 25',
       newton.sample_smem_bytes(23, 0, 34, [(3, 25)])),
      (21, 'Shadow nv 21 ns 30, condim-3 P 57',
       newton.sample_smem_bytes(21, 0, 30, [(3, 57)]))):
    tiles = 128 // newton.kernel_lanes(nv)
    blocks = resident_blocks(nv, 128, tiles * smem)
    out.append((nv, f'dynamic shared memory at {shape}: {smem} bytes a '
                f'sample, {tiles * smem} a block of {tiles}; {blocks} '
                f'blocks, {blocks * tiles} samples resident per SM'))
  return out


_SPILLS = re.compile(r'(\d+) bytes spill stores, (\d+) bytes spill loads')


def ptxas_lines(name, lib):
  """Phase 2's report on kernel `name` ('chol_solve' or 'newton') built
  into `lib`: a line per bucket instance with ptxas -v's registers, stack
  frame and spills (from the build log beside `lib`) and the shared
  memory it takes; and the bytes all instances spill. Fails if an
  instance has no report."""
  from mujoco_mpc_tpu_torch.ops import newton, spd_solve
  with open(lib + '.log') as f:
    log = f.read().splitlines()
  if name == 'chol_solve':
    kernel, label, buckets = 'chol_solve_kernel', 'N', spd_solve.N_BUCKETS
    smem = lambda nb: (  # noqa: E731
        f'; shared memory {spd_solve.block_smem_bytes(nb)} bytes a block of '
        f'{spd_solve.THREADS // spd_solve.kernel_lanes(nb)} systems')
  else:
    kernel, label, buckets = 'newton_kernel', 'nv', newton.NV_BUCKETS
    smem = lambda nb: ''  # noqa: E731
  out, spilled = [], 0
  for nb in buckets:
    found = []
    for i, line in enumerate(log):
      if 'Compiling entry function' in line and f'{kernel}ILi{nb}E' in line:
        for follow in log[i + 1:]:
          if 'Compiling entry function' in follow:
            break
          if 'stack frame' in follow or 'Used' in follow:
            found.append(follow.split(' : ', 1)[-1].strip())
    check(found, f'no ptxas report for {kernel}<{nb}> in {lib}.log')
    spilled += sum(int(x) for f in found for m in [_SPILLS.search(f)] if m
                   for x in m.groups())
    out.append(f'ptxas -v, {name} {label}-{nb} instance: '
               + ' | '.join(found) + smem(nb))
  if name == 'newton':
    out += [f'newton {text}' for _, text in newton_smem()]
  return out, spilled


def errors(got, want):
  """(max abs error, max abs error / max(1, max |want|))."""
  import torch
  err = float(torch.max(torch.abs(got - want)))
  return err, err / max(1.0, float(torch.max(torch.abs(want))))


def solver_inputs(spec, d):
  """The operands one step of `spec` from states d hands both kernels:
  (B1's (qM, qfrc_smooth), B2's (args, gargs, condims, dmasks))."""
  from mujoco_mpc_tpu_torch.physics import constraint, forward as fwd, smooth
  import torch
  m = spec.model
  d = fwd.fwd_actuation(m, fwd.fwd_velocity(m, fwd.fwd_position(m, d)))
  d = smooth.crb(m, d).replace(qfrc_constraint=torch.zeros_like(d.qvel))
  d = fwd.fwd_acceleration(m, d)
  rows, scalar, points = constraint.make_rows_split(m, d)
  args, gargs, condims, dmasks = constraint.newton_operands(m, d, rows,
                                                            scalar, points)
  args = tuple(t.contiguous() for t in args)
  return (d.qM.contiguous(), d.qfrc_smooth.contiguous()), (
      args, gargs, condims, dmasks)


def cartpole_states(spec, gen):
  """8192 states around the start state, some past the slider limit."""
  import torch
  from mujoco_mpc_tpu_torch.physics.model import make_data
  qpos = torch.tensor(CART_QPOS0, device=DEV) + torch.randn(
      (CART_SAMPLES, 2), generator=gen, device=DEV) * torch.tensor(
          [1.2, 1.0], device=DEV)
  return make_data(spec.model, CART_SAMPLES).replace(
      qpos=qpos, qvel=2.0 * torch.randn((CART_SAMPLES, 2), generator=gen,
                                        device=DEV),
      ctrl=torch.rand((CART_SAMPLES, 1), generator=gen, device=DEV) * 2 - 1)


def quadruped_states(spec, gen):
  """4096 states around `home`: the trunk lowered by up to 8 cm and
  tilted, so that feet, shanks and some trunk corners go into the floor,
  and the leg joints spread by 0.4 rad, some past their limits."""
  import torch
  from mujoco_mpc_tpu_torch.physics.model import make_data
  from mujoco_mpc_tpu_torch.utils import math as tm
  m, b = spec.model, QUAD_SAMPLES
  r = lambda *s: torch.randn(s, generator=gen, device=DEV)  # noqa: E731
  qpos = m.keyframe_qpos('home').expand(b, -1).clone()
  qpos[:, 2] -= 0.08 * torch.rand(b, generator=gen, device=DEV)
  qpos[:, 3:7] = tm.quat_normalize(qpos[:, 3:7] + 0.1 * r(b, 4))
  qpos[:, 7:] += 0.4 * r(b, 12)
  lo, hi = m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1]
  ctrl = lo + (hi - lo) * torch.rand((b, m.nu), generator=gen, device=DEV)
  return make_data(m, b).replace(qpos=qpos, qvel=0.5 * r(b, m.nv),
                                 ctrl=ctrl)


def humanoid_states(spec, gen, deep=False):
  """512 states around `home` (the clip's first pose, its feet ~0.2 m
  above the floor), tilted, the hinges spread by 0.4 rad, some past their
  limits, and the torso lowered by 0.2-0.3 m, so that the feet go up to
  ~0.1 m into the floor as a rollout's landing takes them (the
  Quadruped's states go 8 cm deep); `deep`: by 0.15-0.75 m, so that feet,
  shins and at the deepest the pelvis go far into it, deeper than a step
  reaches."""
  import torch
  from mujoco_mpc_tpu_torch.physics.model import make_data
  from mujoco_mpc_tpu_torch.utils import math as tm
  m, b = spec.model, HUMAN_SAMPLES
  r = lambda *s: torch.randn(s, generator=gen, device=DEV)  # noqa: E731
  qpos = m.keyframe_qpos('home').expand(b, -1).clone()
  lowered = torch.rand(b, generator=gen, device=DEV)
  qpos[:, 2] -= 0.15 + 0.6 * lowered if deep else 0.2 + 0.1 * lowered
  qpos[:, 3:7] = tm.quat_normalize(qpos[:, 3:7] + 0.1 * r(b, 4))
  qpos[:, 7:] += 0.4 * r(b, m.nq - 7)
  lo, hi = m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1]
  ctrl = lo + (hi - lo) * torch.rand((b, m.nu), generator=gen, device=DEV)
  return make_data(m, b).replace(qpos=qpos, qvel=0.5 * r(b, m.nv),
                                 ctrl=ctrl)


def shadow_states(spec, gen, rollout=True):
  """SHADOW_SAMPLES states of Shadow Reorient from qpos0 (the cube 20 mm
  above the palm), the first SHADOW_QPOS0 exactly qpos0 at rest. The rest,
  with `rollout`, are the states the step meets in a plan: from qpos0,
  SHADOW_ROLLOUT_STEPS steps of the planning model (dt 0.01) under
  controls drawn uniformly in the control range at each step, which drop
  the cube onto the palm (~6 steps) and close the fingers on it; without,
  a construction deeper in contact than a step goes: the cube lowered by
  20-30 mm, so 0-10 mm into the palm, and tilted by 1-5 degrees about a
  random axis, the 15 hinges spread uniformly over their ranges, random
  velocities and controls."""
  import math
  import torch
  from mujoco_mpc_tpu_torch import agent
  from mujoco_mpc_tpu_torch.physics import forward as fwd
  from mujoco_mpc_tpu_torch.physics.model import make_data
  m, b = spec.model, SHADOW_SAMPLES
  u = lambda *s: torch.rand(s, generator=gen, device=DEV)  # noqa: E731
  clo, chi = m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1]
  if rollout:
    pm = agent.plan_model(spec)
    d = make_data(m, b)
    for _ in range(SHADOW_ROLLOUT_STEPS):
      d = fwd.step(pm, d.replace(ctrl=clo + (chi - clo) * u(b, m.nu)))
    qpos, qvel, ctrl = d.qpos.clone(), d.qvel.clone(), d.ctrl.clone()
  else:
    qpos = m.qpos0.expand(b, -1).clone()
    lo, hi = m.jnt_range[1:, 0], m.jnt_range[1:, 1]
    qpos[:, 7:] = lo + (hi - lo) * u(b, 15)
    qpos[:, 2] -= 0.02 + 0.01 * u(b)
    axis = torch.randn((b, 3), generator=gen, device=DEV)
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    half = 0.5 * math.radians(1.0) + 0.5 * math.radians(4.0) * u(b)
    qpos[:, 3:7] = torch.cat([torch.cos(half)[:, None],
                              torch.sin(half)[:, None] * axis], -1)
    qvel = 0.3 * torch.randn((b, m.nv), generator=gen, device=DEV)
    ctrl = clo + (chi - clo) * u(b, m.nu)
  rest = slice(0, SHADOW_QPOS0)
  qpos[rest], qvel[rest], ctrl[rest] = m.qpos0, 0.0, 0.0
  return make_data(m, b).replace(qpos=qpos, qvel=qvel, ctrl=ctrl)


def contact_points(spec, d):
  """(dist (B, P), pos (B, P, 3), normal (B, P, 3), the hull's world
  vertices (B, V, 3)) of the step from states d: every condim group's
  stacked candidate points in JAX's order."""
  import torch
  from mujoco_mpc_tpu_torch.physics import collision, constraint
  from mujoco_mpc_tpu_torch.physics import forward as fwd
  m = spec.model
  d = fwd.fwd_position(m, d)
  groups = constraint._contact_groups(m, d).values()
  hull = next(iter(m.geom_mesh))
  return (torch.cat([s.dist for s in groups], 1),
          torch.cat([s.pos3 for s in groups], 1),
          torch.cat([s.normal for s in groups], 1),
          collision._hull_world(m, d, hull)[0])


def vertex_ids(pts, sl):
  """The hull vertex of each candidate in the points `sl` of a vertex
  choice (the candidate sits halfway into the penetration, pos + dist/2
  normal is the vertex): (B, len(sl)) indices."""
  import torch
  dist, pos, normal, verts = (x.double() for x in pts)
  v = (pos + 0.5 * dist[..., None] * normal)[:, sl]
  return torch.argmin(torch.linalg.vector_norm(
      v[:, :, None] - verts[:, None], dim=-1), -1)


def vertex_choices(m):
  """The points of the model's (one) contact group that are hull vertices
  chosen by depth: the floor's k deepest (plane-mesh) and the second half
  of box-mesh (the hull vertices in the box), unrolled or clustered."""
  from mujoco_mpc_tpu_torch.physics import collision, constraint
  from mujoco_mpc_tpu_torch.physics.model import GeomType
  out, start = [], 0
  for src in m.contact[0].sources:
    g1, g2 = src.pairs[0]
    if src.kind == 'pair':
      n = collision.points_per_pair(m, g1, g2)
      kind = ({GeomType.PLANE: 'pm', GeomType.BOX: 'bm'}.get(m.geom_type[g1])
              if m.geom_type[g2] == GeomType.MESH else None)
    else:
      _, reps, halves = constraint.CLUSTERS[src.kind]
      n, kind = len(src.pairs) * reps * halves, src.kind
    if kind == 'pm':
      out += range(start, start + n)
    elif kind == 'bm':
      out += range(start + n // 2, start + n)
    start += n
  return out


def check_contact_points(spec, cpu_spec, d):
  """Phase 3h: the candidate points the card's step stacks from states d
  against the same step on the CPU through the plain path, float32 both.
  Every depth agrees within POINT_ATOL (the k-th depth and the largest
  halfspace distance are continuous through a tie). At the SHADOW_QPOS0
  samples at qpos0 every position and normal agrees and the chosen hull
  vertices are the same: an exact tie of 8 vertices that the stable
  selection resolves to the lower indices on both. Elsewhere a point may
  differ in position or normal only at an f32 near tie (two vertices or
  two faces within rounding), at most 0.1% of the points. Returns the
  line's text."""
  import dataclasses
  import torch
  from mujoco_mpc_tpu_torch.physics.model import Data
  cpu_d = Data(**{f.name: getattr(d, f.name).cpu()
                  for f in dataclasses.fields(d)
                  if getattr(d, f.name) is not None})
  card = [x.cpu() for x in contact_points(spec, d)]
  cpu = contact_points(cpu_spec, cpu_d)
  dist_err = float(torch.max(torch.abs(card[0] - cpu[0])))
  check(dist_err <= POINT_ATOL, f'contact depths, card vs CPU: '
        f'{dist_err:.3g} > {POINT_ATOL:g}')
  pos_err = torch.amax(torch.abs(card[1] - cpu[1]), -1)
  normal_err = torch.amax(torch.abs(card[2] - cpu[2]), -1)
  off = (pos_err > POINT_ATOL) | (normal_err > NORMAL_ATOL)
  sl = vertex_choices(spec.model)
  ids_card, ids_cpu = vertex_ids(card, sl), vertex_ids(cpu, sl)
  rest = slice(0, SHADOW_QPOS0)
  check(not bool(off[rest].any()), 'contact points at qpos0, card vs CPU: '
        f'{int(off[rest].sum())} points outside the tolerance')
  check(torch.equal(ids_card[rest], ids_cpu[rest]),
        'the tied hull vertices at qpos0 differ between the card and CPU')
  low = cpu[3][0, :, 2] == cpu[3][0, :, 2].min()
  check(bool(low[ids_cpu[0]].all()) and int(low.sum()) == 8,
        'qpos0 does not tie 8 hull vertices for the floor')
  n_vertex = int((ids_card != ids_cpu).sum())
  n_off = int(off.sum())
  n_off_contact = int((off & ((card[0] < 0) | (cpu[0] < 0))).sum())
  check(n_off <= off.numel() // 1000, f'contact points, card vs CPU: '
        f'{n_off} of {off.numel()} differ, more than 0.1%')
  return (f'{off.shape[1]} points a sample, depths max abs err '
          f'{dist_err:.3g} (tol {POINT_ATOL:g}); positions '
          f'{float(pos_err.max()):.3g} and normals '
          f'{float(normal_err.max()):.3g} max abs err (tol {POINT_ATOL:g}, '
          f'{NORMAL_ATOL:g}) at all but {n_off} of {off.numel()} points '
          f'(f32 near ties, bound 0.1%; {n_off_contact} of them in '
          f'contact); at the {SHADOW_QPOS0} qpos0 '
          f'samples every point agrees and the floor and palm take hull '
          f'vertices {ids_cpu[0].tolist()} of the 8 tied ones '
          f'{torch.nonzero(low)[:, 0].tolist()} on both; {n_vertex} of '
          f'{ids_cpu.numel()} vertex choices differ elsewhere')


def euler_inputs(spec, d):
  """B1's second system of a step from states d: M + h diag(damping) and
  qfrc_smooth + qfrc_constraint, as physics/forward.py _euler solves it
  (the forward pass runs both kernels)."""
  import torch
  from mujoco_mpc_tpu_torch.physics import forward as fwd
  m = spec.model
  d = fwd.forward(m, d)
  return ((d.qM + m.opt.timestep * torch.diag(m.dof_damping)).contiguous(),
          (d.qfrc_smooth + d.qfrc_constraint).contiguous())


def main_path(spec, d0, samples, reps, gen):
  """Predictive Sampling plans of `spec` from d0: a warm-up, then `reps`
  timed plans with the kernels' counts set to 0 just before and read just
  after, then one profiled plan."""
  import torch
  from mujoco_mpc_tpu_torch import agent
  from mujoco_mpc_tpu_torch.ops import newton, spd_solve, spline
  from mujoco_mpc_tpu_torch.planners import sampling
  t_steps = agent.horizon_steps(spec)
  cfg = sampling.default_config(spec)

  def plan(pol):
    noise = sampling.sample_noise(spec, SPLINE_POINTS, samples, cfg, gen)
    return sampling.optimize(spec, pol, d0, spec.default_params, cfg, noise,
                             t_steps, int(spline.Interp.ZERO))

  pol, _ = plan(sampling.default_policy(spec, SPLINE_POINTS))   # warm-up
  torch.cuda.synchronize()
  spd_solve.solve_spd.launches = 0
  newton.newton.launches = 0
  lat, infos = [], []
  for _ in range(reps):
    t0 = time.perf_counter()
    pol, info = plan(pol)
    torch.cuda.synchronize()
    lat.append(time.perf_counter() - t0)
    infos.append(info)
  launches = {'chol_solve': spd_solve.solve_spd.launches,
              'newton': newton.newton.launches}
  check(launches['newton'] == reps * t_steps,
        f'newton launched {launches["newton"]} times, expected '
        f'{reps * t_steps} (once per rollout step)')
  check(launches['chol_solve'] == 2 * reps * t_steps,
        f'chol_solve launched {launches["chol_solve"]} times, expected '
        f'{2 * reps * t_steps} (twice per rollout step)')
  best = torch.stack([i['best_return'] for i in infos]).cpu()
  nominal = torch.stack([i['nominal_return'] for i in infos]).cpu()
  check(bool(torch.isfinite(best).all()), f'best_return not finite: {best}')
  check(bool((best <= nominal).all()), 'best_return > nominal_return')
  p50 = statistics.median(lat)
  dev_us, ops, top = device_us(lambda: plan(pol), reps=1, top=8)
  return dict(t_steps=t_steps, p50=p50, launches=launches,
              best=float(best[-1]), nominal=float(nominal[-1]),
              dev_us=dev_us, ops=ops, top=top)


def print_main_path(phase, name, samples, reps, r):
  print(f'phase {phase} main path: {name} {samples} candidates x '
        f'{r["t_steps"]} steps, {reps} plans: p50 {r["p50"] * 1e3:.2f} ms, '
        f'{1.0 / r["p50"]:.2f} plans/s; launches chol_solve '
        f'{r["launches"]["chol_solve"]}, newton {r["launches"]["newton"]}; '
        f'best_return {r["best"]:.5g} <= nominal {r["nominal"]:.5g}; '
        f'profiled plan: {r["ops"]} device ops, device busy '
        f'{r["dev_us"] / 1e3:.2f} ms = {r["dev_us"] / 1e4 / r["p50"]:.1f}% '
        f'of p50')
  print(f'phase {phase} device time per plan by op (name: count, ms): '
        + '; '.join(f'{n[:48]}: {c}, {us / 1e3:.2f}'
                    for n, c, us in r['top']))


def golden(spec, cpu_spec, d0, d0_cpu, gen, ctrl_scale):
  """A 256-candidate plan on the card against the plain path on the CPU
  with the same noise, from the default plan, and a 5-step batched
  rollout's qpos drift: (best_return card, CPU, rel err, winner card,
  CPU, winner within 2 % of the CPU best, drift)."""
  import torch
  from mujoco_mpc_tpu_torch import agent
  from mujoco_mpc_tpu_torch.ops import spline
  from mujoco_mpc_tpu_torch.physics import forward as fwd
  from mujoco_mpc_tpu_torch.planners import sampling
  t_steps, interp = agent.horizon_steps(spec), int(spline.Interp.ZERO)
  cfg, cpu_cfg = (sampling.default_config(spec),
                  sampling.default_config(cpu_spec))
  eps, use2 = sampling.sample_noise(spec, SPLINE_POINTS, 255, cfg, gen)
  pol = sampling.default_policy(spec, SPLINE_POINTS)
  _, info_gpu = sampling.optimize(spec, pol, d0, spec.default_params, cfg,
                                  (eps, use2), t_steps, interp)
  pol_cpu = sampling.SamplingPolicy(pol.times.cpu(), pol.values.cpu())
  _, info_cpu = sampling.optimize(cpu_spec, pol_cpu, d0_cpu,
                                  cpu_spec.default_params, cpu_cfg,
                                  (eps.cpu(), use2.cpu()), t_steps, interp)
  br_gpu, br_cpu = (float(info_gpu['best_return']),
                    float(info_cpu['best_return']))
  rel = abs(br_gpu - br_cpu) / max(abs(br_cpu), 1e-9)
  win_gpu, win_cpu = int(info_gpu['winner']), int(info_cpu['winner'])
  near = float(info_cpu['returns'][win_gpu]) <= br_cpu * 1.02 + 1e-9
  ctrl = ctrl_scale * torch.randn((256, 5, spec.model.nu), generator=gen,
                                  device=DEV)
  qpos_run = []
  for m, c, d in ((spec.model, ctrl, d0), (cpu_spec.model, ctrl.cpu(),
                                           d0_cpu)):
    d = d.expand(256)
    for k in range(5):
      d = fwd.step(m, d.replace(ctrl=c[:, k]))
    qpos_run.append(d.qpos.cpu())
  drift = float(torch.max(torch.abs(qpos_run[0] - qpos_run[1])))
  # bounds of bench.py's TPU golden check (fused_newton_golden)
  check(rel <= 0.02, f'golden best_return rel err {rel:.3g} > 0.02')
  check(near, 'the card\'s winner is not within 2% of the CPU best')
  check(drift <= 0.05, f'golden qpos drift {drift:.3g} > 0.05')
  return br_gpu, br_cpu, rel, win_gpu, win_cpu, drift


def plan_act(spec, sim0, samples, total_steps, seed):
  """synchronous_mpc with 4 steps per plan: (steps, simulated s, wall s,
  real-time factor, mean cost, last cost)."""
  import torch
  from mujoco_mpc_tpu_torch import agent
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  _, costs = agent.synchronous_mpc(
      spec, samples, total_steps, 4,
      torch.Generator(device=DEV).manual_seed(seed), sim0=sim0)
  costs = costs.cpu()
  wall = time.perf_counter() - t0
  check(bool(torch.isfinite(costs).all()), 'plan-act costs not finite')
  sim_time = len(costs) * float(spec.model.opt.timestep)
  return (len(costs), sim_time, wall, sim_time / wall, float(costs.mean()),
          float(costs[-1]))


# ---------------------------------------------------------------------------
# iLQG with exact derivatives: Particle and Swimmer (phases 3i, 17-20)
# ---------------------------------------------------------------------------


class plain_versions:
  """Within this block both Functions (ops/spd_solve.SpdSolve and
  ops/newton.NewtonSolve) reach their plain versions on the card too, so
  the same Function, jvp and vmap rules included, runs once through the
  kernels and once through the plain versions. Nothing is counted as a
  launch in it."""

  def __enter__(self):
    from mujoco_mpc_tpu_torch.ops import linalg, newton, spd_solve
    self.saved = spd_solve._solve, newton._newton
    spd_solve._solve = linalg.solve_spd
    newton._newton = newton.newton_reference
    return self

  def __exit__(self, *exc):
    from mujoco_mpc_tpu_torch.ops import newton, spd_solve
    spd_solve._solve, newton._newton = self.saved


class record_batches:
  """Records the batch of every call of the kernels' dispatch (`calls`:
  [('chol_solve' or 'newton', B), ...]); the calls go on to the kernels."""

  def __enter__(self):
    from mujoco_mpc_tpu_torch.ops import newton, spd_solve
    self.saved = spd_solve._solve, newton._newton
    self.calls = []
    solve, newt = self.saved

    def rec_solve(a, b):
      self.calls.append(('chol_solve', b.shape[0]))
      return solve(a, b)

    def rec_newton(*args, **kw):
      self.calls.append(('newton', args[1].shape[0]))
      return newt(*args, **kw)
    spd_solve._solve, newton._newton = rec_solve, rec_newton
    return self

  def __exit__(self, *exc):
    from mujoco_mpc_tpu_torch.ops import newton, spd_solve
    spd_solve._solve, newton._newton = self.saved


def tangent_directions(gen, primals, dirs):
  """`dirs` random tangent directions (stacked on a leading axis) for each
  float operand with the batch's leading dimension, each sample's scaled
  to that sample's largest entry (symmetric for the (B, n, n) matrices),
  as the derivative pass's perturbations are; None for the integer
  operands, the empty ones and the model constants (dof, sign)."""
  import torch
  bsz = primals[1].shape[0]
  out = []
  for t in primals:
    if (not t.is_floating_point() or t.dim() < 2 or t.shape[0] != bsz
        or not t.numel()):
      out.append(None)
      continue
    r = torch.randn((dirs,) + tuple(t.shape), generator=gen, device=DEV)
    if t.dim() == 3 and t.shape[1] == t.shape[2]:
      r = 0.5 * (r + r.transpose(2, 3))
    scale = torch.abs(t).reshape(bsz, -1).amax(-1).clamp(min=1e-6)
    out.append(r * scale.reshape((1, bsz) + (1,) * (t.dim() - 1)))
  return out


def jvp_both(fn, primals, tangents):
  """vmap over the directions of torch.func.jvp of fn, through the kernels
  and through the plain versions: ((outputs, tangents) kernel, plain)."""
  import torch
  idx = [i for i, t in enumerate(tangents) if t is not None]

  def run():
    def one(*ts):
      def f(*xs):
        full = list(primals)
        for i, x in zip(idx, xs):
          full[i] = x
        return fn(*full)
      return torch.func.jvp(f, tuple(primals[i] for i in idx), ts)
    return torch.func.vmap(one, out_dims=(None, 0))(
        *(tangents[i] for i in idx))
  got = run()
  with plain_versions():
    want = run()
  return got, want


def tangent_bad(got, want, bsz):
  """(samples whose outputs or tangents lie outside rtol 2e-3 / atol 1e-3
  of the plain version's, max abs error). Per sample and output, over its
  entries and directions: |got - want|_max <= 1e-3 + 2e-3 |want|_max, the
  tolerance taken against the sample's largest entry, since an f32 solve
  of a system of condition number k errs by ~k * 6e-8 of that (Swimmer's
  qM: k ~2e4). got and want are jvp_both's (outputs (B, ...), tangents
  (D, B, ...)), a tensor or a tuple each."""
  import torch
  bad = torch.zeros(bsz, dtype=torch.bool, device=DEV)
  err = 0.0
  for part in (0, 1):
    gs, ws = got[part], want[part]
    if torch.is_tensor(gs):
      gs, ws = (gs,), (ws,)
    for g, w in zip(gs, ws):
      if not g.numel():
        continue
      if part == 0:
        g, w = g[None], w[None]
      g = g.reshape(g.shape[0], bsz, -1).transpose(0, 1).reshape(bsz, -1)
      w = w.reshape(w.shape[0], bsz, -1).transpose(0, 1).reshape(bsz, -1)
      diff = torch.abs(g - w).amax(-1)
      bad |= diff > 1e-3 + 2e-3 * torch.abs(w).amax(-1)
      err = max(err, float(diff.max()))
  return bad, err


def check_tangents(gen, swim, q_inputs):
  """Phase 3i: both Functions' jvp, vmapped over tangent directions,
  through the kernels against the same Functions through the plain
  versions, on the card. B1 and B2 at Swimmer's derivative shapes (the
  200 knots of a 201-step horizon, 21 directions: B1's tangent at B
  4,200), and B2 with its contact group at the Quadruped step's inputs
  (4 directions). A sample outside the tolerance must be a near tie of
  the primal Newton solve (3d's rule), at most 1% of them."""
  import torch
  from mujoco_mpc_tpu_torch import agent
  from mujoco_mpc_tpu_torch.ops import newton, spd_solve
  from mujoco_mpc_tpu_torch.physics.model import make_data
  from mujoco_mpc_tpu_torch.planners import derivatives
  m = swim.model
  knots = agent.horizon_steps(swim) - 1
  dirs = derivatives.ndx(m) + m.nu
  q = m.qpos0 + 0.3 * torch.randn((knots, m.nq), generator=gen, device=DEV)
  d = make_data(m, knots).replace(
      qpos=q, qvel=torch.randn((knots, m.nv), generator=gen, device=DEV),
      ctrl=torch.rand((knots, m.nu), generator=gen, device=DEV) * 2 - 1)
  spd_in, (args, _, _, _) = solver_inputs(swim, d)
  lines = []
  with record_batches() as rec:
    got, want = jvp_both(spd_solve.solve_spd, list(spd_in),
                         tangent_directions(gen, spd_in, dirs))
  bad, err = tangent_bad(got, want, knots)
  check(('chol_solve', knots * dirs) in rec.calls,
        f'B1 tangent not launched at B {knots * dirs}: {rec.calls}')
  check(not bool(bad.any()), f'B1 jvp: {int(bad.sum())} of {knots} '
        f'systems outside rtol 2e-3/atol 1e-3')
  lines.append(f'B1 jvp, Swimmer qM (B {knots}, n {m.nv}, {dirs} '
               f'directions: tangent at B {knots * dirs}, one launch): max '
               f'abs err {err:.3g}, 0 outside')
  spd_abs = err

  def newton_fn(kw):
    return lambda *x: newton.newton(*x, **kw)
  results = {}
  for label, n_args, gargs, kw, ndirs in (
      ('Swimmer', args, (), dict(cap=m.opt.iterations, tol=1e-5), dirs),
      ('Quadruped', *q_inputs, 4)):
    primals = list(n_args) + list(gargs)
    bsz = primals[1].shape[0]
    with record_batches() as rec:
      got, want = jvp_both(newton_fn(kw), primals,
                           tangent_directions(gen, primals, ndirs))
    check(('newton', bsz) in rec.calls and
          ('chol_solve', bsz * ndirs) in rec.calls,
          f'{label}: B2 and its tangent solve not launched at B {bsz} and '
          f'{bsz * ndirs}: {sorted(set(rec.calls))}')
    bad, err = tangent_bad(got, want, bsz)
    ex = expanded(n_args, gargs, kw.get('condims', ()), kw.get('dmasks', ()))
    c_got = newton_cost(ex, got[0][0])
    c_want = newton_cost(ex, want[0][0])
    gap = torch.abs(c_got - c_want) / torch.clamp(torch.abs(c_want), min=1.0)
    nbad, bad_gap = int(bad.sum()), float(torch.where(bad, gap, 0.0).max())
    newton_ok(f'{label} jvp', bsz, nbad, float(gap.max()), bad_gap)
    lines.append(f'B2 jvp, {label} step inputs (B {bsz}, nv '
                 f'{n_args[1].shape[1]}, ns {n_args[6].shape[1]}, condims '
                 f'{kw.get("condims", ())}, {ndirs} directions: tangent '
                 f'solve at B {bsz * ndirs}): max abs err {err:.3g}; '
                 + newton_line(nbad, bsz, float(gap.max()), bad_gap))
    results[label] = err
  for line in lines:
    print('phase 3i ' + line)
  return spd_abs, results['Swimmer']


def time_ilqg_kernels(gen, part, swim, kern):
  """Phase 4's iLQG rows: B1 at the line search (B 8) and at the
  derivative tangent (B (T - 1) D), B2 at the line search, for Particle
  and Swimmer, each against its plain version; timings into `kern`.
  Returns {path: (B1 line search, B1 tangent, B2) max abs errors}."""
  ilqg_err = {}
  for path, spec_ in (('particle_ilqg', part), ('swimmer_ilqg', swim)):
    dirs = 2 * spec_.model.nv + spec_.model.na + spec_.model.nu
    ls_spd, tangent, (n_args, n_gargs, n_kw) = ilqg_kernel_inputs(
        spec_, gen, ILQG_CANDIDATES, dirs)
    ls_times = time_spd(ls_spd, PLAIN_REPS)
    tan_times = time_spd(tangent, PLAIN_REPS)
    n_wall, n_dev, n_bound, iters = time_newton(n_args, n_gargs, n_kw,
                                                PLAIN_REPS)
    kern[path] = dict(wall={**ls_times[0], **n_wall},
                      dev={**ls_times[1], **n_dev}, spd_bound=ls_times[2],
                      newton_bound=n_bound,
                      tangent=dict(wall=tan_times[0], dev=tan_times[1],
                                   spd_bound=tan_times[2]))
    nbad, gap, n_abs, bad_gap = compare_newton(n_args, n_gargs, **n_kw)
    newton_ok(f'{path} line search', ILQG_CANDIDATES, nbad, gap, bad_gap,
              share=False)
    ilqg_err[path] = (check_spd_inputs(ls_spd, 1e-4, path)[0],
                      check_spd_inputs(tangent, 1e-4, path)[0], n_abs)
    print(f'phase 4 timing {path} per call, wall / device only: line '
          f'search ' + spd_timing_line(*ls_times, ls_spd[0])
          + '; derivative tangent ' + spd_timing_line(*tan_times, tangent[0])
          + '; ' + newton_timing_line(
              f'line search B {ILQG_CANDIDATES} nv {spec_.model.nv} ns '
              f'{n_args[6].shape[1]} cap {n_kw["cap"]}', n_wall, n_dev,
              n_bound, iters, PLAIN_REPS))
  return ilqg_err


def ilqg_launches(spec, t_steps):
  """(B1, B2) launches one iLQG iteration makes: the line search's T steps
  (B1 once for qacc_smooth and, with the Euler integrator, once for its
  damping system; B2 once), then the derivative pass: the transition's
  step at B T - 1 (each B1 system's primal and tangent, B2's primal and
  its tangent's B1 solve) and the cost's forward at B T (qacc_smooth's
  primal and tangent, B2's primal and its tangent's B1 solve)."""
  euler = int(spec.model.opt.integrator == 0)
  return (t_steps * (1 + euler) + 2 * (1 + euler) + 1 + 3, t_steps + 2)


class split_timer:
  """Wall time (synchronized) of the line search, the derivative pass and
  the backward pass inside ilqg.optimize, summed over the iterations run
  in the block; also the Derivatives the pass returned last."""

  def __enter__(self):
    import torch
    from mujoco_mpc_tpu_torch.planners import derivatives, ilqg
    self.saved = (ilqg._feedback_rollout, derivatives.compute,
                  ilqg._backward_with_escalation)
    self.total = {'line search': 0.0, 'derivatives': 0.0, 'riccati': 0.0}
    self.derivs = None

    def timed(name, fn, keep=False):
      def run(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        self.total[name] += time.perf_counter() - t0
        if keep:
          self.derivs = out
        return out
      return run
    ilqg._feedback_rollout = timed('line search', self.saved[0])
    derivatives.compute = timed('derivatives', self.saved[1], keep=True)
    ilqg._backward_with_escalation = timed('riccati', self.saved[2])
    return self

  def __exit__(self, *exc):
    from mujoco_mpc_tpu_torch.planners import derivatives, ilqg
    (ilqg._feedback_rollout, derivatives.compute,
     ilqg._backward_with_escalation) = self.saved


def ilqg_main_path(spec, iters, candidates):
  """make_planner(spec, ILQG, candidates, T, 10) from the task's start
  (bench.py's particle_ilqg / swimmer_ilqg): one warm-up iteration, then
  `iters` timed ones with the kernels' counts set to 0 just before and
  read just after, their wall split (each stage synchronized) and the
  kernels' batches recorded, then one profiled iteration."""
  import torch
  from mujoco_mpc_tpu_torch import agent
  from mujoco_mpc_tpu_torch.ops import newton, spd_solve
  from mujoco_mpc_tpu_torch.physics.model import make_data
  from mujoco_mpc_tpu_torch.planners import derivatives, ilqg
  from mujoco_mpc_tpu_torch.planners import registry as planners
  m = spec.model
  t_steps = agent.horizon_steps(spec)
  plan = planners.make_planner(spec, planners.ILQG, candidates, t_steps,
                               SPLINE_POINTS)
  d0, params = make_data(m), spec.default_params
  state, info = plan.optimize(plan.init(), d0, params)      # warm-up
  # the golden's state: the first iteration's, whose improvement the next
  # line search applies (later on, with the plan converged, the
  # candidates' returns differ by f32 rounding and the winning scale is
  # a tie)
  first = state
  torch.cuda.synchronize()
  spd_solve.solve_spd.launches = 0
  newton.newton.launches = 0
  reads0 = ilqg.host_reads
  lat, infos = [], []
  with split_timer() as split, record_batches() as rec:
    for _ in range(iters):
      t0 = time.perf_counter()
      state, info = plan.optimize(state, d0, params)
      torch.cuda.synchronize()
      lat.append(time.perf_counter() - t0)
      infos.append(info)
  launches = {'chol_solve': spd_solve.solve_spd.launches,
              'newton': newton.newton.launches}
  reads = ilqg.host_reads - reads0
  want_b1, want_b2 = ilqg_launches(spec, t_steps)
  check(launches['chol_solve'] == iters * want_b1,
        f'chol_solve launched {launches["chol_solve"]} times in {iters} '
        f'iterations, expected {iters * want_b1}')
  check(launches['newton'] == iters * want_b2,
        f'newton launched {launches["newton"]} times in {iters} iterations, '
        f'expected {iters * want_b2}')
  ok = torch.stack([i['backward_pass_ok'] for i in infos]).cpu()
  check(bool(ok.all()), f'backward pass failed: {ok}')
  best = torch.stack([i['best_return'] for i in infos]).cpu()
  nominal = torch.stack([i['nominal_return'] for i in infos]).cpu()
  check(bool(torch.isfinite(best).all()), f'best_return not finite: {best}')
  check(bool((best <= nominal).all()), 'best_return > nominal_return')
  dirs = derivatives.ndx(m) + m.nu
  tangent = ('chol_solve', (t_steps - 1) * dirs)
  check(tangent in rec.calls, f'B1 not launched at B (T-1) D = '
        f'{tangent[1]} in the derivative pass: {sorted(set(rec.calls))}')
  check(('chol_solve', candidates) in rec.calls
        and ('newton', candidates) in rec.calls,
        'B1 and B2 not launched at the line search\'s batch')
  t0 = time.perf_counter()
  dev_us, ops, top = device_us(lambda: plan.optimize(state, d0, params),
                               reps=1, top=8, warm=False, host=False)
  profile_s = time.perf_counter() - t0
  return dict(t_steps=t_steps, p50=statistics.median(lat), lat=lat,
              launches=launches, per_iter=(want_b1, want_b2), reads=reads,
              best=float(best[-1]), nominal=float(nominal[-1]),
              split={k: v / iters for k, v in split.total.items()},
              batches=sorted(set(rec.calls)), dev_us=dev_us, ops=ops,
              top=top, first=first, dirs=dirs, profile_s=profile_s,
              tangent_per_iter=rec.calls.count(tangent) // iters)


def print_ilqg_path(phase, name, candidates, iters, r):
  split = ', '.join(f'{k} {v * 1e3:.1f} ms' for k, v in r['split'].items())
  print(f'phase {phase} main path: {name} iLQG {candidates} candidates x '
        f'{r["t_steps"]} steps, {iters} iterations: p50 '
        f'{r["p50"] * 1e3:.2f} ms, {1.0 / r["p50"]:.3f} plans/s (min '
        f'{min(r["lat"]) * 1e3:.2f}, max {max(r["lat"]) * 1e3:.2f} ms); '
        f'wall split per iteration (each stage synchronized): {split}; '
        f'launches per iteration chol_solve '
        f'{r["launches"]["chol_solve"] // iters}, newton '
        f'{r["launches"]["newton"] // iters}; escalation host reads '
        f'{r["reads"]} in {iters} iterations; backward_pass_ok every '
        f'iteration; best_return {r["best"]:.5g} <= nominal '
        f'{r["nominal"]:.5g}')
  print(f'phase {phase} kernel batches (kernel, B): {r["batches"]}; '
        f'derivative directions D = {r["dirs"]}')
  print(f'phase {phase} profiled iteration (device trace only, '
        f'{r["profile_s"]:.1f} s): {r["ops"]} device ops, device busy '
        f'{r["dev_us"] / 1e3:.2f} ms = '
        f'{r["dev_us"] / 1e4 / r["p50"]:.1f}% of p50; by op (name: count, '
        f'ms): ' + '; '.join(f'{n[:48]}: {c}, {us / 1e3:.2f}'
                             for n, c, us in r['top']))


def to_device(state, device):
  """A planner state (a dataclass of tensors, such as ilqg.ILQGState), a
  tuple of them or a tensor, every tensor moved to `device`."""
  import dataclasses
  import torch

  def move(x):
    if torch.is_tensor(x):
      return x.to(device)
    if dataclasses.is_dataclass(x):
      return type(x)(**{f.name: move(getattr(x, f.name))
                        for f in dataclasses.fields(x)})
    if isinstance(x, tuple):
      return tuple(move(t) for t in x)
    return x
  return move(state)


def ilqg_golden(spec, cpu_spec, state, candidates):
  """One pipelined iteration from `state` (the main path's first
  iteration's) and the task's start on the card and on the CPU plain
  path: (A and B per-knot relative errors (median, max), best_return
  card, CPU, rel err, winning scale card, CPU)."""
  import torch
  from mujoco_mpc_tpu_torch import agent
  from mujoco_mpc_tpu_torch.physics.model import make_data
  from mujoco_mpc_tpu_torch.planners import ilqg
  t_steps = agent.horizon_steps(spec)
  out = []
  for sp, st in ((spec, state), (cpu_spec, to_device(state, 'cpu'))):
    with split_timer() as split:
      _, info = ilqg.optimize(sp, st, make_data(sp.model),
                              sp.default_params, ilqg.default_config(sp),
                              candidates, t_steps)
    out.append((split.derivs, info))
  (dg, ig), (dc, ic) = out
  rel = {}
  for k in ('a', 'b'):
    g, c = getattr(dg, k).cpu(), getattr(dc, k)
    per_knot = (torch.abs(g - c).amax((1, 2))
                / torch.clamp(torch.abs(c).amax((1, 2)), min=1e-6))
    rel[k] = (float(per_knot.median()), float(per_knot.max()))
  br_g, br_c = float(ig['best_return']), float(ic['best_return'])
  br_rel = abs(br_g - br_c) / max(abs(br_c), 1e-9)
  s_g, s_c = float(ig['action_step']), float(ic['action_step'])
  check(max(rel['a'][1], rel['b'][1]) <= 1e-3,
        f'golden A/B per-knot relative error {rel} > 1e-3')
  check(br_rel <= 0.02, f'golden best_return rel err {br_rel:.3g} > 0.02')
  check(s_g == s_c, f'golden winning scale card {s_g} vs CPU {s_c}')
  return rel, br_g, br_c, br_rel, s_g, s_c


def print_ilqg_golden(phase, name, g):
  rel, br_g, br_c, br_rel, s_g, s_c = g
  print(f'phase {phase} golden: {name} iLQG iteration card vs CPU plain '
        f'path from the same state and policy: A per-knot rel err median '
        f'{rel["a"][0]:.3g} max {rel["a"][1]:.3g}, B median {rel["b"][0]:.3g}'
        f' max {rel["b"][1]:.3g} (tol 1e-3); best_return card {br_g:.6g} vs '
        f'CPU {br_c:.6g}: rel err {br_rel:.3g} (tol 0.02); winning scale '
        f'card {s_g:.4g} vs CPU {s_c:.4g}')


def ilqg_kernel_inputs(spec, gen, candidates, dirs):
  """The kernels' inputs at an iLQG path's shapes, from states around the
  task's start: (B1 at the line search (B candidates), B1's tangent (the
  T - 1 knots' qM, each shared by D right-hand sides), B2 at the line
  search (args, gargs, kw))."""
  import torch
  from mujoco_mpc_tpu_torch import agent
  from mujoco_mpc_tpu_torch.physics.model import make_data
  m = spec.model

  def states(bsz):
    return make_data(m, bsz).replace(
        qpos=m.qpos0 + 0.1 * torch.randn((bsz, m.nq), generator=gen,
                                         device=DEV),
        qvel=torch.randn((bsz, m.nv), generator=gen, device=DEV),
        ctrl=torch.rand((bsz, m.nu), generator=gen, device=DEV) * 2 - 1)
  ls_spd, (args, gargs, _, _) = solver_inputs(spec, states(candidates))
  knots = agent.horizon_steps(spec) - 1
  (qm, _), _ = solver_inputs(spec, states(knots))
  tangent = (qm.repeat(dirs, 1, 1).contiguous(),
             torch.randn((knots * dirs, m.nv), generator=gen, device=DEV))
  return ls_spd, tangent, (args, gargs,
                           dict(cap=m.opt.iterations, tol=1e-5))


# ---------------------------------------------------------------------------
# The other planners (phases 21-24): Cross Entropy, Sample Gradient,
# Gradient and iLQS on Cartpole, their goldens, Robust Sampling on
# Quadruped Flat, and testspeed for all seven ids
# ---------------------------------------------------------------------------


def rollout_launches(spec, t_steps):
  """(B1, B2) launches one batched rollout of t_steps makes: B1 for
  qacc_smooth and, with the Euler integrator, for its damping system; B2
  once a step."""
  euler = int(spec.model.opt.integrator == 0)
  return t_steps * (1 + euler), t_steps


def planner_launches(spec, planner_id, t_steps, ilqg_ran=False):
  """(B1, B2) launches one iteration of a planner makes: its rollouts (the
  Robust re-rollouts, Gradient's and iLQS's nominal rollout at B 1) and,
  for Gradient and for iLQS when its iLQG branch runs, the derivative
  pass (ilqg_launches less the line search)."""
  from mujoco_mpc_tpu_torch.planners import registry as planners
  r = rollout_launches(spec, t_steps)
  deriv = tuple(a - b for a, b in zip(ilqg_launches(spec, t_steps), r))

  def add(*xs):
    return tuple(sum(x) for x in zip(*xs))
  if planner_id in (planners.CEM, planners.SAMPLE_GRADIENT):
    return r
  if planner_id == planners.ROBUST:
    return add(r, r)
  if planner_id == planners.GRADIENT:
    return add(r, deriv, r)
  if planner_id == planners.ILQS:
    return add(r, r, *((r, deriv, r) if ilqg_ran else ()))
  raise ValueError(planner_id)


def timed_iterations(optimize, state, iters, gen):
  """A warm-up iteration, then `iters` timed ones with the kernels' counts
  set to 0 just before and read just after and the dispatches recorded:
  (state, wall seconds, infos, launches, recorded (kernel, B) calls, iLQS
  host reads, the replay: the state and `gen`'s state the first timed
  iteration started from)."""
  import torch
  from mujoco_mpc_tpu_torch.ops import newton, spd_solve
  from mujoco_mpc_tpu_torch.planners import ilqs
  state, _ = optimize(state)
  torch.cuda.synchronize()
  replay = (state, gen.get_state())
  spd_solve.solve_spd.launches = 0
  newton.newton.launches = 0
  reads0 = ilqs.host_reads
  lat, infos = [], []
  with record_batches() as rec:
    for _ in range(iters):
      t0 = time.perf_counter()
      state, info = optimize(state)
      torch.cuda.synchronize()
      lat.append(time.perf_counter() - t0)
      infos.append(info)
  launches = {'chol_solve': spd_solve.solve_spd.launches,
              'newton': newton.newton.launches}
  return (state, lat, infos, launches, rec.calls,
          ilqs.host_reads - reads0, replay)


def planner_path(spec, planner_id, d0, samples, iters, gen, forced=False):
  """make_planner(spec, id, samples, T, 10) from d0: timed_iterations,
  the launches checked against planner_launches, best_return finite and
  (where the planner reports a nominal) <= nominal_return, the derivative
  tangent's batch, then the first timed iteration replayed under the
  profiler (device trace only), its busy share taken against that
  iteration's wall time. forced=True runs iLQS with exploration 0, so
  that no candidate beats the nominal and its iLQG branch runs every
  iteration; it is timed only (a profile of its ~390,000 launches took
  80 s)."""
  import dataclasses
  import torch
  from mujoco_mpc_tpu_torch import agent
  from mujoco_mpc_tpu_torch.ops import spline
  from mujoco_mpc_tpu_torch.planners import derivatives, ilqg, ilqs
  from mujoco_mpc_tpu_torch.planners import registry as planners
  from mujoco_mpc_tpu_torch.planners import sampling
  m = spec.model
  t_steps = agent.horizon_steps(spec)
  params = spec.default_params
  plan = planners.make_planner(spec, planner_id, samples, t_steps,
                               SPLINE_POINTS)
  if forced:
    scfg = dataclasses.replace(sampling.default_config(spec),
                               noise_std=torch.zeros((), device=DEV))
    icfg = ilqg.default_config(spec)

    def optimize(state):
      noise = sampling.sample_noise(spec, SPLINE_POINTS, samples, scfg, gen)
      return ilqs.optimize(spec, state, d0, params, scfg, icfg, noise,
                           max(samples // 4, 4), t_steps,
                           int(spline.Interp.ZERO))
  else:
    def optimize(state):
      return plan.optimize(state, d0, params, gen)
  state, lat, infos, launches, calls, reads, replay = timed_iterations(
      optimize, plan.init(), iters, gen)
  ilqg_runs = (sum(not bool(i['sampling_improved']) for i in infos)
               if planner_id == planners.ILQS else 0)
  want = [0, 0]
  for i in infos:
    ran = planner_id == planners.ILQS and not bool(i['sampling_improved'])
    for k, n in enumerate(planner_launches(spec, planner_id, t_steps, ran)):
      want[k] += n
  check(launches['chol_solve'] == want[0] and launches['newton'] == want[1],
        f'{planners.PLANNER_NAMES[planner_id]}: launches {launches} in '
        f'{iters} iterations, expected chol_solve {want[0]}, newton '
        f'{want[1]}')
  best = torch.stack([i['best_return'] for i in infos]).cpu()
  check(bool(torch.isfinite(best).all()), f'best_return not finite: {best}')
  if planner_id == planners.ROBUST:
    # the winner's score, at least the delegate's best score
    nominal = torch.stack([i['nominal_return'] for i in infos]).cpu()
    check(bool((nominal <= best).all()), 'Robust: best_return below the '
          'delegate\'s best score')
    check(all(bool(torch.isfinite(i['best_robust_score'])) for i in infos),
          'Robust: best_robust_score not finite')
  elif 'nominal_return' in infos[0]:
    nominal = torch.stack([i['nominal_return'] for i in infos]).cpu()
    check(bool((best <= nominal).all()), 'best_return > nominal_return')
  else:
    nominal = None
  if planner_id == planners.ILQS:
    check(reads == iters, f'iLQS host reads {reads}, expected {iters}')
  dirs = derivatives.ndx(m) + m.nu
  tangent = ('chol_solve', (t_steps - 1) * dirs)
  tangents = calls.count(tangent)
  if planner_id == planners.GRADIENT or ilqg_runs:
    check(tangents, f'B1 not launched at B (T-1) D = {tangent[1]} in the '
          f'derivative pass: {sorted(set(calls))}')
  prof = None
  if not forced:
    # the first timed iteration again, from its state and its generator
    # state: the same noise, the same branch, the same work
    start, gen_state = replay
    gen.set_state(gen_state)
    seen = {}
    t0 = time.perf_counter()
    dev_us, ops, top = device_us(
        lambda: seen.update(info=optimize(start)[1]), reps=1, top=8,
        warm=False, host=False)
    got, want = (float(seen['info']['best_return']),
                 float(infos[0]['best_return']))
    check(abs(got - want) <= 1e-4 * abs(want) and seen['info'].get(
        'sampling_improved') == infos[0].get('sampling_improved'),
          f'the profiled replay of the first timed iteration returned '
          f'{got}, the iteration {want}')
    prof = dict(dev_us=dev_us, ops=ops, top=top, wall=lat[0],
                seconds=time.perf_counter() - t0)
  return dict(t_steps=t_steps, p50=statistics.median(lat), lat=lat,
              launches=launches, iters=iters, reads=reads,
              ilqg_runs=ilqg_runs, best=float(best[-1]),
              nominal=None if nominal is None else float(nominal[-1]),
              batches=sorted(set(calls)), tangents=tangents, dirs=dirs,
              prof=prof)


def print_planner_path(phase, name, samples, r):
  iters = r['iters']
  nominal = ('' if r['nominal'] is None else
             f' (the delegate\'s best score {r["nominal"]:.5g})'
             if 'Robust' in name else
             f' (nominal_return {r["nominal"]:.5g})')
  print(f'phase {phase} main path: {name} {samples} candidates x '
        f'{r["t_steps"]} steps, {iters} iterations: p50 '
        f'{r["p50"] * 1e3:.2f} ms, {1.0 / r["p50"]:.3f} plans/s (min '
        f'{min(r["lat"]) * 1e3:.2f}, max {max(r["lat"]) * 1e3:.2f} ms); '
        f'launches per iteration chol_solve '
        f'{r["launches"]["chol_solve"] / iters:g}, newton '
        f'{r["launches"]["newton"] / iters:g}; B1 at the derivative '
        f'tangent\'s B (T - 1) D = {(r["t_steps"] - 1) * r["dirs"]}: '
        f'{r["tangents"] / iters:g} per iteration; host reads {r["reads"]}, '
        f'iLQG branch run {r["ilqg_runs"]} times; best_return '
        f'{r["best"]:.5g}{nominal}')
  print(f'phase {phase} {name} kernel batches (kernel, B): {r["batches"]}')
  p = r['prof']
  if p:
    print(f'phase {phase} {name} profiled iteration (the first timed one '
          f'replayed, device trace only, {p["seconds"]:.1f} s): {p["ops"]} '
          f'device ops, device busy {p["dev_us"] / 1e3:.2f} ms = '
          f'{p["dev_us"] / 1e4 / p["wall"]:.1f}% of its '
          f'{p["wall"] * 1e3:.2f} ms; by op (name: count, ms): '
          + '; '.join(f'{n[:48]}: {c}, {us / 1e3:.2f}'
                      for n, c, us in p['top']))


def planner_golden(spec, cpu_spec, planner_id, d0, d0_cpu, samples):
  """One iteration at `samples` candidates on the card and on the CPU
  plain path, from the same state and the default plan, with the same
  noise (drawn on the CPU, moved to the card). iLQS runs with
  exploration 0, so that its iLQG branch and derivative pass run. Returns
  (best_return card, CPU, rel err, the card winner's CPU return, the CPU
  best, the derivative pass's A and B per-knot relative errors or None)."""
  import dataclasses
  import torch
  from mujoco_mpc_tpu_torch import agent
  from mujoco_mpc_tpu_torch.ops import spline
  from mujoco_mpc_tpu_torch.planners import (cross_entropy,
                                             gradient_planner, ilqg, ilqs,
                                             ranked, robust, sample_gradient,
                                             sampling)
  from mujoco_mpc_tpu_torch.planners import registry as planners
  t_steps, interp = agent.horizon_steps(spec), int(spline.Interp.ZERO)
  p = SPLINE_POINTS
  cpu_gen = torch.Generator().manual_seed(2200 + planner_id)
  ng = planners.num_gradient_candidates(samples)
  ncand = min(robust.DEFAULT_NCANDIDATES, samples)

  def run(sp, d, noise):
    params = sp.default_params
    if planner_id == planners.CEM:
      cfg = cross_entropy.default_config(sp)
      return cross_entropy.optimize(
          sp, cross_entropy.default_state(sp, p, cfg), d, params, cfg,
          noise, max(samples // 10, 2), t_steps, interp)
    if planner_id == planners.SAMPLE_GRADIENT:
      return sample_gradient.optimize(
          sp, sample_gradient.default_state(sp, p), d, params,
          sample_gradient.default_config(sp), noise, samples, ng, t_steps,
          interp)
    if planner_id == planners.GRADIENT:
      return gradient_planner.optimize(
          sp, sampling.default_policy(sp, p), d, params,
          gradient_planner.default_config(sp), samples, t_steps, interp)
    if planner_id == planners.ILQS:
      return ilqs.optimize(
          sp, ilqs.default_state(sp, p, t_steps), d, params, quiet(sp),
          ilqg.default_config(sp), noise, max(samples // 4, 4), t_steps,
          interp)
    return robust.optimize_ranked(
        sp, delegate(sp), sampling.default_policy(sp, p), d, params,
        robust.default_config(sp), noise, ncand, robust.DEFAULT_NREPETITIONS,
        t_steps, interp)

  def quiet(sp):
    return dataclasses.replace(sampling.default_config(sp),
                               noise_std=torch.zeros((),
                                                     device=sp.model.device))

  def delegate(sp):
    return ranked.make_sampling_delegate(sp, sampling.default_config(sp),
                                         samples, p, t_steps, interp)

  if planner_id == planners.CEM:
    noise = cross_entropy.sample_noise(cpu_spec, p, samples, cpu_gen)
  elif planner_id == planners.SAMPLE_GRADIENT:
    noise = sample_gradient.sample_noise(cpu_spec, p, samples, ng, cpu_gen)
  elif planner_id == planners.ILQS:
    noise = sampling.sample_noise(cpu_spec, p, samples, quiet(cpu_spec),
                                  cpu_gen)
  elif planner_id == planners.ROBUST:
    noise = robust.sample_noise(cpu_spec, delegate(cpu_spec), ncand,
                                robust.DEFAULT_NREPETITIONS, t_steps,
                                cpu_gen)
  else:
    noise = None
  out = []
  for sp, d, nz in ((spec, d0, to_device(noise, DEV)),
                    (cpu_spec, d0_cpu, noise)):
    with split_timer() as split:
      state, info = run(sp, d, nz)
    out.append((state, info, split.derivs))
  (st_g, ig, dg), (_, ic, dc) = out
  br_g, br_c = float(ig['best_return']), float(ic['best_return'])
  rel = abs(br_g - br_c) / max(abs(br_c), 1e-9)

  # the card's winner, returned on the CPU
  if 'returns' in ic:
    win = int(torch.argmin(ig['returns']) if 'winner' not in ig
              else ig['winner'])
    win_cpu = float(ic['returns'][win])
  else:
    cfg = sampling.default_config(cpu_spec)
    cpu_state = to_device(st_g, 'cpu')
    if planner_id == planners.ILQS and int(cpu_state.active) == \
       ilqs.ACTIVE_ILQG:
      zero = torch.zeros(1, dtype=cpu_spec.model.dtype)
      win_cpu = float(ilqg._feedback_rollout(
          cpu_spec, d0_cpu, cpu_state.ilqg_state.policy, zero,
          cpu_spec.default_params, t_steps, index_by_time=True)[0][0])
    else:
      pol = (cpu_state.sampling_policy if planner_id == planners.ILQS
             else cpu_state)
      win_cpu = float(sampling.rollout_candidates(
          cpu_spec, d0_cpu, pol.times, pol.values[None],
          cpu_spec.default_params, t_steps, cfg, interp)[0])
  check(rel <= 0.02, f'{planners.PLANNER_NAMES[planner_id]} golden '
        f'best_return rel err {rel:.3g} > 0.02')
  check(win_cpu <= br_c * 1.02 + 1e-9, f'{planners.PLANNER_NAMES[planner_id]}'
        f' golden: the card\'s winner returns {win_cpu:.6g} on the CPU, '
        f'more than 2% over the CPU best {br_c:.6g}')
  ab = None
  if dg is not None:
    ab = {}
    for k in ('a', 'b'):
      g, c = getattr(dg, k).cpu(), getattr(dc, k)
      per_knot = (torch.abs(g - c).amax((1, 2))
                  / torch.clamp(torch.abs(c).amax((1, 2)), min=1e-6))
      ab[k] = (float(per_knot.median()), float(per_knot.max()))
    check(max(ab['a'][1], ab['b'][1]) <= 1e-3, f'golden A/B per-knot '
          f'relative error {ab} > 1e-3')
  return br_g, br_c, rel, win_cpu, ab


def print_planner_golden(name, task, samples, g):
  br_g, br_c, rel, win_cpu, ab = g
  extra = ('' if ab is None else
           f'; derivative pass A per-knot rel err median {ab["a"][0]:.3g} '
           f'max {ab["a"][1]:.3g}, B median {ab["b"][0]:.3g} max '
           f'{ab["b"][1]:.3g} (tol 1e-3)')
  print(f'phase 22 golden: {name} on {task}, one {samples}-candidate '
        f'iteration, card vs CPU plain path with the same noise: '
        f'best_return card {br_g:.6g} vs CPU {br_c:.6g}: rel err {rel:.3g} '
        f'(tol 0.02); the card\'s winner returns {win_cpu:.6g} on the CPU '
        f'(tol 2% over the CPU best){extra}')


def path_kernels(label, spd_args, n_args, n_gargs, n_kw, spd_tol,
                 tangent=None, share=True):
  """B1 and B2 at a new path's shapes: each against its plain version
  (B1 within spd_tol relative; B2 by phase 3d's near-tie rule), timed
  with its bound, and B1 at the derivative tangent's shape if given.
  Returns (timings as phase 4 keeps them, (B1, B2, B1 tangent) max abs
  errors)."""
  spd_abs = check_spd_inputs(spd_args, spd_tol, label)[0]
  nbad, gap, n_abs, bad_gap = compare_newton(n_args, n_gargs, **n_kw)
  newton_ok(f'{label} inputs', n_args[1].shape[0], nbad, gap, bad_gap, share)
  spd_times = time_spd(spd_args, PLAIN_REPS)
  n_wall, n_dev, n_bound, iters = time_newton(n_args, n_gargs, n_kw,
                                              PLAIN_REPS)
  k = dict(wall={**spd_times[0], **n_wall}, dev={**spd_times[1], **n_dev},
           spd_bound=spd_times[2], newton_bound=n_bound)
  line = (f'phase {label} timing per call, wall / device only: '
          + spd_timing_line(*spd_times, spd_args[0]) + '; '
          + newton_timing_line(
              f'B {n_args[1].shape[0]} nv {n_args[1].shape[1]} ns '
              f'{n_args[6].shape[1]}'
              + (f' condims {n_kw["condims"]}' if n_kw.get('condims') else '')
              + f' cap {n_kw["cap"]} ({nbad} samples outside rtol 2e-3, '
              f'max relative cost gap {gap:.3g})', n_wall, n_dev, n_bound,
              iters, PLAIN_REPS))
  t_abs = None
  if tangent is not None:
    t_abs = check_spd_inputs(tangent, spd_tol, label + ' tangent')[0]
    t_times = time_spd(tangent, PLAIN_REPS)
    k['tangent'] = dict(wall=t_times[0], dev=t_times[1],
                        spd_bound=t_times[2])
    line += '; derivative tangent ' + spd_timing_line(*t_times, tangent[0])
  print(line)
  return k, (spd_abs, n_abs, t_abs)


def batch_of(d, bsz):
  """bsz samples of batched Data d: its first bsz, taken in turn again if
  it has fewer."""
  import dataclasses
  import torch
  idx = torch.arange(bsz, device=d.qpos.device) % d.batch
  return d.replace(**{f.name: getattr(d, f.name)[idx]
                      for f in dataclasses.fields(d)
                      if getattr(d, f.name) is not None})


def planner_path_kernels(cart, quad, gen, kern, cart_errs):
  """Both kernels at the shapes phases 21 and 23 add, each against its
  plain version and timed with its bound (phase 4's method; run beside
  phase 4, before the plans' profiles: later in a process the profiler
  keeps fewer records of the hand kernels, in one run none): iLQS's iLQG
  line search on Cartpole (B K / 4 = 2048) with the derivative tangent
  (B (T - 1) D = 500, Gradient's too), and Robust's re-rollouts on
  Quadruped Flat (B 60, states under body wrenches). CEM's, Sample
  Gradient's and Gradient's line search run at phase 4's Cartpole
  shapes. Fills `kern` for the five paths; returns their (B1, B2, B1
  tangent) max abs errors, cart_errs being phase 3c's (B1, B2)."""
  import torch
  spd_abs, newton_abs = cart_errs
  m = cart.model
  ls_spd, c_tangent, (n_args, n_gargs, n_kw) = ilqg_kernel_inputs(
      cart, gen, PLANNER_SAMPLES // 4, 2 * m.nv + m.na + m.nu)
  kern['cartpole_ilqs'], ilqs_errs = path_kernels(
      '4 cartpole_ilqs (its iLQG line search)', ls_spd, n_args, n_gargs,
      n_kw, 1e-4, c_tangent, share=False)
  kern['cartpole_cem'] = kern['cartpole_sample_gradient'] = kern['cartpole']
  kern['cartpole_gradient'] = dict(kern['cartpole'],
                                   tangent=kern['cartpole_ilqs']['tangent'])
  states = batch_of(quadruped_states(quad, gen), ROBUST_REROLLOUTS).replace(
      xfrc_applied=0.5 * torch.randn(
          (ROBUST_REROLLOUTS, quad.model.nbody, 6), generator=gen,
          device=DEV))
  r_spd, (r_args, r_gargs, r_condims, r_dmasks) = solver_inputs(quad, states)
  kern['quadruped_robust'], robust_errs = path_kernels(
      f'4 quadruped_robust (the re-rollouts, B {ROBUST_REROLLOUTS}, body '
      f'wrenches)', r_spd, r_args, r_gargs,
      dict(cap=quad.model.opt.iterations, tol=1e-5, condims=r_condims,
           dmasks=r_dmasks), 1e-4)
  return {'cartpole_cem': (spd_abs, newton_abs, None),
          'cartpole_sample_gradient': (spd_abs, newton_abs, None),
          'cartpole_gradient': (spd_abs, newton_abs, ilqs_errs[2]),
          'cartpole_ilqs': ilqs_errs, 'quadruped_robust': robust_errs}


def planner_phases(cart, cart_cpu, d0, d0_cpu, quad, quad_cpu, q_d0,
                   q_d0_cpu, gen, elapsed):
  """Phases 21-24 from Cartpole's and Quadruped's specs (card and CPU)
  and start states. Returns (the paths' results, the goldens'
  best_return relative errors, the forced iLQS run's result)."""
  # 21. the other planners on Cartpole at the flagship's width, from
  # (1.0, 3.14159): make_planner(spec, id, 8192, 101, 10)
  from mujoco_mpc_tpu_torch import testspeed
  from mujoco_mpc_tpu_torch.planners import registry as planners
  plan_main = {}
  for pid, path in ((planners.CEM, 'cartpole_cem'),
                    (planners.SAMPLE_GRADIENT, 'cartpole_sample_gradient'),
                    (planners.GRADIENT, 'cartpole_gradient'),
                    (planners.ILQS, 'cartpole_ilqs')):
    r = planner_path(cart, pid, d0, PLANNER_SAMPLES, PLANNER_ITERS, gen)
    print_planner_path(21, planners.PLANNER_NAMES[pid], PLANNER_SAMPLES, r)
    plan_main[path] = r
  forced = planner_path(cart, planners.ILQS, d0, PLANNER_SAMPLES,
                        FORCED_ITERS, gen, forced=True)
  print_planner_path(21, 'iLQS with its iLQG branch forced (exploration '
                     '0)', PLANNER_SAMPLES, forced)
  elapsed('21')

  # 22. goldens: one 256-candidate iteration of each, card vs CPU plain
  # path with the same noise; Robust on Quadruped Flat, the task phase 23
  # times it on
  golden_rel = {}
  for pid, path, spec_, cpu_, dd, dd_cpu, task in (
      (planners.CEM, 'cartpole_cem', cart, cart_cpu, d0, d0_cpu, 'Cartpole'),
      (planners.SAMPLE_GRADIENT, 'cartpole_sample_gradient', cart, cart_cpu,
       d0, d0_cpu, 'Cartpole'),
      (planners.GRADIENT, 'cartpole_gradient', cart, cart_cpu, d0, d0_cpu,
       'Cartpole'),
      (planners.ILQS, 'cartpole_ilqs', cart, cart_cpu, d0, d0_cpu,
       'Cartpole, exploration 0 (its iLQG branch)'),
      (planners.ROBUST, 'quadruped_robust', quad, quad_cpu, q_d0, q_d0_cpu,
       'Quadruped Flat')):
    g = planner_golden(spec_, cpu_, pid, dd, dd_cpu, GOLDEN_SAMPLES)
    print_planner_golden(planners.PLANNER_NAMES[pid], task, GOLDEN_SAMPLES,
                         g)
    golden_rel[path] = g[2]

  elapsed('22')

  # 23. Robust Sampling on Quadruped Flat from `home`: the reference's
  # instantiation (over Sampling, 12 candidates x 5 repetitions) at
  # bench.py's quadruped_ps4096 width
  r = planner_path(quad, planners.ROBUST, q_d0, ROBUST_SAMPLES, ROBUST_ITERS,
                   gen)
  check(('newton', ROBUST_REROLLOUTS) in r['batches']
        and ('newton', ROBUST_SAMPLES + 1) in r['batches'],
        f'Robust: B2 not launched at B {ROBUST_SAMPLES + 1} and '
        f'{ROBUST_REROLLOUTS}: {r["batches"]}')
  print_planner_path(23, 'Quadruped Flat Robust Sampling (12 x 5 over '
                     'Sampling)', ROBUST_SAMPLES, r)
  plan_main['quadruped_robust'] = r

  elapsed('23')

  # 24. testspeed for all seven planner ids on Cartpole
  for pid, name in enumerate(planners.PLANNER_NAMES):
    res = testspeed.synchronous_planning_cost(
        'Cartpole', pid, TESTSPEED_TIME, 4, TESTSPEED_SAMPLES, seed=pid,
        verbose=False, device=DEV)
    check(float('-inf') < res['avg_cost'] < float('inf'),
          f'testspeed {name}: avg_cost {res["avg_cost"]}')
    print(f'phase 24 testspeed: Cartpole {name} (id {pid}), '
          f'{TESTSPEED_SAMPLES} samples, {res["total_steps"]} steps '
          f'({TESTSPEED_TIME} s simulated), 4 steps a plan: wall '
          f'{res["wall_time_s"]:.3f} s, x_realtime {res["x_realtime"]:.4f}, '
          f'avg_cost {res["avg_cost"]:.5g}')

  elapsed('24')
  return plan_main, golden_rel, forced


def main():
  import torch
  if not torch.cuda.is_available():
    raise SystemExit('chip_smoke: torch.cuda.is_available() is False; '
                     'this script needs an NVIDIA GPU')
  sys.path.insert(0, ROOT)
  try:
    from mujoco_mpc_tpu_torch.ops import cuda_build
    from mujoco_mpc_tpu_torch.physics.model import make_data
    from mujoco_mpc_tpu_torch.tasks import registry
  except ImportError as e:
    raise SystemExit(f'chip_smoke: run it from a checkout of the repository'
                     f' ({e})') from e
  # references in full float32 (TF32 would keep ~3 digits)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False

  start = time.perf_counter()

  def elapsed(phases):
    print(f'elapsed after phases {phases}: '
          f'{time.perf_counter() - start:.1f} s')

  # 1. device
  print('phase 1 device:', torch.cuda.get_device_name(0),
        f'(torch {torch.__version__}, CUDA {torch.version.cuda}), nvidia-smi:')
  print(smi_line())

  # 2. build, both sources at once (nvcc is one process per file)
  t0 = time.perf_counter()
  kernels = ('chol_solve', 'newton')
  with concurrent.futures.ThreadPoolExecutor(len(kernels)) as pool:
    libs = dict(zip(kernels, pool.map(cuda_build.build, kernels)))
  for name in kernels:
    cuda_build.load(name)
  print(f'phase 2 build: chol_solve.cu + newton.cu with nvcc for sm_90a in '
        f'{time.perf_counter() - t0:.1f} s')
  for name in kernels:
    lines, spilled = ptxas_lines(name, libs[name])
    for line in lines:
      print('phase 2 ' + line)
    check(spilled == 0, f'{name}: an instance spills ({spilled} bytes of '
          f'spill stores and loads in all)')

  # 3. kernels vs plain versions, float32 on the card
  gen = torch.Generator(device=DEV).manual_seed(0)
  check_spd_random(gen)

  check_newton_random(gen)

  cart = registry.get_task('Cartpole', device=DEV)
  spd_in, (newton_in, _, _, _) = solver_inputs(cart, cartpole_states(cart,
                                                                     gen))
  spd_abs, spd_err = check_spd_inputs(spd_in, 1e-5, 'Cartpole')
  cart_cap = cart.model.opt.iterations
  newton_abs, newton_err, cart_active = check_newton_cartpole(newton_in,
                                                              cart_cap)
  print(f'phase 3c Cartpole step inputs (B {CART_SAMPLES}, '
        f'{cart_active} active limit rows): chol_solve rel err '
        f'{spd_err:.3g} (tol 1e-5), newton rel err {newton_err:.3g} '
        f'(tol 1e-4)')

  check_newton_groups(gen)

  quad = registry.get_task('Quadruped Flat')     # the default device: cuda
  check(quad.model.device.type == torch.device(DEV).type,
        'Quadruped Flat not on the card')
  quad_cap = quad.model.opt.iterations
  q_spd_in, (q_args, q_gargs, q_condims, q_dmasks) = solver_inputs(
      quad, quadruped_states(quad, gen))
  q_spd_abs, q_spd_err = check_spd_inputs(q_spd_in, 1e-4, 'Quadruped')
  q_kw = dict(cap=quad_cap, tol=1e-5, condims=q_condims, dmasks=q_dmasks)
  q_newton_abs, q_line = check_newton_task('Quadruped', q_args, q_gargs,
                                          q_kw)
  print(f'phase 3e Quadruped step inputs (B {QUAD_SAMPLES}, condims '
        f'{q_condims}, P {q_gargs[1].shape[1]}): chol_solve n 18 rel err '
        f'{q_spd_err:.3g} (tol 1e-4); {q_line}')

  hum = registry.get_task('Humanoid Track')
  hum_cap = hum.model.opt.iterations
  for deep in (False, True):
    h_states = humanoid_states(hum, gen, deep)
    s_in, (args, gargs, condims, dmasks) = solver_inputs(hum, h_states)
    spd_abs_, spd_err_ = check_spd_inputs(s_in, 1e-4, 'Humanoid')
    _, euler_err = check_spd_inputs(euler_inputs(hum, h_states), 1e-4,
                                    'Humanoid Euler')
    kw = dict(cap=hum_cap, tol=1e-5, condims=condims, dmasks=dmasks)
    newton_abs_, line = check_newton_task('Humanoid', args, gargs, kw,
                                          share=not deep)
    print(f'phase 3f Humanoid Track step inputs, '
          f'{"deep contact" if deep else "task-shaped"} (B {HUMAN_SAMPLES}, '
          f'condims {condims}, P {gargs[1].shape[1]}, ns {args[6].shape[1]}'
          f'): chol_solve n {hum.model.nv} rel err qM {spd_err_:.3g}, Euler '
          f'system {euler_err:.3g} (tol 1e-4); {line}')
    if not deep:    # the inputs phase 4 times and the JSON line reports
      h_spd_in, h_args, h_gargs, h_kw = s_in, args, gargs, kw
      h_spd_abs, h_newton_abs = spd_abs_, newton_abs_

  sha = registry.get_task('Shadow Reorient')
  sha_cpu = registry.get_task('Shadow Reorient', device='cpu')
  sha_cap = sha.model.opt.iterations
  for rollout in (True, False):
    states = shadow_states(sha, gen, rollout)
    spd_in_, (args, gargs, condims, dmasks) = solver_inputs(sha, states)
    spd_abs_, spd_err_ = check_spd_inputs(spd_in_, 1e-4, 'Shadow')
    _, euler_err = check_spd_inputs(euler_inputs(sha, states), 1e-4,
                                    'Shadow Euler')
    kw = dict(cap=sha_cap, tol=1e-5, condims=condims, dmasks=dmasks)
    newton_abs_, line = check_newton_task('Shadow', args, gargs, kw,
                                          share=rollout)
    s_shape = (f'nv {sha.model.nv} ns {args[6].shape[1]} one condim-3 '
               f'group P {gargs[1].shape[1]} cap {sha_cap}')
    label = (f'task-shaped ({SHADOW_ROLLOUT_STEPS} steps of rollouts from '
             f'qpos0)' if rollout else 'the cube 0-10 mm into the palm')
    print(f'phase 3g Shadow Reorient step inputs, {label} (B '
          f'{SHADOW_SAMPLES}, the first {SHADOW_QPOS0} at qpos0, condims '
          f'{condims}, {s_shape}): chol_solve n {sha.model.nv} rel err qM '
          f'{spd_err_:.3g}, Euler system {euler_err:.3g} (tol 1e-4); {line}')
    print(f'phase 3h Shadow Reorient contact points, {label}, card vs the '
          f'CPU plain path: ' + check_contact_points(sha, sha_cpu, states))
    if rollout:    # the inputs phase 4 times and the JSON line reports
      s_spd_in, s_args, s_gargs, s_kw = spd_in_, args, gargs, kw
      s_spd_abs, s_newton_abs = spd_abs_, newton_abs_

  swim = registry.get_task('Swimmer')
  part = registry.get_task('Particle')
  t_spd_abs, t_newton_abs = check_tangents(gen, swim,
                                           (q_args, q_gargs, q_kw))

  elapsed('1-3')

  # 4. timing at the four paths' shapes
  kern = {}
  for path, spd_args, n_args, n_gargs, n_kw, n_label, plain_reps in (
      ('cartpole', spd_in, newton_in, (), dict(cap=cart_cap, tol=1e-5),
       f'B {CART_SAMPLES} nv 2 ns 2 cap {cart_cap}', PLAIN_REPS),
      ('quadruped', q_spd_in, q_args, q_gargs, q_kw,
       f'B {QUAD_SAMPLES} nv 18 ns 24 one condim-3 group P 20 cap '
       f'{quad_cap}', PLAIN_REPS),
      ('humanoid_track', h_spd_in, h_args, h_gargs, h_kw,
       f'B {HUMAN_SAMPLES} nv {hum.model.nv} ns {h_args[6].shape[1]} one '
       f'condim-3 group P {h_gargs[1].shape[1]} cap {hum_cap}',
       HUMAN_PLAIN_REPS),
      ('shadow_reorient', s_spd_in, s_args, s_gargs, s_kw,
       f'B {SHADOW_SAMPLES} {s_shape}', SHADOW_PLAIN_REPS)):
    spd_times = time_spd(spd_args, plain_reps)
    n_wall, n_dev, n_bound, iters = time_newton(n_args, n_gargs, n_kw,
                                                plain_reps)
    kern[path] = dict(wall={**spd_times[0], **n_wall},
                      dev={**spd_times[1], **n_dev}, spd_bound=spd_times[2],
                      newton_bound=n_bound)
    print(f'phase 4 timing {path} per call, wall (median of {TIME_REPS}, '
          f'CUDA events) / device only (profiler): '
          + spd_timing_line(*spd_times, spd_args[0]) + '; '
          + newton_timing_line(n_label, n_wall, n_dev, n_bound, iters,
                               plain_reps))
  ilqg_err = time_ilqg_kernels(gen, part, swim, kern)
  plan_errs = planner_path_kernels(cart, quad, gen, kern,
                                   (spd_abs, newton_abs))
  for n in SPD_EXTRA_N:
    spd_args = random_spd(gen, QUAD_SAMPLES, n)
    print(f'phase 4 timing, random systems, per call, wall / device only: '
          + spd_timing_line(*time_spd(spd_args, SPD_EXTRA_PLAIN_REPS),
                            spd_args[0]))

  elapsed('4')

  # 5-7. Cartpole
  d0 = make_data(cart.model).replace(qpos=torch.tensor([CART_QPOS0],
                                                       device=DEV))
  cart_main = main_path(cart, d0, CART_SAMPLES, CART_PLANS, gen)
  print_main_path(5, 'Cartpole', CART_SAMPLES, CART_PLANS, cart_main)
  cart_cpu = registry.get_task('Cartpole', device='cpu')
  d0_cpu = make_data(cart_cpu.model).replace(
      qpos=torch.tensor([CART_QPOS0]))
  br_gpu, br_cpu, rel, win_gpu, win_cpu, drift = golden(
      cart, cart_cpu, d0, d0_cpu, gen, 0.5)
  print(f'phase 6 golden: Cartpole 256-candidate plan best_return card '
        f'{br_gpu:.6g} vs CPU plain {br_cpu:.6g}: rel err {rel:.3g} (tol '
        f'0.02); winner card {win_gpu} vs CPU {win_cpu} (match '
        f'{win_gpu == win_cpu}); 5-step rollout qpos drift {drift:.3g} '
        f'(tol 0.05)')
  steps, sim_t, wall, rtf, mean, last = plan_act(
      cart, d0, CART_SAMPLES,
      int(round(CART_PLAN_ACT_TIME / float(cart.model.opt.timestep))),
      1)
  print(f'phase 7 plan-act: Cartpole {steps} steps ({sim_t:.2f} s simulated,'
        f' 4 steps per plan, {CART_SAMPLES} candidates) in {wall:.2f} s wall:'
        f' real-time factor {rtf:.3f}; mean cost {mean:.4g}, last {last:.4g}')

  elapsed('5-7')

  # 8-10. Quadruped Flat
  home = quad.model.keyframe_qpos('home')[None]
  q_d0 = make_data(quad.model).replace(qpos=home)
  quad_main = main_path(quad, q_d0, QUAD_SAMPLES, QUAD_PLANS, gen)
  print_main_path(8, 'Quadruped Flat', QUAD_SAMPLES, QUAD_PLANS, quad_main)
  quad_cpu = registry.get_task('Quadruped Flat', device='cpu')
  q_d0_cpu = make_data(quad_cpu.model).replace(qpos=home.cpu())
  br_gpu, br_cpu, rel, win_gpu, win_cpu, drift = golden(
      quad, quad_cpu, q_d0, q_d0_cpu, gen, 0.2)
  print(f'phase 9 golden: Quadruped 256-candidate plan best_return card '
        f'{br_gpu:.6g} vs CPU plain {br_cpu:.6g}: rel err {rel:.3g} (tol '
        f'0.02); winner card {win_gpu} vs CPU {win_cpu} (match '
        f'{win_gpu == win_cpu}); 5-step rollout qpos drift {drift:.3g} '
        f'(tol 0.05)')
  samples = max(int(quad.config.get('sampling_trajectories', 128)), 128)
  steps, sim_t, wall, rtf, mean, last = plan_act(quad, q_d0, samples,
                                                 PLAN_ACT_STEPS, 2)
  print(f'phase 10 plan-act: Quadruped Flat {steps} steps ({sim_t:.2f} s '
        f'simulated, {steps // 4} plans of 4 steps, {samples} candidates, '
        f'transition '
        f'on) in {wall:.2f} s wall: real-time factor {rtf:.3f}; mean cost '
        f'{mean:.4g}, last {last:.4g}')

  elapsed('8-10')

  # 11-13. Humanoid Track
  h_d0 = make_data(hum.model).replace(
      qpos=hum.model.keyframe_qpos('home')[None])
  hum_main = main_path(hum, h_d0, HUMAN_SAMPLES, HUMAN_PLANS, gen)
  print_main_path(11, 'Humanoid Track', HUMAN_SAMPLES, HUMAN_PLANS, hum_main)
  hum_cpu = registry.get_task('Humanoid Track', device='cpu')
  h_d0_cpu = make_data(hum_cpu.model).replace(
      qpos=hum_cpu.model.keyframe_qpos('home')[None])
  # both plans run in float32, so a sample time on a clip frame boundary
  # floors to the same frame on the card and the CPU; the bounds absorb
  # what the kernels' rounding moves over 41 steps of contact
  br_gpu, br_cpu, rel, win_gpu, win_cpu, drift = golden(
      hum, hum_cpu, h_d0, h_d0_cpu, gen, 0.2)
  print(f'phase 12 golden: Humanoid Track 256-candidate plan best_return '
        f'card {br_gpu:.6g} vs CPU plain {br_cpu:.6g}: rel err {rel:.3g} '
        f'(tol 0.02); winner card {win_gpu} vs CPU {win_cpu} (match '
        f'{win_gpu == win_cpu}); 5-step rollout qpos drift {drift:.3g} '
        f'(tol 0.05)')
  samples = max(int(hum.config.get('sampling_trajectories', 128)), 128)
  steps, sim_t, wall, rtf, mean, last = plan_act(hum, h_d0, samples,
                                                 PLAN_ACT_STEPS, 3)
  print(f'phase 13 plan-act: Humanoid Track {steps} steps ({sim_t:.2f} s '
        f'simulated, {steps // 4} plans of 4 steps, {samples} candidates, '
        f'transition '
        f'on) in {wall:.2f} s wall: real-time factor {rtf:.3f}; mean cost '
        f'{mean:.4g}, last {last:.4g}')

  elapsed('11-13')

  # 14-16. Shadow Reorient, from qpos0 (bench.py's shadow_ps8192)
  s_d0 = make_data(sha.model)
  sha_main = main_path(sha, s_d0, SHADOW_SAMPLES, SHADOW_PLANS, gen)
  print_main_path(14, 'Shadow Reorient', SHADOW_SAMPLES, SHADOW_PLANS,
                  sha_main)
  br_gpu, br_cpu, rel, win_gpu, win_cpu, drift = golden(
      sha, sha_cpu, s_d0, make_data(sha_cpu.model), gen, 0.2)
  print(f'phase 15 golden: Shadow Reorient 256-candidate plan best_return '
        f'card {br_gpu:.6g} vs CPU plain {br_cpu:.6g}: rel err {rel:.3g} '
        f'(tol 0.02); winner card {win_gpu} vs CPU {win_cpu} (match '
        f'{win_gpu == win_cpu}); 5-step rollout qpos drift {drift:.3g} '
        f'(tol 0.05)')
  samples = max(int(sha.config.get('sampling_trajectories', 128)), 128)
  steps, sim_t, wall, rtf, mean, last = plan_act(sha, s_d0, samples,
                                                 PLAN_ACT_STEPS, 4)
  print(f'phase 16 plan-act: Shadow Reorient {steps} steps ({sim_t:.2f} s '
        f'simulated, {steps // 4} plans of 4 steps, {samples} candidates, '
        f'transition '
        f'on) in {wall:.2f} s wall: real-time factor {rtf:.3f}; mean cost '
        f'{mean:.4g}, last {last:.4g}')

  elapsed('14-16')

  # 17-20. iLQG with exact derivatives: Particle and Swimmer at bench.py's
  # make_planner(spec, ILQG, 8, T, 10)
  ilqg_main = {}
  for phase, name, spec_, iters in ((17, 'Particle', part, PARTICLE_ITERS),
                                    (19, 'Swimmer', swim, SWIMMER_ITERS)):
    r = ilqg_main_path(spec_, iters, ILQG_CANDIDATES)
    print_ilqg_path(phase, name, ILQG_CANDIDATES, iters, r)
    print_ilqg_golden(phase + 1, name, ilqg_golden(
        spec_, registry.get_task(name, device='cpu'), r['first'],
        ILQG_CANDIDATES))
    ilqg_main[name.lower() + '_ilqg'] = dict(
        launches=r['launches'], per_iter=r['per_iter'], iters=iters,
        tangent_per_iter=r['tangent_per_iter'])
    elapsed(f'{phase}-{phase + 1}')

  # 21-24. the other planners
  plan_main, golden_rel, forced = planner_phases(
      cart, cart_cpu, d0, d0_cpu, quad, quad_cpu, q_d0, q_d0_cpu, gen,
      elapsed)

  def entry(name, path, launches, err, k=None):
    k = k or kern[path]
    short = 'chol' if name == 'chol_solve' else 'newton'
    b_ms, b_by = k['spd_bound' if short == 'chol' else 'newton_bound']
    return {'launches': launches[name], 'max_abs_err': err,
            'ms': k['wall'][name], 'plain_ms': k['wall'][short + '_plain'],
            'device_ms': k['dev'][name] / 1e3, 'bound_ms': b_ms,
            'bound_by': b_by,
            'library_ms': (k['wall']['chol_library'] if short == 'chol'
                           else None)}

  def ilqg_entry(name, path):
    """An iLQG path's entry, at the line search's shapes, with launches
    per iteration; B1's carries its derivative tangent's shape (B (T - 1)
    D) under 'tangent', with the launches the recorded iterations made at
    that batch."""
    r, errs = ilqg_main[path], ilqg_err[path]
    per = dict(zip(('chol_solve', 'newton'), r['per_iter']))
    e = entry(name, path, r['launches'],
              errs[0] if name == 'chol_solve' else errs[2])
    e['launches_per_iteration'] = per[name]
    if name == 'chol_solve':
      k = kern[path]['tangent']
      per_t = r['tangent_per_iter']
      e['tangent'] = entry(name, path, {name: per_t * r['iters']}, errs[1],
                           dict(k, newton_bound=None))
      e['tangent']['launches_per_iteration'] = per_t
    return e

  def plan_entry(name, path):
    """A planner path's entry at its kernels' shapes (phase 21's and 23's
    timings), with launches per iteration and the phase 22 golden's
    best_return relative error; B1's carries the derivative tangent's
    shape under 'tangent' where the path has one, and iLQS's the forced
    iLQG branch's launches."""
    r, errs, k = plan_main[path], plan_errs[path], kern[path]
    e = entry(name, path, r['launches'],
              errs[0] if name == 'chol_solve' else errs[1], k)
    e['launches_per_iteration'] = r['launches'][name] / r['iters']
    e['golden_rel_err'] = golden_rel[path]
    if name == 'chol_solve' and 'tangent' in k:
      e['tangent'] = entry(name, path, {name: r['tangents']}, errs[2],
                           dict(k['tangent'], newton_bound=None))
      e['tangent']['launches_per_iteration'] = r['tangents'] / r['iters']
    if path == 'cartpole_ilqs':
      e['ilqg_branch'] = {
          'launches': forced['launches'][name], 'iterations': forced['iters'],
          'launches_per_iteration': forced['launches'][name]
          / forced['iters']}
    return e

  out = []
  for name, source, replaces, errs in (
      ('chol_solve', 'mujoco_mpc_tpu_torch/csrc/chol_solve.cu',
       'mujoco_mpc_tpu/ops/pallas_linalg.py:90',
       {'cartpole': spd_abs, 'quadruped': q_spd_abs,
        'humanoid_track': h_spd_abs, 'shadow_reorient': s_spd_abs}),
      ('newton', 'mujoco_mpc_tpu_torch/csrc/newton.cu',
       'mujoco_mpc_tpu/ops/pallas_newton.py:750',
       {'cartpole': newton_abs, 'quadruped': q_newton_abs,
        'humanoid_track': h_newton_abs, 'shadow_reorient': s_newton_abs})):
    paths = {p: entry(name, p, r['launches'], errs[p])
             for p, r in (('cartpole', cart_main), ('quadruped', quad_main),
                          ('humanoid_track', hum_main),
                          ('shadow_reorient', sha_main))}
    paths.update({p: ilqg_entry(name, p) for p in ilqg_main})
    paths.update({p: plan_entry(name, p) for p in plan_main})
    out.append({'name': name, 'route': 'cuda', 'source': source,
                'replaces': replaces, **paths['quadruped'], 'paths': paths})
  print(json.dumps({'kernels': out}))
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
  main()
