"""Drive the PyTorch port on one NVIDIA GPU, through its hand kernels.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: both CUDA kernels from csrc/ with nvcc, for sm_90a, at once;
     ptxas's registers, stack and spills of every bucket instance of both
     kernels (any spill fails) and the shared memory they take;
  3. check: each kernel against its plain PyTorch version on the card:
     3a B1 on random systems, every n from 1 to 32, B 1, 8192 and 8193
     (3j-3l, Cube Solving's block instances, below);
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
     (B 4096, random systems), wall per call (CUDA events, median of 5;
     the plain versions over one call) and
     device time (profiler), with each kernel's bound and its device time
     as a multiple of the bound;
  5. Cartpole main path: Predictive Sampling, 8192 candidates x 101
     steps, 2 timed plans; both kernels launched as often as the path
     calls them, best_return <= nominal_return; one profiled plan;
  6. Cartpole golden: a 256-candidate plan on the card vs the plain path
     on the CPU with the same candidates, and a 5-step rollout's drift;
  7. Cartpole plan-act: synchronous MPC at 8192 candidates, 0.12 s
     simulated;
  8. Quadruped Flat main path: 4096 candidates x 36 steps, 10 knots, 2
     timed plans from `home`, checked and profiled as in phase 5;
  9. Quadruped golden: the bounds of bench.py's fused_newton_golden;
  10. Quadruped plan-act: synchronous MPC at 128 candidates, 2 plans of
     4 steps, the task's transition on;
  11. Humanoid Track main path: 512 candidates x 41 steps, 10 knots, 2
     timed plans from `home` (the clip's first pose), checked and profiled
     as in phase 5 (bench.py's humanoid_track_ps512);
  12. Humanoid Track golden: the bounds of phase 9;
  13. Humanoid Track plan-act: as phase 10;
  14. Shadow Reorient main path: 8192 candidates x 31 steps, 10 knots, 2
     timed plans from qpos0, checked and profiled as in phase 5
     (bench.py's shadow_ps8192);
  15. Shadow Reorient golden: the bounds of phase 9;
  16. Shadow Reorient plan-act: as phase 10;
  17. Particle iLQG main path: make_planner(spec, ILQG, 8, 51, 10) from
     the task's start (bench.py's particle_ilqg), a warm-up and 2 timed
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
  19. Swimmer iLQG main path: 8 x 201 (bench.py's swimmer_ilqg), 1 timed
     iteration, as phase 17 but with no profiled iteration;
  20. Swimmer iLQG golden: as phase 18;
  21. the other planners on Cartpole at the flagship's width, 8192
     candidates x 101 steps, 10 knots, from (1.0, 3.14159): Cross
     Entropy, Sample Gradient, Gradient and iLQS through make_planner, a
     warm-up and 1 timed iteration each: p50, plans/s, both kernels'
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
  24. testspeed for all seven planner ids on Cartpole: 128 samples, 0.02 s
     simulated, 4 steps a plan; x_realtime and avg_cost (finite);
  25. Cube Solving main path: 512 candidates x 26 steps, 10 knots, 3
     timed plans from `home` (bench.py's rubik_ps512), checked and
     profiled as in phase 5, both kernels in their block instances (n and
     nv 87), launches per plan beside the prediction (2 T and T);
  26. Cube Solving golden: a 64-candidate plan, the bounds of phase 9;
  27. sensors: Quadruped Flat's sensordata (all 45 columns: 42 USER,
     zero, and one FRAMEPOS) of phase 3e's task-shaped states after
     forward, card vs the CPU plain path; then the other sensor types on
     the models of tests/test_torch_sensors.py (assets/sensor_models.npz,
     64 MuJoCo-made states each), card vs CPU;
  28. EKF on Quadruped Flat from `home` (all sensors, ndx 36): a truth
     simulated on the card, measurements with seeded numpy noise, the
     filter started off the truth; one update card vs the CPU plain path
     (qpos, qvel, covariance); 20 updates timed (p50), the kernels'
     launches an update against the prediction (B1 8, 3 at B 1 and 5 at
     B 36 in its Jacobians' tangents; B2 2 at B 1), the busy share, and
     the trunk position (the framepos sensor's) tracked;
  29. UKF: as phase 28, its 73 sigma points one batch (B1 3, B2 2 an
     update, at B 73);
  30. batch estimator: a window of 32 configurations off a card-simulated
     trajectory, 3 Gauss-Newton iterations, in float64: final cost and z
     card vs the CPU plain path, the update's p50 (no kernel: inverse
     dynamics); in float32 its cost trace card vs CPU;
  31-35. the manipulation tasks on the sphere-box pair, FreeFingers,
     Panda, Panda Bring, Bimanual Handover and Bimanual Reorient, from
     qpos0 at each one's own planner settings (64 x 51 with 5 knots, 96 x
     36 with 5, 96 x 51 with 4): 2 timed plans each, checked and profiled
     as in phase 5, launches a plan 2 T and T; its card-vs-CPU golden at
     its own candidates with the bounds of phase 9;
  36. Bimanual Handover plan-act: as phase 10, at its 96 candidates;
  37. Bimanual Handover at 4096 candidates x 51 (quadruped_ps4096's batch):
     one timed plan, checked and profiled as in phase 5, no golden;
  38-41. Walker, Bimanual Insert, Allegro Cube and Humanoid Interact (the
     box-box, capsule-box and capsule-capsule pairs) from qpos0 at each
     one's own settings (128 x 81 with 6 knots, 96 x 51 with 4, 128 x 31
     with 3, 128 x 41 with 5): 2 timed plans each, checked and profiled
     as in phase 5, launches a plan 2 T and T; its card-vs-CPU golden at
     its own candidates with the bounds of phase 9 and best_return within
     1e-5;
  42. Humanoid Interact plan-act: as phase 10, Sitting, then a switch to
     Standing that must write Standing's preset weights;
  43. Allegro Cube at 8192 candidates x 31: one timed plan, checked and
     profiled as in phase 5, no golden;
  44-47. Acrobot, Quadrotor, OP3 Stand and Quadruped Hill (site
     transmissions, height fields) from `home` (Acrobot hanging down) at
     each one's own settings (128 x 301 with 10 knots, 128 x 76 with 5,
     96 x 41 with 4, 60 x 36 with 3): 2 timed plans each, checked and
     profiled as in phase 5, launches a plan 2 T B1 and T B2 (none at
     Acrobot and Quadrotor, which have no constraint rows); its
     card-vs-CPU golden at its own candidates with the bounds of phase 9;
  48. Quadruped Hill at 4096 candidates x 36 (quadruped_ps4096's batch):
     one timed plan, checked and profiled as in phase 5, no golden;
  49. Quadrotor plan-act: synchronous MPC from qpos0, 63 candidates, 100
     steps, 5 steps a plan, the goal moving on its circle (JAX's
     test_quadrotor_hovers_with_planning): every cost finite, z > 0.4;
  50-54. the physics slice's families (assets/physics_models.npz): the
     cylinder and ellipsoid pairs (50), tendons (51), equality constraints
     (52), RK4 (53) and gravity compensation (54), each model stepped
     through forward.step as 4096 perturbed states for 100 steps of random
     controls (CUDA events), launches a step against the prediction (2 B1
     and, with rows, 1 B2; RK4 4 and 4), one profiled 5-step rollout
     (device ops a step, busy share), 256 of the samples card vs the CPU
     plain path for 20 steps (a sample beyond 1e-3 of max(1, |x|) must be
     chaotic: its float64 trajectory moves beyond that when its state
     moves by 1e-7; at most 2 % of them), the golden's 4 states against
     JAX's float64 trajectory (assets/physics_features_golden.npz) for
     20 steps within 2e-4 under the same rule (at most 1 of the 4
     exempt), the samples beyond 1e-4, 1e-3 and 1e-2 printed with those
     not chaotic there, every state finite.
Beside phase 3: 3j B1's block instance (n 33-96) on random systems; 3k
B2's block instance on random dense, one-hot and frictionloss rows at nv
33 and 96, held to 3d's rule for dense problems; 3l both on the inputs the
Cube Solving step gives them (B 512, 64 at `home`, the rest after 15
steps of rollouts: B1 on qM and the Euler system within n eps32 cond(a),
B2 with 384 dense rows, 30 one-hot and 66 frictionloss rows by 3e's rule,
its near ties counted); 3m both on the operands of one EKF and one UKF
update on Quadruped Flat (B1 at B 1, 36 and 73; B2 at B 1 and 73, by
3d's rule for dense problems); 3n both on the inputs the five
manipulation tasks' steps give them (B 4096 each: 64 at qpos0 with the box
on the floor, the rest with a fingertip sphere against the box, a quarter
of them with its centre inside it; B1 on qM and the Euler system, B2 by
3e's rule) and their contact points on the card against the CPU's; 3o
the same for the four box-pair tasks (B 4096 each: 64 at qpos0, the rest
placed against their new pairs) with the contact points under a tie
rule (box_pair_ties: a decision within 1e-5 m, a near-parallel capsule
pair's solve, or points the float64 colliders place apart on the card's
and the CPU's geom poses are exempt; samples with one in contact at most
5 % beyond qpos0); 3p the same for the last four tasks (B 4096 each: 64
at rest at `home`, the rest moved; Quadruped Hill's out on the rough
terrain; B2 only where the model has rows) with the height-field tie
rule (hfield_ties: a point within 1e-5 cell units of a cell's edge or
diagonal, a box whose 4th and 5th corners lie within 1e-5 m), and
Quadrotor's site transmissions card vs CPU (1e-5 relative); 3q both on
the inputs the physics slice's models give them (B 4096 each, after 10
steps of rollouts from perturbed states: B1 on qM and the Euler system
within 1e-4 relative, B2 on the equality, tendon-limit, joint-limit and
contact rows by 3e's rule) and the cylinder and ellipsoid pairs' contact
points card vs CPU under a conditioning tie rule (physics_ties: a point
the float64 colliders move by more than the tolerance when the CPU's
geom poses move by 1e-6, or place apart on the card's and the CPU's
poses, is exempt; samples with one in contact at most 8 %: the scenes
rest on ties by construction).
Beside phase 4: both at Cube Solving's shapes, B1 at n 48 and 96 (random
systems, B 512), both at the estimators' shapes (3m's operands), and both
at the manipulation paths' (B 65 and 97 at nv 12, 15 and 18, and B 4097 at
nv 18) and the box-pair paths' (B 129, 97, 129, 129 at nv 9, 18, 18, 23,
and B 8193 at Allegro Cube's nv 18, P 59), and the last four paths' (B1
alone at Acrobot's B 129 n 2 and Quadrotor's B 129 n 6; both at OP3
Stand's B 97, P 29, and Quadruped Hill's B 61 and B 4097, P 36), and
both at each physics family's largest row set (3q's inputs, B 4096).
Then one JSON line with the kernels' launches, errors, times and bounds
(top-level keys: the Quadruped path; "paths": all thirty, the iLQG
ones at the line search's shapes with B1's derivative tangent under
"tangent", the planner paths of phases 21-23 with their launches per
iteration and
their golden's best_return relative error, Cube Solving's with its
golden's, and the EKF's and UKF's with their launches, p50 and busy
share an update, the manipulation, box-pair and last four tasks' with
their golden's; B2's entry at Acrobot and Quadrotor holds its 0
launches and no times), and as the last line {"ok": true, "device":
{...}}.
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
# timed plans and plan-act depth, cut to make room for phases 21-26
# inside the run's time limit (Cartpole's plans were 10, then 5, the
# others 5; the plan-act loops 1 s at Cartpole and 25 plans elsewhere;
# Particle's and Swimmer's iLQG iterations 10 and 5, then 5 and 2)
CART_PLANS = 2
QUAD_PLANS = 2
HUMAN_PLANS = 2
SHADOW_PLANS = 2
CART_PLAN_ACT_TIME = 0.12  # simulated seconds (0.5 before Cube Solving's
                           # phases joined)
PLAN_ACT_STEPS = 8         # 2 plans of 4 steps (8 plans before)
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
# the plain versions at the Humanoid shapes, timed over one call (3 before
# Cube Solving's phases joined): B1's unrolls ~5,000 launches a call at n
# 23, B2's ~6 times as many
HUMAN_PLAIN_REPS = 1
TIME_REPS = 5              # calls a kernel is timed over (30 before Cube
                           # Solving's phases joined, 10 before the
                           # estimators')
# B1 beyond the paths' sizes: the buckets the mesh-hull hands will use,
# its plain version there timed over a few calls
# iLQG, bench.py's particle_ilqg / swimmer_ilqg: make_planner(spec, ILQG,
# 8, T, 10), timed iterations from the task's start
ILQG_CANDIDATES = 8
PARTICLE_ITERS = 2         # 3 before the estimators' phases joined
SWIMMER_ITERS = 1
# Swimmer's iLQG iteration is not profiled (its device trace, ~600,000
# launches, took 133-145 s to read; profiled before the estimators' phases
# joined): a cut of measurement depth that keeps the run inside its limit
SWIMMER_PROFILE = False
# calls the plain versions are timed over in phase 4 at the Cartpole,
# Quadruped, iLQG, planner and Cube Solving shapes (one plain Newton call
# is up to ~5,000 launches, and the profiler's passes over them dominated
# phase 4: 30 calls, then 3, now 1)
PLAIN_REPS = 1
# phases 21-24: the other planners
PLANNER_SAMPLES = 8192     # Cartpole's flagship width
PLANNER_ITERS = 1          # 5 before Cube Solving's phases joined, 2
                           # before the estimators'
FORCED_ITERS = 1           # iLQS with its iLQG branch forced
GOLDEN_SAMPLES = 256
ROBUST_SAMPLES = 4096      # Quadruped Flat (bench.py's quadruped_ps4096)
ROBUST_ITERS = 1           # 5 before Cube Solving's phases joined, 2
                           # before the estimators'
ROBUST_REROLLOUTS = 60     # DEFAULT_NCANDIDATES x DEFAULT_NREPETITIONS
TESTSPEED_TIME = 0.02      # simulated seconds a planner, one plan (0.2
                           # asked; cut to 0.1, then 0.02, to keep the run
                           # inside its time limit)
TESTSPEED_SAMPLES = 128    # Cartpole's sampling_trajectories
SPD_EXTRA_N = (24, 32)
SPD_EXTRA_PLAIN_REPS = 1
# Cube Solving (bench.py's rubik_ps512): nv 87, both kernels' block
# instances; phase 3l's task-shaped states come from rollouts of this many
# planning steps from `home`, the first CUBE_HOME of them at `home` itself
CUBE_SAMPLES = 512
CUBE_PLANS = 3
CUBE_GOLDEN_SAMPLES = 64
CUBE_ROLLOUT_STEPS = 15
CUBE_HOME = 64
# B1 beside Cube Solving's n 87: random systems at the block instance's
# other buckets and at 96, its largest
SPD_WIDE_N = (33, 48, 64, 87, 96)
# phases 3n, 31-37: the manipulation tasks on the sphere-box pair, each at
# its own planner settings (samples, horizon and knots from its MJCF)
MANIP_TASKS = ('FreeFingers', 'Panda', 'Panda Bring', 'Bimanual Handover',
               'Bimanual Reorient')
MANIP_STATES = 4096        # phase 3n's states a task
MANIP_FLOOR = 64           # of them at qpos0, the box on the floor
MANIP_PLANS = 2
MANIP_WIDE = 4096          # Bimanual Handover at quadruped_ps4096's batch
MANIP_WIDE_PLANS = 1
MANIP_WIDE_PATH = 'bimanual_handover_4096'
# phases 3o, 38-43: the tasks of the box-box, capsule-box and
# capsule-capsule pairs, each at its own planner settings
BOX_TASKS = ('Walker', 'Bimanual Insert', 'Allegro Cube',
             'Humanoid Interact')
BOX_STATES = 4096          # phase 3o's states a task
BOX_QPOS0 = 64             # of them at qpos0: aligned boxes, parallel legs
BOX_PLANS = 2
BOX_WIDE = 8192            # Allegro Cube at its full batch (phase 43)
BOX_WIDE_PLANS = 1
BOX_WIDE_PATH = 'allegro_cube_8192'
# 3o's tie rule: a sample's points may differ card vs CPU only where one
# of its pairs decides within TIE_MARGIN (m; separations of the best and
# runner-up axes, the edge axis's 1e-4 bias, incident-face cosines, a
# sphere centre's distance to the box surface or between its two least
# depths) or where two capsule axes are so near parallel that float32
# rounding (F32_ULPS, four ulps relative, of the world positions the
# segment solve subtracts) over its denominator 1 - (a1.a2)^2 moves the
# first clamped s by more than POINT_ATOL; such samples beyond the qpos0
# ones at most BOX_TIE_CAP of the rest
TIE_MARGIN = 1e-5
F32_ULPS = 2.4e-7
BOX_TIE_CAP = 0.05
BOX_GOLDEN_RTOL = 1e-5     # 38-41: best_return card vs CPU, relative
# phases 3p, 44-49: the last four tasks, each at its own planner settings
LAST_TASKS = ('Acrobot', 'Quadrotor', 'OP3 Stand', 'Quadruped Hill')
LAST_STATES = 4096         # phase 3p's states a task
LAST_HOME = 64             # of them at rest at `home` (Acrobot: qpos0)
LAST_PLANS = 2
LAST_WIDE = 4096           # Quadruped Hill at quadruped_ps4096's batch
LAST_WIDE_PLANS = 1
LAST_WIDE_PATH = 'quadruped_hill_4096'
# 3p's tie rule for height-field points: within HFIELD_TIE cell units of a
# cell's edge or diagonal (and a box's 4th and 5th corners within
# TIE_MARGIN m); samples beyond `home` with such a point in contact at
# most BOX_TIE_CAP of the rest
HFIELD_TIE = 1e-5
LAST_ACT_RTOL = 1e-5       # 3p: Quadrotor's site transmissions, card vs CPU
ACROBOT_HANG = 3.14159     # 44: Acrobot's shoulder angle, hanging down
# phase 49: tests/test_tasks.py test_quadrotor_hovers_with_planning
HOVER_SAMPLES = 63
HOVER_STEPS = 100
HOVER_STEPS_PER_PLAN = 5
# phases 3q and 50-54: the physics slice's families
PHYS_FAMILIES = ('convex', 'tendons', 'equality', 'rk4', 'gravcomp')
PHYS_SAMPLES = 4096        # perturbed states a model
PHYS_SEED = 16             # 3q and 50-54 draw from a generator of their own,
                           # so the earlier phases keep their inputs
PHYS_STEPS = 100           # timed rollout steps
PHYS_STATE_STEPS = 10      # 3q: rollout steps before the kernels' inputs
PHYS_PROFILE_STEPS = 5     # the profiled rollout
PHYS_CPU_SAMPLES = 256     # card vs CPU: samples and steps
PHYS_CPU_STEPS = 20
# 50-54's tolerances, |d| / max(1, |x|) over qpos and qvel, about 10x the
# readings (H100): card vs CPU (f32 both) at most 1.09e-4 (plane-cylinder,
# a sample chaotic at 1e-4), 1.29e-5 elsewhere; card f32 vs JAX's f64
# golden 1.61e-5 (2.52e-5 on the CPU in f32) outside plane-cylinder's
# first sample (7.94e-4; its trajectory moves 1.86e-2 when its state
# moves 1e-7, so it is exempt)
PHYS_CPU_TOL = 1e-3
PHYS_GOLDEN_TOL = 2e-4
PHYS_TIE = 1e-6            # physics_ties: the geom poses' move
# 3q: samples with a tied point in contact, at most this share. The scenes
# rest on ties by construction (a cylinder standing on its disc, whose
# deepest rim point turns with rounding, a lying one on two rims, a
# tessellated hull on a face): 5.0 % measured at plane-cylinder.
PHYS_TIE_CAP = 0.08
# 50-54: card vs CPU, chaotic samples at most this share of
# PHYS_CPU_SAMPLES (none measured beyond 1e-3); the golden, at most this
# many of its 4 samples.
PHYS_CHAOS_CAP = 0.02
PHYS_GOLDEN_EXEMPT = 1
# 50-54: errors reported at these levels (samples beyond each, and of
# them those not chaotic at it); the sensitivity is probed beyond the first
PHYS_LEVELS = (1e-4, 1e-3, 1e-2)
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
  the profiler kept when it kept fewer than the calls; a retaken pass of
  `kernel` makes four times the calls of the last. `warm=False` skips
  the unprofiled warm-up call (for an fn that has run already);
  `host=False` traces the device's activity only (an iLQG iteration is
  ~600,000 launches, and tracing the host's side of each as well took
  minutes)."""
  import torch
  from torch.profiler import ProfilerActivity, profile

  def launches(e, calls):
    return 1 if kernel and kernel in e.key else round(e.count / calls)

  def counted(dev, calls):
    if kernel:
      return [e for e in dev if kernel in e.key]
    return dev[:1] if dev and 2 * dev[0].count >= calls else []

  if warm:
    fn()
  torch.cuda.synchronize()
  calls = reps
  for _ in range(5):
    with profile(activities=[ProfilerActivity.CPU] * host
                 + [ProfilerActivity.CUDA]) as prof:
      for _ in range(calls):
        fn()
      torch.cuda.synchronize()
    dev = device_ops(prof)
    if counted(dev, calls):
      break
    if kernel:
      calls *= 4      # late in a process it keeps ~1 record in 5, or none
  check(counted(dev, calls), 'the profiler saw '
        + (f'no {kernel}' if kernel else
           f'{dev[0].key[:60]} {dev[0].count} times' if dev else 'no kernel')
        + f' over {calls} calls, in five passes')
  if kernel and counted(dev, calls)[0].count < calls:
    print(f'device_us: the profiler kept {counted(dev, calls)[0].count} of '
          f'{calls} records of {kernel}')
  ops = [(e.key, launches(e, calls),
          e.self_device_time_total / e.count * launches(e, calls)
          if launches(e, calls) else e.self_device_time_total / calls)
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
  the sums key_averages() computes, grouped in one pass over the trace's
  raw records (prof.events() first builds an event tree: ~7 s per 100,000
  records on a CPU against ~0.4 s for the raw ones, and a plan is
  ~50,000-190,000 device records; a kernel's self time is its
  duration)."""
  import torch
  ops = {}
  cuda = torch.autograd.DeviceType.CUDA
  for e in prof.profiler.kineto_results.events():
    if e.device_type() == cuda:
      name = e.name()
      op = ops.get(name)
      if op is None:
        op = ops[name] = DeviceOp(name)
      op.count += 1
      op.self_device_time_total += e.duration_ns() / 1e3
  return sorted(ops.values(), key=lambda op: -op.self_device_time_total)


def bound(bytes_, flops):
  """(ms, 'bytes' or 'operations'): the least time the card could take
  to move `bytes_` and compute `flops` in float32."""
  t_bytes, t_ops = bytes_ / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
  return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops
                                     else 'operations')


def kernel_name(kind, n):
  """The device function of B1 ('chol_solve') or B2 ('newton') that size
  n runs: the tile instance up to 32, the block instance (`_wide_`)
  above."""
  return f'{kind}_wide_kernel' if n > 32 else f'{kind}_kernel'


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


def newton_cost(ex, qacc, friction=None):
  """The Newton solve's objective at qacc on expanded operands `ex`, in
  float64: 0.5 e'M e plus 0.5 D jar^2 over the active rows, contact
  facets included, e = qacc - qs, plus the frictionloss rows' Huber
  cost."""
  import torch
  from mujoco_mpc_tpu_torch.ops import newton
  qm, qs, j, aref, dvec, eqf, s_aref, s_dvec, dof, sign = ex
  qacc = qacc.double()
  e = qacc - qs
  cost = 0.5 * torch.sum(e * (qm @ e[..., None])[..., 0], -1)
  jar = (j @ qacc[..., None])[..., 0] - aref
  act = (jar < 0) | (eqf > 0.5)
  cost = cost + 0.5 * torch.sum(torch.where(act, dvec, 0.0) * jar * jar, -1)
  jar = sign * qacc[:, dof] - s_aref
  cost = cost + 0.5 * torch.sum(torch.where(jar < 0, s_dvec, 0.0) * jar
                                * jar, -1)
  if friction is not None:
    f_aref, f_dvec, f_loss, fdof = friction
    cost = cost + torch.sum(newton.huber_cost(
        qacc[:, fdof.long()] - f_aref.double(), f_dvec.double(),
        f_loss.double()), -1)
  return cost


def newton_bound(args, gargs, condims, dmasks, cap, tol, friction=None):
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
      *args, *gargs, cap=c, tol=tol, condims=condims, dmasks=dmasks,
      friction=friction)
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
  nf = friction[0].shape[1] if friction is not None else 0
  per_iter = (6 * nv * nv + nv ** 3 / 3 + 16 * args[6].shape[1]
              + 24 * nf + j.shape[1] * (2 * nv + 15) + active_d * row_cost)
  goff = 3 + (friction is not None)
  for gi in range(len(condims)):
    nnz = (dmasks[gi] != 0).sum(-1)                          # (P,)
    contact = gargs[3 + 4 * gi] > 0                          # (B, P)
    active = (final[goff + gi] < 0) & contact[:, None, :]    # (B, nrep, P)
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
                  + list(dmasks) + list(friction or ()))
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
  name = kernel_name('chol_solve', args[1].shape[1])
  dev = {k: device_us(f, reps[k], kernel=name if k == 'chol_solve' else None)
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
                   tol=1e-6, friction=None):
  """Kernel vs plain version: (samples outside rtol 2e-3/atol 1e-3 of the
  plain version, max relative objective gap, max abs error, max relative
  objective gap over the samples outside the tolerance)."""
  import torch
  from mujoco_mpc_tpu_torch.ops import newton
  kw = dict(cap=cap, tol=tol, condims=condims, dmasks=dmasks,
            friction=friction)
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
  c_got = newton_cost(ex, got[0], friction)
  c_want = newton_cost(ex, want[0], friction)
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
  name = kernel_name('newton', args[1].shape[1])
  dev = {k: device_us(f, reps[k], kernel=name if k == 'newton' else None)
         for k, f in fns.items()}
  b_ms, by, iters = newton_bound(args, gargs, kw.get('condims', ()),
                                 kw.get('dmasks', ()), kw['cap'], kw['tol'],
                                 kw.get('friction'))
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
  """[(nv, text)]: the dynamic shared memory B2 takes at the five paths'
  shapes (the kernel sizes it at launch, 128 threads a block; at Cube
  Solving's nv 87 a block of 256 a sample) and the samples an SM then
  holds. The Humanoid's, Shadow's and Cube Solving's blocks are past 48
  KB, through the kernel's opt-in attribute; Shadow's 228 facet rows
  leave room for one block an SM."""
  from mujoco_mpc_tpu_torch.ops import newton
  smem = newton.sample_smem_bytes(87, 384, 30, (), 66)
  blocks = resident_blocks(87, newton.WIDE_THREADS, smem)
  out = [(87, f'dynamic shared memory at Cube Solving nv 87 n 384 ns 30 nf '
          f'66: {smem} bytes a block of one sample; {blocks} samples '
          'resident per SM')]
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
    label, buckets = 'N', spd_solve.N_BUCKETS
    smem = lambda nb: (  # noqa: E731
        f'; shared memory {spd_solve.block_smem_bytes(nb)} bytes a block of '
        f'{max(1, spd_solve.THREADS // spd_solve.kernel_lanes(nb))} '
        'systems')
  else:
    label, buckets = 'nv', newton.NV_BUCKETS
    smem = lambda nb: ''  # noqa: E731
  out, spilled = [], 0
  for nb in buckets:
    kernel = kernel_name(name, nb)
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


def tool_start(tool):
  """The start of a tools/*_check.py run: refuses without a card, prints
  the card's line and torch's version, builds both kernels at once and
  prints ptxas's lines of every instance. Returns (elapsed(phases), which
  prints the seconds since the start, and the bytes the instances spill,
  which the tool checks after its own checks)."""
  import torch
  if not torch.cuda.is_available():
    raise SystemExit(f'{tool}: no CUDA device')
  from mujoco_mpc_tpu_torch.ops import cuda_build
  print(smi_line(), f'(torch {torch.__version__})')
  torch.backends.cuda.matmul.allow_tf32 = False
  start = time.perf_counter()

  def elapsed(phases):
    print(f'elapsed after {phases}: {time.perf_counter() - start:.1f} s')

  kernels = ('chol_solve', 'newton')
  with concurrent.futures.ThreadPoolExecutor(len(kernels)) as pool:
    libs = dict(zip(kernels, pool.map(cuda_build.build, kernels)))
  elapsed('the build')
  spilled = 0
  for name in kernels:
    lines, spill = ptxas_lines(name, libs[name])
    spilled += spill
    for line in lines:
      print(line)
  return elapsed, spilled


def errors(got, want):
  """(max abs error, max abs error / max(1, max |want|))."""
  import torch
  err = float(torch.max(torch.abs(got - want)))
  return err, err / max(1.0, float(torch.max(torch.abs(want))))


def solver_inputs(spec, d, friction=False):
  """The operands one step of `spec` from states d hands both kernels:
  (B1's (qM, qfrc_smooth), B2's (args, gargs, condims, dmasks)), and
  with `friction` B2's frictionloss operands after its dmasks."""
  from mujoco_mpc_tpu_torch.physics import constraint, forward as fwd, smooth
  import torch
  m = spec.model
  d = fwd.fwd_actuation(m, fwd.fwd_velocity(m, fwd.fwd_position(m, d)))
  d = smooth.crb(m, d).replace(qfrc_constraint=torch.zeros_like(d.qvel))
  d = fwd.fwd_acceleration(m, d)
  args, gargs, condims, dmasks, fric = constraint.newton_operands(
      m, d, *constraint.make_rows_split(m, d))
  args = tuple(t.contiguous() for t in args)
  n_in = (args, gargs, condims, dmasks)
  if friction:
    n_in += (tuple(t.contiguous() for t in fric) if fric else None,)
  return (d.qM.contiguous(), d.qfrc_smooth.contiguous()), n_in


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


def stacked_points(spec, d):
  """(dist (B, P), pos (B, P, 3), normal (B, P, 3)) of the step from
  states d after its kinematics: every condim group's stacked candidate
  points in JAX's order."""
  import torch
  from mujoco_mpc_tpu_torch.physics import constraint
  groups = constraint._contact_groups(spec.model, d).values()
  return (torch.cat([s.dist for s in groups], 1),
          torch.cat([s.pos3 for s in groups], 1),
          torch.cat([s.normal for s in groups], 1))


def to_cpu(d):
  """Data d with every field on the CPU."""
  import dataclasses
  from mujoco_mpc_tpu_torch.physics.model import Data
  return Data(**{f.name: getattr(d, f.name).cpu()
                 for f in dataclasses.fields(d)
                 if getattr(d, f.name) is not None})


def contact_points(spec, d):
  """stacked_points of the step from states d and the hull's world
  vertices (B, V, 3)."""
  from mujoco_mpc_tpu_torch.physics import collision
  from mujoco_mpc_tpu_torch.physics import forward as fwd
  m = spec.model
  d = fwd.fwd_position(m, d)
  hull = next(iter(m.geom_mesh))
  return stacked_points(spec, d) + (collision._hull_world(m, d, hull)[0],)


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
  import torch
  card = [x.cpu() for x in contact_points(spec, d)]
  cpu = contact_points(cpu_spec, to_cpu(d))
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


def main_path(spec, d0, samples, reps, gen, points=SPLINE_POINTS):
  """Predictive Sampling plans of `spec` from d0 through the planner
  registry's entry point (make_planner(spec, 0, samples, T, points)): a
  warm-up, then `reps` timed plans with the kernels' counts set to 0 just
  before and read just after (B1 twice a rollout step; B2 once, or never
  where the model has no constraint rows), then one profiled plan (its
  device activity)."""
  import torch
  from mujoco_mpc_tpu_torch import agent
  from mujoco_mpc_tpu_torch.ops import newton, spd_solve
  from mujoco_mpc_tpu_torch.planners import registry as planners
  t_steps = agent.horizon_steps(spec)
  planner = planners.make_planner(spec, planners.SAMPLING, samples, t_steps,
                                  points)

  def plan(pol):
    return planner.optimize(pol, d0, spec.default_params, gen)

  pol, _ = plan(planner.init())   # warm-up
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
  per_step = int(has_rows(spec.model))
  check(launches['newton'] == per_step * reps * t_steps,
        f'newton launched {launches["newton"]} times, expected '
        f'{per_step * reps * t_steps} ({per_step} a rollout step)')
  check(launches['chol_solve'] == 2 * reps * t_steps,
        f'chol_solve launched {launches["chol_solve"]} times, expected '
        f'{2 * reps * t_steps} (twice per rollout step)')
  best = torch.stack([i['best_return'] for i in infos]).cpu()
  nominal = torch.stack([i['nominal_return'] for i in infos]).cpu()
  check(bool(torch.isfinite(best).all()), f'best_return not finite: {best}')
  check(bool((best <= nominal).all()), 'best_return > nominal_return')
  p50 = statistics.median(lat)
  # the plans above warmed it up; the busy share needs the device's
  # activity alone (as in the iLQG phases), not the host side of each of
  # the plan's ~50,000-95,000 launches
  dev_us, ops, top = device_us(lambda: plan(pol), reps=1, top=8, warm=False,
                               host=False)
  return dict(t_steps=t_steps, p50=p50, launches=launches,
              best=float(best[-1]), nominal=float(nominal[-1]),
              dev_us=dev_us, ops=ops, top=top)


def has_rows(m):
  """Whether a step of model m has constraint rows (contacts, joint
  limits, frictionloss, equality constraints, tendon limits), so that it
  launches B2."""
  return bool(m.collision_pairs or any(m.jnt_limited) or m.friction_dof
              or any(m.eq_active0) or any(m.tendon_limited))


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


def golden(spec, cpu_spec, d0, d0_cpu, gen, ctrl_scale, samples=256,
           points=SPLINE_POINTS):
  """A `samples`-candidate plan on the card against the plain path on the
  CPU with the same noise, from the default plan of `points` knots, and a
  5-step batched rollout's qpos drift: (best_return card, CPU, rel err,
  winner card, CPU, winner within 2 % of the CPU best, drift)."""
  import torch
  from mujoco_mpc_tpu_torch import agent
  from mujoco_mpc_tpu_torch.ops import spline
  from mujoco_mpc_tpu_torch.physics import forward as fwd
  from mujoco_mpc_tpu_torch.planners import sampling
  t_steps, interp = agent.horizon_steps(spec), int(spline.Interp.ZERO)
  cfg, cpu_cfg = (sampling.default_config(spec),
                  sampling.default_config(cpu_spec))
  eps, use2 = sampling.sample_noise(spec, points, samples - 1, cfg, gen)
  pol = sampling.default_policy(spec, points)
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
  ctrl = ctrl_scale * torch.randn((samples, 5, spec.model.nu),
                                  generator=gen, device=DEV)
  qpos_run = []
  for m, c, d in ((spec.model, ctrl, d0), (cpu_spec.model, ctrl.cpu(),
                                           d0_cpu)):
    d = d.expand(samples)
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
  [('chol_solve' or 'newton', B), ...], as `_record` makes them); the
  calls go on to the kernels."""

  def _record(self, kind, args, kw):
    return kind, args[1].shape[0]

  def __enter__(self):
    from mujoco_mpc_tpu_torch.ops import newton, spd_solve
    self.saved = spd_solve._solve, newton._newton
    self.calls = []
    solve, newt = self.saved

    def rec_solve(a, b):
      self.calls.append(self._record('chol_solve', (a, b), {}))
      return solve(a, b)

    def rec_newton(*args, **kw):
      self.calls.append(self._record('newton', args, kw))
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


def ilqg_main_path(spec, iters, candidates, profile=True):
  """make_planner(spec, ILQG, candidates, T, 10) from the task's start
  (bench.py's particle_ilqg / swimmer_ilqg): one warm-up iteration, then
  `iters` timed ones with the kernels' counts set to 0 just before and
  read just after, their wall split (each stage synchronized) and the
  kernels' batches recorded, then, with `profile`, one profiled
  iteration (without it, dev_us, ops and top are None)."""
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
  dev_us = ops = top = None
  if profile:
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
  if r['dev_us'] is None:
    print(f'phase {phase} profiled iteration: none (measurement depth cut)')
    return
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


# ---------------------------------------------------------------------------
# Cube Solving: both kernels' block instances (nv 33-96), phases 3j-3l,
# 25-26, and their rows in phase 4
# ---------------------------------------------------------------------------


def spd_tolerance(a):
  """B1's relative tolerance against its plain version on systems a:
  1e-4 (phase 3a's), or n eps32 cond(a) where that is larger (the forward
  error bound of a Cholesky solve; cond in float64, the batch's worst):
  Cube Solving's qM has cond ~2e3 at n 87."""
  import torch
  ev = torch.linalg.eigvalsh(a.double())
  cond = float(torch.max(ev[:, -1] / torch.clamp(ev[:, 0], min=1e-300)))
  return max(1e-4, a.shape[-1] * 2.0 ** -24 * cond), cond


def check_spd_wide(gen):
  """Phase 3j: B1's block instance against its plain version on random
  systems (phase 3a's construction, cond <= ~10) at n 33, 48, 64, 87 and
  96, B 1, 512 and 513."""
  from mujoco_mpc_tpu_torch.ops import linalg, spd_solve
  worst = 0.0
  for n in SPD_WIDE_N:
    for bsz in (1, CUBE_SAMPLES, CUBE_SAMPLES + 1):
      a, b = random_spd(gen, bsz, n)
      _, err = errors(spd_solve.solve_spd(a, b), linalg.solve_spd(a, b))
      check(err <= 1e-4, f'chol_solve vs plain, n {n} B {bsz}: {err:.3g} '
            f'> 1e-4')
      worst = max(worst, err)
  print(f'phase 3j chol_solve vs plain, block instance, n '
        f'{"/".join(map(str, SPD_WIDE_N))}, B 1/{CUBE_SAMPLES}/'
        f'{CUBE_SAMPLES + 1}: max rel err {worst:.3g} (tol 1e-4)')


def random_friction(gen, bsz, nv, nf):
  """nf frictionloss rows on distinct dofs: (f_aref, f_dvec, f_loss,
  fdof), the loss between 0.1 and 1, so that the rows of a random problem
  (jars O(1)) sit in all three zones."""
  import torch
  dofs = torch.randperm(nv, generator=gen, device=DEV)[:nf]
  return (torch.randn((bsz, nf), generator=gen, device=DEV),
          torch.nn.functional.softplus(
              torch.randn((bsz, nf), generator=gen, device=DEV)),
          0.1 + 0.9 * torch.rand((nf,), generator=gen, device=DEV),
          dofs.to(torch.int32).contiguous())


def check_newton_wide(gen):
  """Phase 3k: B2's block instance against its plain version on random
  dense, one-hot and frictionloss rows at nv 33 (its smallest) and 96
  (its largest; 384 dense rows, 30 one-hot and 66 frictionloss as Cube
  Solving's), B 512 and 513, cap 30. These random problems have 2-5 rows
  per dof, 20 % of them equality rows, and sit on many kinks at their
  optimum, so they are held to phase 3d's rule for dense problems (every
  sample outside the tolerance a near tie, no count bound): at nv 96,
  52-87 of 512 samples are near ties on an H100 (gaps <= 1.6e-7)."""
  for (nv, n, ns, nf) in ((33, 48, 8, 16), (96, 384, 30, 66)):
    for bsz in (CUBE_SAMPLES, CUBE_SAMPLES + 1):
      fric = random_friction(gen, bsz, nv, nf)
      nbad, gap, _, bad_gap = compare_newton(
          random_newton(gen, bsz, nv, n, ns), friction=fric)
      newton_ok(f'nv {nv}, n {n}, ns {ns}, nf {nf}', bsz, nbad, gap,
                bad_gap, share=False)
      print(f'phase 3k newton vs plain, block instance, nv {nv} n {n} ns '
            f'{ns} nf {nf} B {bsz} cap 30: '
            f'{newton_line(nbad, bsz, gap, bad_gap, share=False)}')


def cube_states(spec, gen):
  """CUBE_SAMPLES states of Cube Solving from `home` (the cube held 2 cm
  above the palm), the first CUBE_HOME exactly `home` at rest, the rest
  after CUBE_ROLLOUT_STEPS steps of the planning model under controls
  drawn uniformly in the control range each step: the cube drops onto the
  palm and its cubelets press on each other."""
  import torch
  from mujoco_mpc_tpu_torch import agent
  from mujoco_mpc_tpu_torch.physics import forward as fwd
  from mujoco_mpc_tpu_torch.physics.model import make_data
  m, b = spec.model, CUBE_SAMPLES
  clo, chi = m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1]
  home = m.keyframe_qpos('home')
  pm = agent.plan_model(spec)
  d = make_data(m, b).replace(qpos=home.expand(b, -1).clone())
  for _ in range(CUBE_ROLLOUT_STEPS):
    d = fwd.step(pm, d.replace(ctrl=clo + (chi - clo) * torch.rand(
        (b, m.nu), generator=gen, device=DEV)))
  qpos, qvel, ctrl = d.qpos.clone(), d.qvel.clone(), d.ctrl.clone()
  rest = slice(0, CUBE_HOME)
  qpos[rest], qvel[rest], ctrl[rest] = home, 0.0, 0.0
  return make_data(m, b).replace(qpos=qpos, qvel=qvel, ctrl=ctrl)


def check_cube_kernels(spec, gen):
  """Phase 3l: both kernels on the inputs the Cube Solving step gives
  them at cube_states: B1 on qM and on the Euler system within
  spd_tolerance, B2 (nv 87, 128 mesh-mesh rows and 256 capped facet rows
  dense, the limit rows one-hot, 66 frictionloss rows) with phase 3e's
  rule, its near ties counted. Returns (B1's (qM, rhs), B2's (args, kw),
  B1's and B2's max abs errors)."""
  import torch
  from mujoco_mpc_tpu_torch.ops import newton
  states = cube_states(spec, gen)
  spd_in, (args, _, _, _, fric) = solver_inputs(spec, states, friction=True)
  tol, cond = spd_tolerance(spd_in[0])
  spd_abs, spd_err = check_spd_inputs(spd_in, tol, 'Cube Solving')
  e_in = euler_inputs(spec, states)
  e_tol, e_cond = spd_tolerance(e_in[0])
  _, e_err = check_spd_inputs(e_in, e_tol, 'Cube Solving Euler')
  kw = dict(cap=spec.model.opt.iterations, tol=1e-5, friction=fric)
  nbad, gap, n_abs, bad_gap = compare_newton(args, **kw)
  newton_ok('Cube Solving inputs', CUBE_SAMPLES, nbad, gap, bad_gap)
  want = newton.newton_reference(*args, **kw)
  contact = int((args[4] > 0).sum())
  active = int(((want[1] < 0) & (args[4] > 0)).sum())
  clamped = int((torch.abs(fric[1] * want[3]) > fric[2]).sum())
  print(f'phase 3l Cube Solving step inputs (B {CUBE_SAMPLES}, the first '
        f'{CUBE_HOME} at home, the rest {CUBE_ROLLOUT_STEPS} steps of '
        f'rollouts from it): chol_solve n {spec.model.nv} rel err qM '
        f'{spd_err:.3g} (tol {tol:.3g}, cond {cond:.4g}), Euler system '
        f'{e_err:.3g} (tol {e_tol:.3g}, cond {e_cond:.4g}); newton nv '
        f'{spec.model.nv}, {args[2].shape[1]} dense rows ({contact} with D '
        f'> 0, {active} active at the solution), {args[6].shape[1]} one-hot, '
        f'{fric[0].shape[1]} frictionloss ({clamped} clamped at the '
        f'solution), cap {kw["cap"]}: {nbad} near ties; '
        + newton_line(nbad, CUBE_SAMPLES, gap, bad_gap))
  return spd_in, (args, kw), (spd_abs, n_abs)


def time_cube_kernels(spec, spd_in, n_in, gen, kern):
  """Phase 4's Cube Solving rows: B1 on the step's qM (n 87, B 512) and
  on random systems at n 48 and 96 (B 512), B2 on the step's inputs, each
  with its plain version (over PLAIN_REPS calls), B1 with the library
  call, and the bounds. Fills kern['cube_solving']."""
  args, kw = n_in
  spd_times = time_spd(spd_in, PLAIN_REPS)
  n_wall, n_dev, n_bound, iters = time_newton(args, (), kw, PLAIN_REPS)
  kern['cube_solving'] = dict(wall={**spd_times[0], **n_wall},
                              dev={**spd_times[1], **n_dev},
                              spd_bound=spd_times[2], newton_bound=n_bound)
  print(f'phase 4 timing cube_solving per call, wall / device only: '
        + spd_timing_line(*spd_times, spd_in[0]) + '; '
        + newton_timing_line(
            f'B {CUBE_SAMPLES} nv {spec.model.nv} n {args[2].shape[1]} ns '
            f'{args[6].shape[1]} nf {kw["friction"][0].shape[1]} cap '
            f'{kw["cap"]}', n_wall, n_dev, n_bound, iters, PLAIN_REPS))
  for n in (48, 96):
    spd_args = random_spd(gen, CUBE_SAMPLES, n)
    print(f'phase 4 timing, random systems, per call, wall / device only: '
          + spd_timing_line(*time_spd(spd_args, PLAIN_REPS), spd_args[0]))


def cube_phases(spec, cpu_spec, gen, elapsed):
  """Phases 25-26: Cube Solving's main path (CUBE_SAMPLES x 26 from
  `home`, bench.py's rubik_ps512) and its card-vs-CPU golden at
  CUBE_GOLDEN_SAMPLES candidates. Returns the main path's record."""
  from mujoco_mpc_tpu_torch.physics.model import make_data
  home = spec.model.keyframe_qpos('home')[None]
  d0 = make_data(spec.model).replace(qpos=home)
  r = main_path(spec, d0, CUBE_SAMPLES, CUBE_PLANS, gen)
  print_main_path(25, 'Cube Solving', CUBE_SAMPLES, CUBE_PLANS, r)
  print(f'phase 25 launches per plan: chol_solve '
        f'{r["launches"]["chol_solve"] // CUBE_PLANS}, newton '
        f'{r["launches"]["newton"] // CUBE_PLANS} (predicted 2 T = '
        f'{2 * r["t_steps"]} and T = {r["t_steps"]}: the candidates and the '
        f'nominal roll out as one batch of {CUBE_SAMPLES + 1})')
  elapsed('25')
  d0_cpu = make_data(cpu_spec.model).replace(qpos=home.cpu())
  br_gpu, br_cpu, rel, win_gpu, win_cpu, drift = golden(
      spec, cpu_spec, d0, d0_cpu, gen, 0.2, CUBE_GOLDEN_SAMPLES)
  print(f'phase 26 golden: Cube Solving {CUBE_GOLDEN_SAMPLES}-candidate plan '
        f'best_return card {br_gpu:.6g} vs CPU plain {br_cpu:.6g}: rel err '
        f'{rel:.3g} (tol 0.02); winner card {win_gpu} vs CPU {win_cpu} '
        f'(match {win_gpu == win_cpu}); 5-step rollout qpos drift '
        f'{drift:.3g} (tol 0.05)')
  elapsed('26')
  return r, rel


# ---------------------------------------------------------------------------
# Phases 27-30: the estimators on Quadruped Flat from `home`.
# ---------------------------------------------------------------------------

EST_UPDATES = 20           # filter updates timed and tracked (27-29)
EST_NOISE = 0.01           # sensor noise std (the filter's variance 1e-4)
EST_START_OFFSET = 0.03    # the filter's first trunk position error (m)
# B1 and B2 launches a filter update, predicted from the code: the EKF's
# measurement update runs forward once, inside jacfwd, whose value is the
# prediction (B1 and B2 at B 1), its tangent B1 twice at B ndx (qM, and
# the Newton tangent's H solve; the Newton tangent launches no B2); the
# prediction runs step once, inside jacfwd (B1 twice, B2 once) and its
# tangent B1 three times at B ndx (qM, H, the Euler system). The UKF runs
# forward and step once each over its 2 ndx + 1 sigma points.
EKF_LAUNCHES = {'chol_solve': 8, 'newton': 2}
UKF_LAUNCHES = {'chol_solve': 3, 'newton': 2}
SENSOR_ATOL = 1e-4         # phase 27: card vs CPU sensordata
SENSOR_MODEL_TOL = 1e-3    # 27, the sensor models: |card - CPU| / max(1,
                           # |CPU|), float32 both
STATE_TOL = 1e-3           # 28-29: |qpos, qvel card - CPU| / max(1, |CPU|)
COV_TOL = 1e-2             # 28-29: |P card - P CPU| / max |P CPU|
TRACK_TOL = 0.02           # 28-29: trunk position error after the updates
BATCH_WINDOW = 32          # phase 30's window (configurations)
BATCH_ITERS = 3            # its Gauss-Newton iterations an update
BATCH_UPDATES = 3          # updates timed
BATCH_COST_TOL = 1e-3      # 30: final cost, relative, card vs CPU
BATCH_Z_TOL = 1e-2         # 30: |z card - z CPU| / max |z CPU|


def estimator_truth(spec, steps, seed):
  """The truth on the card: `steps` + 1 states of Quadruped Flat from
  `home` at rest under the home controls plus 0.1 sin(2 pi t / 0.4) on
  every actuator, with each state's sensordata (all 45 columns), applied
  forces (actuator plus constraint: what inverse dynamics gives back) and
  time; measurements with numpy noise (seed) of std EST_NOISE."""
  import numpy as np
  import torch
  from mujoco_mpc_tpu_torch.physics import forward as fwd
  from mujoco_mpc_tpu_torch.physics import sensors
  from mujoco_mpc_tpu_torch.physics.model import make_data
  m = spec.model
  home = m.key_ctrl[m.keyframe_names.index('home')]
  d = make_data(m).replace(qpos=m.keyframe_qpos('home')[None].clone())
  out = {k: [] for k in ('qpos', 'qvel', 'ctrl', 'sensor', 'force', 'time')}
  for t in range(steps + 1):
    u = home + 0.1 * np.sin(2 * np.pi * t * float(m.opt.timestep) / 0.4)
    d = d.replace(ctrl=u[None])
    df = fwd.forward(m, d)
    for k, v in (('qpos', d.qpos), ('qvel', d.qvel), ('ctrl', d.ctrl),
                 ('sensor', sensors.sensordata(m, df)),
                 ('force', df.qfrc_actuator + df.qfrc_constraint),
                 ('time', d.time)):
      out[k].append(v[0])
    d = fwd.integrate(m, df)
  out = {k: torch.stack(v) for k, v in out.items()}
  rng = np.random.default_rng(seed)
  out['meas'] = out['sensor'] + torch.tensor(
      EST_NOISE * rng.normal(size=tuple(out['sensor'].shape)),
      dtype=out['sensor'].dtype, device=DEV)
  return out


def filter_start(spec, truth, seed):
  """The filters' first state: the truth's first, 1e-2 off in every
  tangent direction and EST_START_OFFSET off in the trunk's position
  (numpy noise, seed); init_state's covariance and noise."""
  import numpy as np
  import torch
  from mujoco_mpc_tpu_torch.estimators import base
  m = spec.model
  dx = 1e-2 * np.random.default_rng(seed).normal(size=(1, base.ndx(m)))
  dx[0, :3] = EST_START_OFFSET
  s = base.init_state(m)
  qp, qv, a = base.perturb(m, truth['qpos'][:1], truth['qvel'][:1],
                           s.act, torch.tensor(dx, dtype=m.dtype, device=DEV))
  return s.replace(qpos=qp, qvel=qv, act=a, time=truth['time'][:1])


class capture_operands(record_batches):
  """record_batches with each call's operands (`calls`: [('chol_solve' or
  'newton', args cloned, kwargs), ...])."""

  def _record(self, kind, args, kw):
    return kind, tuple(x.clone() for x in args), kw


def estimator_kernel_inputs(spec, truth, start):
  """The kernels' operands in one EKF and one UKF update from `start`:
  {(kind, filter, B): (args, kwargs)}, the first call of each kind and
  batch."""
  from mujoco_mpc_tpu_torch.estimators import kalman, unscented
  from mujoco_mpc_tpu_torch.physics.model import make_data
  tmpl = make_data(spec.model)
  out = {}
  for name, update in (('ekf', kalman.update), ('ukf', unscented.update)):
    with capture_operands() as cap:
      update(spec.model, tmpl, start, truth['ctrl'][:1], truth['meas'][:1])
    for kind, args, kw in cap.calls:
      out.setdefault((kind, name, args[1].shape[0]), (args, kw))
  return out


def check_estimator_kernels(inputs):
  """Both kernels against their plain versions on the estimators'
  operands: B1 within 1e-4 relative, B2 by phase 3d's rule for dense
  problems (a sample outside rtol 2e-3/atol 1e-3 must be an f32 near tie,
  relative cost gap <= 1e-5). Returns {(kind, filter, B): max abs error}."""
  errs = {}
  for key, (args, kw) in sorted(inputs.items()):
    kind, name, bsz = key
    if kind == 'chol_solve':
      errs[key], rel = check_spd_inputs(args, 1e-4, f'{name} B {bsz}')
      line = f'chol_solve n {args[0].shape[-1]} rel err {rel:.3g} (tol 1e-4)'
    else:
      nbad, gap, errs[key], bad_gap = compare_newton(
          args[:10], args[10:], **kw)
      newton_ok(f'{name} inputs', bsz, nbad, gap, bad_gap, share=False)
      line = (f'newton nv {args[1].shape[1]} {args[2].shape[1]} dense '
              f'{args[6].shape[1]} one-hot condims {kw["condims"]}: '
              + newton_line(nbad, bsz, gap, bad_gap, share=False))
    print(f'phase 3m Quadruped {name.upper()} update\'s {kind} inputs at B '
          f'{bsz}: {line}')
  return errs


def time_estimator_kernels(inputs, kern):
  """Phase 4's estimator rows: B1 at the EKF's B 1 and B ndx (its
  tangents) and the UKF's B 2 ndx + 1, B2 at the EKF's B 1 and the UKF's
  B 2 ndx + 1, each with its plain version and bound (B1 with the library
  call). Fills kern['quadruped_ekf'] (B 1; B1's tangent under 'tangent')
  and kern['quadruped_ukf']."""
  for name in ('ekf', 'ukf'):
    keys = sorted(k for k in inputs if k[1] == name)
    for kind, _, bsz in keys:
      args, kw = inputs[(kind, name, bsz)]
      if kind == 'chol_solve':
        wall, dev, bound_, plain_reps = time_spd(args, PLAIN_REPS)
        rec = dict(wall=wall, dev=dev, spd_bound=bound_, newton_bound=None)
        line = spd_timing_line(wall, dev, bound_, plain_reps, args[0])
      else:
        wall, dev, bound_, iters = time_newton(args[:10], args[10:], kw,
                                               PLAIN_REPS)
        rec = dict(wall=wall, dev=dev, newton_bound=bound_)
        line = newton_timing_line(
            f'B {bsz} nv {args[1].shape[1]} ns {args[6].shape[1]} condims '
            f'{kw["condims"]} cap {kw["cap"]}', wall, dev, bound_, iters,
            PLAIN_REPS)
      print(f'phase 4 timing quadruped_{name} per call, wall / device only: '
            + line)
      path = kern.setdefault(f'quadruped_{name}', dict(wall={}, dev={}))
      if name == 'ekf' and bsz > 1:
        path['tangent'] = dict(rec, newton_bound=None)
      else:
        path['wall'].update(rec['wall'])
        path['dev'].update(rec['dev'])
        for b in ('spd_bound', 'newton_bound'):
          if rec.get(b):
            path[b] = rec[b]


def check_sensors(spec, cpu_spec, gen):
  """Phase 27: sensordata of phase 3e's task-shaped states (B 4096) after
  forward on the card, against the CPU plain path's: max abs error."""
  import torch
  from mujoco_mpc_tpu_torch.physics import forward as fwd
  from mujoco_mpc_tpu_torch.physics import sensors
  from mujoco_mpc_tpu_torch.physics.model import make_data
  d = quadruped_states(spec, gen)
  got = sensors.sensordata(spec.model, fwd.forward(spec.model, d))
  m = cpu_spec.model
  dc = make_data(m, d.batch).replace(qpos=d.qpos.cpu(), qvel=d.qvel.cpu(),
                                     ctrl=d.ctrl.cpu())
  want = sensors.sensordata(m, fwd.forward(m, dc))
  err = float(torch.max(torch.abs(got.cpu() - want)))
  check(bool(torch.isfinite(got).all()), 'sensordata not finite')
  check(err <= SENSOR_ATOL, f'sensordata card vs CPU {err:.3g} > '
        f'{SENSOR_ATOL:g}')
  print(f'phase 27 sensors: Quadruped Flat sensordata ({m.nsensordata} '
        f'columns, {len(m.sensor_type)} sensors, the USER ones zero) of '
        f'B {d.batch} task-shaped states after forward, card vs CPU plain '
        f'path: max abs err {err:.3g} (tol {SENSOR_ATOL:g})')
  return err


def load_sensor_models(device):
  """{name: (Model, Data of its states)} from assets/sensor_models.npz
  (tools/export_torch_snapshot.py --sensor-models), float32."""
  import numpy as np
  import torch
  from mujoco_mpc_tpu_torch.physics import model as model_lib
  from mujoco_mpc_tpu_torch.tasks import registry
  out = {}
  with np.load(os.path.join(registry.ASSETS, 'sensor_models.npz'),
               allow_pickle=False) as z:
    for name in sorted({k.split('/')[0] for k in z.files}):
      pre = f'{name}/model/'
      m = model_lib.from_arrays(
          {k[len(pre):]: z[k] for k in z.files if k.startswith(pre)},
          json.loads(str(z[f'{name}/static'])), device=device,
          dtype=torch.float32)
      st = {k: torch.tensor(z[f'{name}/{k}'], dtype=torch.float32,
                            device=device)
            for k in ('qpos', 'qvel', 'ctrl', 'time')}
      out[name] = m, model_lib.make_data(m, st['qpos'].shape[0]).replace(**st)
  return out


def check_sensor_models():
  """Phase 27's other half: every sensor type the port evaluates beside
  Quadruped Flat's (joint, frame, gyro, velocimeter, accelerometer,
  magnetometer, subtree, actuator, clock, force, torque, touch through
  contact_forces, rangefinder through raycast) on the models of
  tests/test_torch_sensors.py, each with its 64 MuJoCo-made states as one
  batch: forward and sensordata on the card against the CPU plain path,
  |card - CPU| <= SENSOR_MODEL_TOL max(1, |CPU|). Returns the largest
  such error."""
  import torch
  from mujoco_mpc_tpu_torch.physics import forward as fwd
  from mujoco_mpc_tpu_torch.physics import sensors
  card, cpu = load_sensor_models(DEV), load_sensor_models('cpu')
  worst = 0.0
  for name in card:
    got = sensors.sensordata(card[name][0], fwd.forward(*card[name])).cpu()
    want = sensors.sensordata(cpu[name][0], fwd.forward(*cpu[name]))
    check(bool(torch.isfinite(got).all()), f'{name} sensordata not finite')
    err = float(torch.max(torch.abs(got - want)
                          / torch.clamp(torch.abs(want), min=1.0)))
    check(err <= SENSOR_MODEL_TOL, f'{name} sensordata card vs CPU {err:.3g}'
          f' > {SENSOR_MODEL_TOL:g}')
    types = sorted(set(int(t) for t in card[name][0].sensor_type))
    print(f'phase 27 sensors: model {name!r} (sensor types {types}, '
          f'{want.shape[1]} columns), B {want.shape[0]}, card vs CPU plain '
          f'path: max err / max(1, |CPU|) {err:.3g} (tol '
          f'{SENSOR_MODEL_TOL:g})')
    worst = max(worst, err)
  return worst


def _launch_counts():
  from mujoco_mpc_tpu_torch.ops import newton, spd_solve
  return {'chol_solve': spd_solve.solve_spd.launches,
          'newton': newton.newton.launches}


def _reset_counts():
  from mujoco_mpc_tpu_torch.ops import newton, spd_solve
  spd_solve.solve_spd.launches = newton.newton.launches = 0


def _to_cpu(state):
  return state.replace(**{f: getattr(state, f).cpu() for f in (
      'qpos', 'qvel', 'act', 'time', 'covariance', 'noise_process',
      'noise_sensor')})


def filter_phase(phase, name, update, spec, cpu_spec, truth, start,
                 predicted):
  """Phases 28-29: one update on the card against the CPU plain path from
  the same state and inputs (qpos and qvel within STATE_TOL of max(1,
  |x|), the covariance within COV_TOL of its largest entry); then
  EST_UPDATES updates along the truth, each timed (p50), the kernels'
  launches counted over them (reset just before, read just after) against
  the prediction, two more updates profiled (the device's trace only) for
  the busy share, and the
  trunk position within TRACK_TOL of the truth at the end. Returns the
  record."""
  import torch
  from mujoco_mpc_tpu_torch.physics.model import make_data
  m = spec.model
  tmpl, tmpl_cpu = make_data(m), make_data(cpu_spec.model)
  u0, y0 = truth['ctrl'][:1], truth['meas'][:1]
  got = update(m, tmpl, start, u0, y0)
  want = update(cpu_spec.model, tmpl_cpu, _to_cpu(start), u0.cpu(),
                y0.cpu())
  state_err = max(float(torch.max(torch.abs(getattr(got, f).cpu()
                                            - getattr(want, f))
                                  / torch.clamp(torch.abs(getattr(want, f)),
                                                min=1.0)))
                  for f in ('qpos', 'qvel'))
  cov_err = float(torch.max(torch.abs(got.covariance.cpu()
                                      - want.covariance))
                  / torch.max(torch.abs(want.covariance)))
  check(state_err <= STATE_TOL, f'{name} card vs CPU state {state_err:.3g}')
  check(cov_err <= COV_TOL, f'{name} card vs CPU covariance {cov_err:.3g}')

  state, times = start, []
  err0 = float(torch.max(torch.abs(start.qpos[0, :3] - truth['qpos'][0, :3])))
  _reset_counts()
  with record_batches() as rec:
    for t in range(EST_UPDATES):
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      state = update(m, tmpl, state, truth['ctrl'][t:t + 1],
                     truth['meas'][t:t + 1])
      torch.cuda.synchronize()
      times.append(time.perf_counter() - t0)
  launches = _launch_counts()
  batches = {}
  for key in rec.calls:
    batches[key] = batches.get(key, 0) + 1
  per = {k: v / EST_UPDATES for k, v in launches.items()}
  check(per == {k: float(v) for k, v in predicted.items()},
        f'{name} launches an update {per} != predicted {predicted}')
  check(bool(torch.isfinite(state.covariance).all()
             and torch.isfinite(state.qpos).all()), f'{name} not finite')
  # the state after t updates estimates the truth's state t (each update
  # corrects at state t, then steps to t + 1)
  err = float(torch.max(torch.abs(state.qpos[0, :3]
                                  - truth['qpos'][EST_UPDATES, :3])))
  check(err <= TRACK_TOL and err < err0, f'{name} trunk position error '
        f'{err:.3g} after {EST_UPDATES} updates (tol {TRACK_TOL:g}, start '
        f'{err0:.3g})')
  p50 = statistics.median(times) * 1e3
  dev_us = device_us(lambda: update(m, tmpl, state, truth['ctrl'][:1],
                                    truth['meas'][:1]), reps=2, host=False)
  busy = dev_us / (p50 * 1e3)
  print(f'phase {phase} {name.upper()}: Quadruped Flat, all '
        f'{m.nsensordata} sensordata columns, ndx {2 * m.nv + m.na}: one '
        f'update card vs CPU plain path: qpos/qvel rel err {state_err:.3g} '
        f'(tol {STATE_TOL:g}), covariance rel err {cov_err:.3g} (tol '
        f'{COV_TOL:g}); {EST_UPDATES} updates along the truth: p50 '
        f'{p50:.2f} ms (min {min(times) * 1e3:.2f}, max '
        f'{max(times) * 1e3:.2f}), launches an update chol_solve '
        f'{per["chol_solve"]:g}, newton {per["newton"]:g} (predicted '
        f'{predicted["chol_solve"]}, {predicted["newton"]}; by kernel and '
        f'B: {sorted(batches.items())}); device busy '
        f'{busy:.3f} of the p50 ({dev_us / 1e3:.2f} ms device time an '
        f'update, profiled); trunk position error {err0:.3g} m at the start,'
        f' {err:.3g} m after {EST_UPDATES} updates (tol {TRACK_TOL:g})')
  return dict(launches=launches, per_update=per, p50_ms=p50, busy=busy,
              state_err=state_err, cov_err=cov_err, track_err=err,
              updates=EST_UPDATES, batches=batches)


def batch_inputs(spec, truth, seed):
  """Phase 30's window, in the dtype of `spec`: BATCH_WINDOW
  configurations of the truth 1e-3 off in every tangent direction (numpy,
  seed), its measurements, applied forces and times, and the next
  measurement."""
  import numpy as np
  import torch
  from mujoco_mpc_tpu_torch.physics import forward as fwd
  m, t = spec.model, BATCH_WINDOW
  tr = {k: v.to(m.dtype) for k, v in truth.items()}
  dz = torch.tensor(1e-3 * np.random.default_rng(seed).normal(
      size=(t, m.nv)), dtype=m.dtype, device=DEV)
  return dict(qpos=fwd.integrate_pos(m, tr['qpos'][:t], dz, 1.0),
              sensor=tr['meas'][:t], force=tr['force'][:t],
              times=tr['time'][:t], next=(tr['meas'][t], tr['force'][t],
                                          tr['time'][t]))


def batch_update(spec, win, device):
  """One batch-estimator update (BATCH_WINDOW, BATCH_ITERS Gauss-Newton
  iterations, sensor weight 1 / EST_NOISE^2) on `device`: (state, info,
  z the window's displacement from its shifted reference, the cost at
  that reference)."""
  import torch
  from mujoco_mpc_tpu_torch.estimators import batch, direct
  from mujoco_mpc_tpu_torch.physics import support
  from mujoco_mpc_tpu_torch.physics.model import make_data
  m = spec.model
  p = direct.make_problem(m, make_data(m), BATCH_WINDOW)
  s = direct.default_settings(p).replace(
      sensor_weight=torch.full((p.sensor_dim,), EST_NOISE ** -2,
                               dtype=m.dtype, device=m.device),
      max_iterations=BATCH_ITERS)
  st = batch.init_state(p).replace(
      qpos_window=win['qpos'].to(device),
      sensor_window=win['sensor'].to(device),
      force_window=win['force'].to(device), times=win['times'].to(device))
  new, info = batch.update(p, st, s, *(x.to(device) for x in win['next']),
                           torch.tensor(float(m.opt.timestep),
                                        device=device))
  ref = torch.cat([st.qpos_window[1:], st.qpos_window[-1:]])
  shifted = direct.DirectData(
      qpos_ref=ref, sensor_meas=new.sensor_window,
      force_meas=new.force_window, times=new.times)
  c0 = direct.cost(p, shifted, torch.zeros_like(ref[:, :m.nv]).reshape(-1),
                   s, torch.zeros_like(ref[:, :m.nv]).reshape(-1),
                   st.prior_diag, st.prior_off1)
  return new, info, support.state_diff(m, ref, new.qpos_window), c0


def batch_phase(truth, seed):
  """Phase 30: the batch estimator's update on the card against the CPU
  plain path (final cost within BATCH_COST_TOL relative, z within
  BATCH_Z_TOL of its largest entry; the cost must fall), then
  BATCH_UPDATES timed (p50) with the kernels' launches counted (none:
  inverse dynamics solves nothing). In float64 on both: the window's
  Gauss-Newton system (force rows ~M / h^2 beside a unit prior) does not
  factor in float32, and no iteration improves, in the port and in the
  JAX package's float32 default alike
  (tests/test_torch_batch_float32.py). The float32 update runs too, card
  against CPU (cost trace within BATCH_COST_TOL relative), so that the
  card's float32 path is exercised; no kernel is on this path."""
  import torch
  from mujoco_mpc_tpu_torch.tasks import registry
  f32 = {dev: registry.get_task('Quadruped Flat', device=dev)
         for dev in (DEV, 'cpu')}
  win32 = batch_inputs(f32[DEV], truth, seed)
  tr32 = {dev: batch_update(f32[dev], win32, dev)[1]['cost_trace'].cpu()
          for dev in (DEV, 'cpu')}
  err32 = float(torch.max(torch.abs(tr32[DEV] - tr32['cpu'])
                          / torch.abs(tr32['cpu'])))
  check(bool(torch.isfinite(tr32[DEV]).all()), 'float32 batch cost not finite')
  check(err32 <= BATCH_COST_TOL, f'float32 batch cost trace card vs CPU '
        f'{err32:.3g}')
  spec = registry.get_task('Quadruped Flat', device=DEV, dtype=torch.float64)
  cpu_spec = registry.get_task('Quadruped Flat', device='cpu',
                               dtype=torch.float64)
  win = batch_inputs(spec, truth, seed)
  _, info, z, cost0 = batch_update(spec, win, DEV)
  _, info_c, z_c, _ = batch_update(cpu_spec, win, 'cpu')
  c, c_c = float(info['final_cost']), float(info_c['final_cost'])
  cost_err = abs(c - c_c) / max(abs(c_c), 1e-30)
  z_err = float(torch.max(torch.abs(z.cpu() - z_c))
                / torch.max(torch.abs(z_c)))
  check(cost_err <= BATCH_COST_TOL, f'batch cost card vs CPU {cost_err:.3g}')
  check(z_err <= BATCH_Z_TOL, f'batch z card vs CPU {z_err:.3g}')
  cost0 = float(cost0)
  check(float(info['final_cost']) < cost0, 'batch cost did not fall')
  times = []
  _reset_counts()
  for _ in range(BATCH_UPDATES):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch_update(spec, win, DEV)
    torch.cuda.synchronize()
    times.append(time.perf_counter() - t0)
  launches = _launch_counts()
  p50 = statistics.median(times) * 1e3
  print(f'phase 30 batch estimator: Quadruped Flat, a window of '
        f'{BATCH_WINDOW} configurations, {BATCH_ITERS} Gauss-Newton '
        f'iterations, all {spec.model.nsensordata} sensordata columns, '
        f'float64: '
        f'card vs CPU plain path final cost {c:.6g} vs {c_c:.6g}: rel err '
        f'{cost_err:.3g} (tol {BATCH_COST_TOL:g}), z rel err {z_err:.3g} '
        f'(tol {BATCH_Z_TOL:g}); cost {cost0:.6g} at the reference, then '
        f'{[float(x) for x in info["cost_trace"]]}; update p50 '
        f'{p50:.1f} ms over {BATCH_UPDATES} (min {min(times) * 1e3:.1f}, '
        f'max {max(times) * 1e3:.1f}); kernel launches {launches} (inverse '
        f'dynamics launches none)')
  print(f'phase 30 batch estimator in float32 (the same window): cost '
        f'trace card {tr32[DEV].tolist()}, CPU {tr32["cpu"].tolist()}: rel '
        f'err {err32:.3g} (tol {BATCH_COST_TOL:g})')
  return dict(p50_ms=p50, cost_err=cost_err, z_err=z_err,
              launches=launches, cost_err32=err32)


def estimator_phases(spec, cpu_spec, gen, elapsed, truth, start):
  """Phases 27-30 on Quadruped Flat (and 27 on the sensor models).
  Returns {'sensor_err', 'sensor_model_err', 'ekf', 'ukf', 'batch'}."""
  from mujoco_mpc_tpu_torch.estimators import kalman, unscented
  out = {'sensor_err': check_sensors(spec, cpu_spec, gen),
         'sensor_model_err': check_sensor_models()}
  elapsed('27')
  for phase, name, update, predicted in (
      (28, 'ekf', kalman.update, EKF_LAUNCHES),
      (29, 'ukf', unscented.update, UKF_LAUNCHES)):
    out[name] = filter_phase(phase, name, update, spec, cpu_spec, truth,
                             start, predicted)
    elapsed(str(phase))
  out['batch'] = batch_phase(truth, 21)
  elapsed('30')
  return out


# ---------------------------------------------------------------------------
# The manipulation tasks on the sphere-box pair (phases 3n, their rows in
# phase 4, 31-37): FreeFingers, Panda, Panda Bring, Bimanual Handover and
# Bimanual Reorient, each at its own planner settings
# ---------------------------------------------------------------------------


def own_settings(spec):
  """A task's own planner settings from its MJCF numerics: (candidates,
  horizon steps, spline points)."""
  from mujoco_mpc_tpu_torch import agent
  cfg = spec.config
  return (int(cfg['sampling_trajectories']), agent.horizon_steps(spec),
          int(cfg['sampling_spline_points']))


def manipulation_states(spec, gen, bsz):
  """bsz states of a manipulation task: the first MANIP_FLOOR at qpos0
  with the object's box 1 mm into the floor, at rest; the others with the
  arm joints uniform in their ranges, velocities normal (scale 0.1),
  controls uniform in their ranges, and the object (the free joint, the
  first) against a fingertip sphere of a sphere-box pair drawn per sample:
  the sphere 0-3 mm into a side or the top face of the box near its
  middle, or (a quarter of them) its centre 1-4 mm inside the box (the
  collider's deep branch), the box turned about z at random. Where that
  puts the box into the floor, its corners come in too."""
  import math
  import torch
  from mujoco_mpc_tpu_torch.physics import kinematics as kin
  from mujoco_mpc_tpu_torch.physics.model import GeomType, make_data
  m, b = spec.model, bsz
  u = lambda *s: torch.rand(s, generator=gen, device=DEV)  # noqa: E731
  pairs = [p for p in m.collision_pairs
           if (m.geom_type[p[0]], m.geom_type[p[1]]) == (GeomType.SPHERE,
                                                         GeomType.BOX)]
  tips = torch.tensor([p[0] for p in pairs], device=DEV)
  h = m.geom_size[pairs[0][1]]
  qpos = m.qpos0.expand(b, -1).clone()
  lo, hi = m.jnt_range[1:, 0], m.jnt_range[1:, 1]
  qpos[:, 7:] = lo + (hi - lo) * u(b, m.nq - 7)
  tip = tips[torch.randint(len(pairs), (b,), generator=gen, device=DEV)]
  rows = torch.arange(b, device=DEV)
  p = kin.kinematics(m, make_data(m, b).replace(qpos=qpos)).geom_xpos[rows,
                                                                      tip]
  r = m.geom_size[tip, 0]
  yaw = (2 * u(b) - 1) * math.pi
  c, s = torch.cos(yaw), torch.sin(yaw)
  z, o = torch.zeros_like(yaw), torch.ones_like(yaw)
  rot = torch.stack([c, -s, z, s, c, z, z, z, o], -1).reshape(b, 3, 3)
  k = torch.randint(3, (b,), generator=gen, device=DEV)
  sign = torch.where((k == 2) | (u(b) < 0.5), 1.0, -1.0)
  local = (u(b, 3) - 0.5) * h
  deep = u(b) < 0.25
  depth_k = torch.where(deep, h[k] - 0.001 - 0.003 * u(b),
                        h[k] + r - 0.003 * u(b))
  local[rows, k] = sign * depth_k
  qpos[:, :3] = p - torch.einsum('bij,bj->bi', rot, local)
  qpos[:, 3:7] = torch.stack([torch.cos(yaw / 2), z, z, torch.sin(yaw / 2)],
                             -1)
  clo, chi = m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1]
  qvel = 0.1 * torch.randn((b, m.nv), generator=gen, device=DEV)
  ctrl = clo + (chi - clo) * u(b, m.nu)
  rest = slice(0, MANIP_FLOOR)
  qpos[rest] = m.qpos0
  qpos[rest, 2] = h[2] - 0.001
  qvel[rest], ctrl[rest] = 0.0, 0.0
  return make_data(m, b).replace(qpos=qpos, qvel=qvel, ctrl=ctrl)


def check_primitive_points(spec, cpu_spec, d):
  """Phase 3n's contact points: those the card's step stacks from states
  d (plane-box corners, then each sphere-box point) against the same step
  on the CPU through the plain path, float32 both. Every depth agrees
  within POINT_ATOL (continuous through the deep branch's ties); a
  position or normal may differ only where the sphere's centre sits within
  rounding of a tie between two axes of least depth or of the box's
  surface, at most 0.1% of the points. Returns the line's text."""
  import torch
  from mujoco_mpc_tpu_torch.physics import forward as fwd
  from mujoco_mpc_tpu_torch.physics.model import GeomType
  card = [x.cpu() for x in stacked_points(spec, fwd.fwd_position(spec.model,
                                                                 d))]
  cpu_d = to_cpu(d)
  cpu = stacked_points(cpu_spec, fwd.fwd_position(cpu_spec.model, cpu_d))
  dist_err = float(torch.max(torch.abs(card[0] - cpu[0])))
  check(dist_err <= POINT_ATOL, f'contact depths, card vs CPU: '
        f'{dist_err:.3g} > {POINT_ATOL:g}')
  pos_err = torch.amax(torch.abs(card[1] - cpu[1]), -1)
  normal_err = torch.amax(torch.abs(card[2] - cpu[2]), -1)
  off = (pos_err > POINT_ATOL) | (normal_err > NORMAL_ATOL)
  n_off = int(off.sum())
  check(n_off <= off.numel() // 1000, f'contact points, card vs CPU: '
        f'{n_off} of {off.numel()} differ, more than 0.1%')
  m = cpu_spec.model
  radii = torch.stack([m.geom_size[g1, 0] for g1, _ in m.collision_pairs
                       if m.geom_type[g1] == GeomType.SPHERE])
  sphere = cpu[0][:, -len(radii):]       # the sphere-box pairs' points
  contact, deep = sphere < 0, sphere < -radii
  return (f'{off.shape[1]} points a sample ({int(contact.sum())} sphere-box '
          f'points in contact, {int(deep.sum())} of them with the centre '
          f'inside the box), depths max abs err {dist_err:.3g} (tol '
          f'{POINT_ATOL:g}); positions {float(pos_err.max()):.3g} and '
          f'normals {float(normal_err.max()):.3g} max abs err (tol '
          f'{POINT_ATOL:g}, {NORMAL_ATOL:g}) at all but {n_off} of '
          f'{off.numel()} points (near ties, bound 0.1%)')


def check_manipulation_kernels(spec, cpu_spec, gen):
  """Phase 3n for one task: both kernels on the inputs its step gives them
  at MANIP_STATES manipulation_states (B1 on qM and the Euler system
  within 1e-4 relative, B2 by phase 3e's rule), and its contact points
  card vs CPU. Returns the states."""
  m = spec.model
  states = manipulation_states(spec, gen, MANIP_STATES)
  spd_in, (args, gargs, condims, dmasks) = solver_inputs(spec, states)
  _, spd_err = check_spd_inputs(spd_in, 1e-4, spec.name)
  _, euler_err = check_spd_inputs(euler_inputs(spec, states), 1e-4,
                                  spec.name + ' Euler')
  kw = dict(cap=m.opt.iterations, tol=1e-5, condims=condims, dmasks=dmasks)
  _, line = check_newton_task(spec.name, args, gargs, kw)
  print(f'phase 3n {spec.name} step inputs (B {MANIP_STATES}, the first '
        f'{MANIP_FLOOR} at qpos0 on the floor, the rest a fingertip against '
        f'the object; condims {condims}, P {gargs[1].shape[1]}, ns '
        f'{args[6].shape[1]}): chol_solve n {m.nv} rel err qM '
        f'{spd_err:.3g}, Euler system {euler_err:.3g} (tol 1e-4); {line}')
  print(f'phase 3n {spec.name} contact points, card vs the CPU plain path: '
        + check_primitive_points(spec, cpu_spec, states))
  return states


def manipulation_kernels(spec, states, bsz, kern, path, share=True):
  """Phase 4's rows of a manipulation path: both kernels on the step
  inputs of bsz of phase 3n's states (its rollouts' batch), checked
  against their plain versions (B2 with `share` as newton_ok takes it)
  and timed with their bounds (path_kernels); fills kern[path] and
  returns the (B1, B2) max abs errors."""
  m = spec.model
  spd_in, (args, gargs, condims, dmasks) = solver_inputs(
      spec, batch_of(states, bsz))
  kern[path], errs = path_kernels(
      f'4 {path} (B {bsz}, one condim-3 group P {gargs[1].shape[1]})',
      spd_in, args, gargs, dict(cap=m.opt.iterations, tol=1e-5,
                                condims=condims, dmasks=dmasks), 1e-4,
      share=share)
  return errs[:2]


def manipulation_timing(specs, states, kern):
  """Phase 4's rows of the manipulation paths (manipulation_kernels) at
  their three shapes, each task's rollout batch: FreeFingers (B 65, nv
  12, P 10), Panda (B 97, nv 15, P 10; Panda Bring's model is Panda's,
  and its row Panda's) and Bimanual Handover (B 97, nv 18, P 12;
  Reorient's row Handover's: the same arms and object), and Handover at
  MANIP_WIDE + 1. Fills `kern` for every path; returns their (B1, B2) max
  abs errors."""
  errs = {}
  for n in ('FreeFingers', 'Panda', 'Bimanual Handover'):
    errs[manip_path(n)] = manipulation_kernels(
        specs[n], states[n], own_settings(specs[n])[0] + 1, kern,
        manip_path(n))
  for n, same in (('Panda Bring', 'Panda'),
                  ('Bimanual Reorient', 'Bimanual Handover')):
    kern[manip_path(n)] = kern[manip_path(same)]
    errs[manip_path(n)] = errs[manip_path(same)]
  errs[MANIP_WIDE_PATH] = manipulation_kernels(
      specs['Bimanual Handover'], states['Bimanual Handover'],
      MANIP_WIDE + 1, kern, MANIP_WIDE_PATH)
  return errs


def manipulation_phases(specs, cpu_specs, gen, elapsed):
  """Phases 31-37 from the five tasks' specs (card and CPU): each task's
  main path at its own candidates x horizon and knots from qpos0 with its
  launches as predicted (2 T B1, T B2 a plan), and its card-vs-CPU golden
  at its own candidates with phase 9's bounds (31-35); Bimanual
  Handover's plan-act loop (36) and its plan at 4096 candidates (37,
  timed, no golden). Returns
  ({path: main path record}, {path: golden best_return rel err})."""
  from mujoco_mpc_tpu_torch.physics.model import make_data
  main, rel_err = {}, {}
  for phase, name in enumerate(MANIP_TASKS, 31):
    spec, cpu_spec = specs[name], cpu_specs[name]
    samples, _, points = own_settings(spec)
    d0 = make_data(spec.model)
    r = main_path(spec, d0, samples, MANIP_PLANS, gen, points)
    print_main_path(phase, name, samples, MANIP_PLANS, r)
    br_gpu, br_cpu, rel, win_gpu, win_cpu, drift = golden(
        spec, cpu_spec, d0, make_data(cpu_spec.model), gen, 0.2, samples,
        points)
    print(f'phase {phase} golden: {name} {samples}-candidate plan '
          f'({points} knots) best_return card {br_gpu:.6g} vs CPU plain '
          f'{br_cpu:.6g}: rel err {rel:.3g} (tol 0.02); winner card '
          f'{win_gpu} vs CPU {win_cpu} (match {win_gpu == win_cpu}); 5-step '
          f'rollout qpos drift {drift:.3g} (tol 0.05)')
    main[manip_path(name)], rel_err[manip_path(name)] = r, rel
    elapsed(str(phase))
  hand = specs['Bimanual Handover']
  samples, _, points = own_settings(hand)
  d0 = make_data(hand.model)
  steps, sim_t, wall, rtf, mean, last = plan_act(hand, d0, samples,
                                                 PLAN_ACT_STEPS, 5)
  print(f'phase 36 plan-act: Bimanual Handover {steps} steps ({sim_t:.2f} s '
        f'simulated, {steps // 4} plans of 4 steps, {samples} candidates, '
        f'transition on) in {wall:.2f} s wall: real-time factor {rtf:.3f}; '
        f'mean cost {mean:.4g}, last {last:.4g}')
  elapsed('36')
  r = main_path(hand, d0, MANIP_WIDE, MANIP_WIDE_PLANS, gen, points)
  print_main_path(37, 'Bimanual Handover', MANIP_WIDE, MANIP_WIDE_PLANS, r)
  main[MANIP_WIDE_PATH] = r
  elapsed('37')
  return main, rel_err


def manip_path(name):
  return name.lower().replace(' ', '_')


# ---------------------------------------------------------------------------
# The tasks of the box-box, capsule-box and capsule-capsule pairs: Walker,
# Bimanual Insert, Allegro Cube, Humanoid Interact (phases 3o, 38-43, and
# their rows in phase 4)
# ---------------------------------------------------------------------------


def geoms_named(m, part):
  return [g for g, n in enumerate(m.geom_names) if part in n]


def lowest_z(m, d, geoms):
  """The lowest world z (B, k) of the sphere, capsule or box geoms (B, k)
  in states d after their kinematics."""
  import torch
  from mujoco_mpc_tpu_torch.physics.model import GeomType
  rows = torch.arange(d.qpos.shape[0], device=d.qpos.device)[:, None]
  z = d.geom_xpos[rows, geoms, 2]
  mat = d.geom_xmat[rows, geoms]
  size = m.geom_size[geoms]
  gtype = torch.tensor(m.geom_type, device=d.qpos.device)[geoms]
  box = z - torch.sum(size * torch.abs(mat[..., 2, :]), -1)
  cap = z - size[..., 1] * torch.abs(mat[..., 2, 2]) - size[..., 0]
  return torch.where(gtype == GeomType.BOX, box, torch.where(
      gtype == GeomType.CAPSULE, cap, z - size[..., 0]))


def yaw_quats(yaw):
  import torch
  z = torch.zeros_like(yaw)
  return torch.stack([torch.cos(yaw / 2), z, z, torch.sin(yaw / 2)], -1)


def box_states(spec, gen, bsz):
  """bsz states of a box-pair task: the first BOX_QPOS0 at qpos0 at rest
  (Walker and Humanoid Interact lowered until their lowest geom is 1 mm
  into the floor, Allegro Cube's cube 1 mm into the palm: aligned boxes
  and, in Walker, parallel legs); the others with every limited joint
  uniform in its range, velocities normal (scale 0.1), controls uniform
  in their ranges, and placed against the task's new pairs: Walker
  pitched by up to 0.4 rad, its lowest capsule 0-3 mm into the floor;
  Bimanual Insert's peg half upright and turned by up to 0.5 rad about z,
  pressed 0-3 mm into a socket wall's inner face, half in a random
  orientation over the socket, 0-3 mm below the walls' tops; Allegro
  Cube's cube in a random orientation, a third 0-3 mm into the palm, the
  rest against a finger capsule 0-3 mm into a face or (half of them)
  across an edge, unless a digit is then more than 5 mm in (then onto
  the palm, the digits as at qpos0); Humanoid Interact turned about z at
  random, its pelvis, a shin or a foot 0-3 mm into the top of the seat
  near its middle, unless a geom is then more than 5 mm into the floor or
  the seat (then 1.5 m from the chair, its lowest geom 0-3 mm into the
  floor)."""
  import math
  import torch
  from mujoco_mpc_tpu_torch.physics import kinematics as kin
  from mujoco_mpc_tpu_torch.physics.model import GeomType, make_data
  from mujoco_mpc_tpu_torch.utils import math as tm
  m, b, name = spec.model, bsz, spec.name
  u = lambda *s: torch.rand(s, generator=gen, device=DEV)  # noqa: E731
  rows = torch.arange(b, device=DEV)
  qpos = m.qpos0.expand(b, -1).clone()
  limited = [j for j in range(m.njnt) if m.jnt_limited[j]]
  adr = torch.tensor([m.jnt_qposadr[j] for j in limited], device=DEV)
  lo, hi = m.jnt_range[limited, 0], m.jnt_range[limited, 1]
  qpos[:, adr] = lo + (hi - lo) * u(b, len(limited))
  rest = torch.arange(b, device=DEV) < BOX_QPOS0
  qpos[rest] = m.qpos0

  def kinematics(q):
    return kin.kinematics(m, make_data(m, b).replace(qpos=q))

  def each(geoms):
    return torch.tensor(geoms, device=DEV).expand(b, -1)

  caps = [g for g in range(m.ngeom) if m.geom_type[g] == GeomType.CAPSULE]
  depth = 0.003 * u(b)
  depth[rest] = 0.001
  if name == 'Walker':
    qpos[~rest, 2] = (0.8 * u(b) - 0.4)[~rest]
    qpos[:, 1] -= lowest_z(m, kinematics(qpos), each(caps)).amin(-1) + depth
  elif name == 'Bimanual Insert':
    (peg,) = geoms_named(m, 'peg_geom')
    h = m.geom_size[peg]
    upright = u(b) < 0.5
    yaw = torch.where(upright, u(b) - 0.5, (2 * u(b) - 1) * math.pi)
    quat = torch.where(upright[:, None], yaw_quats(yaw),
                       tm.quat_normalize(torch.randn(
                           (b, 4), generator=gen, device=DEV)))
    wall = torch.randint(4, (b,), generator=gen, device=DEV)
    normal = torch.tensor([[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0],
                           [0.0, -1.0]], device=DEV)[wall]
    reach = h[0] * (torch.abs(torch.cos(yaw)) + torch.abs(torch.sin(yaw)))
    along = 0.035 - reach + 0.003 * u(b)
    side = 0.01 * u(b) - 0.005
    xy_wall = normal * along[:, None] + normal.flip(-1) * side[:, None]
    mat = tm.quat_to_mat(quat)
    low = torch.sum(h * torch.abs(mat[:, 2, :]), -1)
    z = torch.where(upright, h[2] - 0.001 + 0.01 * u(b),
                    0.08 - 0.003 * u(b) + low)
    xy = torch.where(upright[:, None], xy_wall, 0.11 * u(b, 2) - 0.055)
    qpos[~rest, :3] = torch.cat([xy, z[:, None]], -1)[~rest]
    qpos[~rest, 3:7] = quat[~rest]
  elif name == 'Allegro Cube':
    (cube,), (palm,) = geoms_named(m, 'cube_geom'), geoms_named(m,
                                                                'palm_geom')
    h = m.geom_size[cube, 0]
    d = kinematics(qpos)
    palm_top = d.geom_xpos[0, palm, 2] + m.geom_size[palm, 2]
    on_palm = rest | (u(b) < 1 / 3)
    quat = tm.quat_normalize(torch.randn((b, 4), generator=gen, device=DEV))
    quat[rest] = m.qpos0[3:7]
    mat = tm.quat_to_mat(quat)
    low = torch.sum(h * torch.abs(mat[:, 2, :]), -1)
    xy = torch.where(rest[:, None], 0.0, 0.02 * u(b, 2) - 0.01)
    on = torch.cat([xy, (palm_top - depth + low)[:, None]], -1)
    # against a finger capsule: a point of its segment, the cube turned
    # about z, a face (or an edge) 0-3 mm into the capsule
    g = torch.tensor(caps, device=DEV)[torch.randint(
        len(caps), (b,), generator=gen, device=DEV)]
    r, half = m.geom_size[g, 0], m.geom_size[g, 1]
    p = (d.geom_xpos[rows, g]
         + ((u(b) - 0.5) * half)[:, None] * d.geom_xmat[rows, g, :, 2])
    turn = tm.quat_normalize(torch.randn((b, 4), generator=gen, device=DEV))
    k = torch.randint(3, (b,), generator=gen, device=DEV)
    j = (k + 1 + torch.randint(2, (b,), generator=gen, device=DEV)) % 3
    sk = torch.where(u(b) < 0.5, 1.0, -1.0)
    sj = torch.where(u(b) < 0.5, 1.0, -1.0)
    local = (u(b, 3) - 0.5) * h
    edge = u(b) < 0.5
    off = torch.where(edge, h + (r - math.sqrt(2.0) * depth) / math.sqrt(2.0),
                      h + r - depth)
    local[rows, k] = sk * off
    local[rows, j] = torch.where(edge, sj * off, local[rows, j])
    at = p - torch.einsum('bij,bj->bi', tm.quat_to_mat(turn), local)
    qpos[:, :3] = torch.where(on_palm[:, None], on, at)
    qpos[:, 3:7] = torch.where(on_palm[:, None], quat, turn)
    # where a digit is more than 5 mm into the cube, the cube goes onto
    # the palm instead, the digits as at qpos0
    deep = stacked_points(spec, kinematics(qpos))[0].amin(-1) < -0.005
    qpos[deep, :3], qpos[deep, 3:7] = on[deep], quat[deep]
    qpos[deep, 7:] = m.qpos0[7:]
  elif name == 'Humanoid Interact':
    (seat,) = geoms_named(m, 'seat')
    feet = geoms_named(m, '_foot_geom')
    targets = torch.tensor(geoms_named(m, 'pelvis_geom')
                           + geoms_named(m, '_shin_geom') + feet, device=DEV)
    qpos[~rest, 3:7] = yaw_quats((2 * u(b) - 1) * math.pi)[~rest]
    d = kinematics(qpos)
    seat_top = d.geom_xpos[0, seat, 2] + m.geom_size[seat, 2]
    g = targets[torch.randint(len(targets), (b,), generator=gen, device=DEV)]
    aim = (d.geom_xpos[0, seat, :2]
           + (u(b, 2) - 0.5) * torch.tensor([0.4, 0.5], device=DEV))
    shift = torch.cat([aim - d.geom_xpos[rows, g, :2], (
        seat_top - depth - lowest_z(m, d, g[:, None])[:, 0])[:, None]], -1)
    floor = -depth - lowest_z(m, d, each(feet)).amin(-1)
    qpos[~rest, :3] += shift[~rest]
    qpos[rest, 2] += floor[rest]
    # where a geom is then more than 5 mm into the floor or the seat, the
    # body moves to 1.5 m from the chair and down onto the floor, its
    # lowest geom 0-3 mm in
    deep = stacked_points(spec, kinematics(qpos))[0].amin(-1) < -0.005
    qpos[deep, 0] = d.geom_xpos[0, seat, 0] + 1.5
    qpos[deep, 1] = d.geom_xpos[0, seat, 1]
    body = [g for g in range(m.ngeom) if (0, g) in m.collision_pairs]
    low = lowest_z(m, kinematics(qpos), each(body)).amin(-1)
    qpos[deep, 2] -= (low + depth)[deep]
  clo, chi = m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1]
  qvel = 0.1 * torch.randn((b, m.nv), generator=gen, device=DEV)
  ctrl = clo + (chi - clo) * u(b, m.nu)
  qvel[rest], ctrl[rest] = 0.0, 0.0
  return make_data(m, b).replace(qpos=qpos, qvel=qvel, ctrl=ctrl)


def _gap2(x):
  """The gap (...) between the largest and the runner-up of x (..., n)."""
  import torch
  top = torch.topk(x, 2, -1).values
  return top[..., 0] - top[..., 1]


def box_box_margin(p1, m1, s1, p2, m2, s2):
  """The smallest decision margin (...) of _box_box_sat's choices on these
  poses (float64): the winning family's best against its runner-up (face
  axes; edge axes), the edge's 1e-4 bias, and what follows the winner:
  the reference normal's sign and the incident face's cosines (a face),
  or the edge axis's sign and its supporting edges (an edge)."""
  import torch
  from mujoco_mpc_tpu_torch.physics import collision as col
  from mujoco_mpc_tpu_torch.utils import math as tm
  inf = torch.full(p1.shape[:-1], float('inf'), dtype=p1.dtype)
  face, edge, axis_n = col._sat_axes(p1, m1, s1.expand(p1.shape), p2, m2,
                                     s2.expand(p2.shape))
  best_face, best_edge = col._first_argmax(face), col._first_argmax(edge)
  bias = torch.abs(col._pick(edge, best_edge) - col._pick(face, best_face)
                   - 1e-4)
  use_edge = col._pick(edge, best_edge) > col._pick(face, best_face) + 1e-4
  # a face: the reference normal's sign, the incident face's cosines
  a_is_1 = best_face < 3
  a1v, a1m = a_is_1[..., None], a_is_1[..., None, None]
  mata, matb = torch.where(a1m, m1, m2), torch.where(a1m, m2, m1)
  ca, cb = torch.where(a1v, p1, p2), torch.where(a1v, p2, p1)
  axis_a = col._column(mata, torch.where(a_is_1, best_face, best_face - 3))
  along = tm.dot(cb - ca, axis_a)
  dots = torch.abs(col._mtv(matb, axis_a))
  face_m = torch.minimum(torch.minimum(_gap2(face), torch.abs(along)),
                         _gap2(dots))
  # an edge: the runner-up edge axis, the axis's sign, the supports
  axis_w = col._mv(m1, torch.gather(axis_n, -2, best_edge[..., None, None]
                                    .expand(best_edge.shape + (1, 3)))[..., 0,
                                                                       :])
  sign_w = tm.dot(p2 - p1, axis_w)
  i_e, j_e = best_edge // 3, best_edge % 3
  ar = torch.arange(3)
  sup1 = torch.where(ar == i_e[..., None], inf[..., None], torch.abs(
      col._mtv(m1, axis_w)))
  sup2 = torch.where(ar == j_e[..., None], inf[..., None], torch.abs(
      col._mtv(m2, axis_w)))
  edge_m = torch.minimum(torch.minimum(_gap2(edge), torch.abs(sign_w)),
                         torch.minimum(sup1.amin(-1), sup2.amin(-1)))
  return torch.minimum(bias, torch.where(use_edge, edge_m, face_m))


def sphere_box_margin(c, bc, bmat, bsize):
  """A sphere centre's distance to the box's surface (..., float64), and
  inside the box the gap between its two least depths: where the
  collider's normal is decided."""
  import torch
  from mujoco_mpc_tpu_torch.physics import collision as col
  local = col._mtv(bmat, c - bc)
  out = torch.linalg.vector_norm(local - torch.clamp(local, -bsize, bsize),
                                 dim=-1)
  depth = bsize - torch.abs(local)
  inside = torch.all(depth > 0, -1)
  least = torch.sort(depth, -1).values
  return torch.where(inside, torch.minimum(least[..., 0],
                                           least[..., 1] - least[..., 0]), out)


def box_pair_ties(m, d):
  """(B, P) bool over the model's condim group's points in their stacking
  order: whether the point's pair decides it within the tie rule's
  margins (TIE_MARGIN, F32_ULPS) in that sample of states d (after
  kinematics, on the CPU), computed in float64. Box-box: its five points
  (box_box_margin); capsule-capsule: its point (the first s's spread);
  capsule-box: each of its three points by its own sphere centre (the
  segment's closest point by 8 projections, then the ends;
  sphere_box_margin); sphere-box: its point; sphere-sphere: coincident
  centres."""
  import torch
  from mujoco_mpc_tpu_torch.physics import collision as col
  from mujoco_mpc_tpu_torch.physics.model import GeomType as G
  from mujoco_mpc_tpu_torch.utils import math as tm
  (group,) = m.contact
  check(all(src.kind == 'pair' for src in group.sources),
        'a box-pair task with a hull cluster')
  xpos, xmat = d.geom_xpos.double(), d.geom_xmat.double()
  size = m.geom_size.double()
  cols = []
  for src in group.sources:
    g1, g2 = src.pairs[0]
    t1, t2 = m.geom_type[g1], m.geom_type[g2]
    p1, p2, m1, m2 = xpos[:, g1], xpos[:, g2], xmat[:, g1], xmat[:, g2]
    s1, s2 = size[g1], size[g2]
    tie = torch.zeros((xpos.shape[0], col.points_per_pair(m, g1, g2)),
                      dtype=torch.bool)
    if (t1, t2) == (G.BOX, G.BOX):
      tie[:] = (box_box_margin(p1, m1, s1, p2, m2, s2) < TIE_MARGIN)[:, None]
    elif (t1, t2) == (G.CAPSULE, G.CAPSULE):
      a1, a2 = m1[..., 2], m2[..., 2]
      b = tm.dot(a1, a2)
      denom = torch.clamp(1.0 - b * b, min=1e-12)
      bf, c = b * tm.dot(a2, p1 - p2), tm.dot(a1, p1 - p2)
      s = (bf - c) / denom
      err = F32_ULPS * (torch.linalg.vector_norm(p1, dim=-1)
                        + torch.linalg.vector_norm(p2, dim=-1)
                        + torch.abs(s)) / denom
      tie[:, 0] = (torch.clamp(s + err, -s1[1], s1[1])
                   - torch.clamp(s - err, -s1[1], s1[1])) > POINT_ATOL
    elif (t1, t2) == (G.CAPSULE, G.BOX):
      axis, half = m1[..., 2], s1[1]
      t = torch.zeros_like(p1[:, 0])
      for _ in range(8):
        q = p2 + col._mv(m2, torch.clamp(
            col._mtv(m2, p1 + t[:, None] * axis - p2), -s2, s2))
        t = torch.clamp(tm.dot(q - p1, axis), -half, half)
      for j, c in enumerate((p1 + t[:, None] * axis, p1 - half * axis,
                             p1 + half * axis)):
        tie[:, j] = sphere_box_margin(c, p2, m2, s2) < TIE_MARGIN
    elif (t1, t2) == (G.SPHERE, G.BOX):
      tie[:, 0] = sphere_box_margin(p1, p2, m2, s2) < TIE_MARGIN
    elif (t1, t2) == (G.SPHERE, G.SPHERE):
      tie[:, 0] = torch.linalg.vector_norm(p2 - p1, dim=-1) < TIE_MARGIN
    cols.append(tie)
  return torch.cat(cols, 1)


def check_box_points(spec, cpu_spec, d, ties=None, rest=None, phase='3o',
                     label='qpos0'):
  """Phase 3o's contact points: those the card's step stacks from states
  d (every pair's candidates in JAX's order) against the same step on the
  CPU through the plain path, float32 both. The tie rule exempts a point
  whose pair decides within its margins (`ties`, box_pair_ties by
  default: (model, CPU data after kinematics) -> (B, P) bool) or that the
  colliders place apart in float64 from the card's geom poses and from
  the CPU's (the kinematics' f32 rounding amplified). Every other point
  agrees: its depth within POINT_ATOL (the unselected box-box family's
  1e6 and a height field's 1e10 exactly), and where the CPU's depth is a
  point's (below 1e5) its position within POINT_ATOL and its normal
  within NORMAL_ATOL. The samples beyond the first `rest` (BOX_QPOS0 by
  default, the states at `label`) with a tied point in contact are at
  most BOX_TIE_CAP of the others. Returns the line's text."""
  ties = ties or box_pair_ties
  rest = BOX_QPOS0 if rest is None else rest
  import torch
  from mujoco_mpc_tpu_torch.physics import forward as fwd
  from mujoco_mpc_tpu_torch.physics.model import make_data
  from mujoco_mpc_tpu_torch.tasks import registry
  card_d = fwd.fwd_position(spec.model, d)
  card = [x.cpu() for x in stacked_points(spec, card_d)]
  cpu_d = fwd.fwd_position(cpu_spec.model, to_cpu(d))
  cpu = stacked_points(cpu_spec, cpu_d)
  tied = ties(cpu_spec.model, cpu_d)                          # (B, P)
  check(tied.shape == cpu[0].shape, 'points and pairs do not line up')
  # conditioning: the colliders in float64 on the card's geom poses and
  # on the CPU's already disagree there
  spec64 = registry.get_task(spec.name, device='cpu', dtype=torch.float64)
  ref = [stacked_points(spec64, make_data(spec64.model,
                                          d.qpos.shape[0]).replace(
      geom_xpos=x.geom_xpos.cpu().double(),
      geom_xmat=x.geom_xmat.cpu().double()))
         for x in (card_d, cpu_d)]
  ill = ((torch.abs(ref[0][0] - ref[1][0]) > POINT_ATOL)
         | (torch.amax(torch.abs(ref[0][1] - ref[1][1]), -1) > POINT_ATOL)
         | (torch.amax(torch.abs(ref[0][2] - ref[1][2]), -1) > NORMAL_ATOL))
  n_ill = int((ill & ~tied).sum())
  tied = tied | ill
  free = ~tied
  near = cpu[0] < 1e5
  dist_err = torch.abs(card[0] - cpu[0])
  pos_err = torch.amax(torch.abs(card[1] - cpu[1]), -1)
  normal_err = torch.amax(torch.abs(card[2] - cpu[2]), -1)
  worst = [float(x[free & mask].max()) if bool((free & mask).any()) else 0.0
           for x, mask in ((dist_err, free), (pos_err, near),
                           (normal_err, near))]
  bad = free & ((dist_err > POINT_ATOL) | (near & (pos_err > POINT_ATOL))
                | (near & (normal_err > NORMAL_ATOL)))
  def show(pts, b, k):
    return [round(float(x), 7) for x in (pts[0][b, k], *pts[1][b, k],
                                         *pts[2][b, k])]

  for b, k in torch.nonzero(bad)[:4].tolist():
    print(f'phase {phase} {spec.name} point off (dist, pos, normal): '
          f'sample {b} point {k} card {show(card, b, k)}, CPU {show(cpu, b, k)}, '
          f'float64 {show(ref[1], b, k)}')
  check(worst[0] <= POINT_ATOL, f'contact depths, card vs CPU: '
        f'{worst[0]:.3g} > {POINT_ATOL:g} outside the ties')
  check(worst[1] <= POINT_ATOL and worst[2] <= NORMAL_ATOL,
        f'contact positions / normals, card vs CPU: {worst[1]:.3g} / '
        f'{worst[2]:.3g} > {POINT_ATOL:g} / {NORMAL_ATOL:g} outside the ties')
  tied_contact = (tied & (cpu[0] < 0)).any(-1)
  n_rest = int(tied_contact[rest:].sum())
  cap = int(BOX_TIE_CAP * (tied.shape[0] - rest))
  check(n_rest <= cap, f'{n_rest} samples beyond qpos0 with a tied point '
        f'in contact, more than {cap}')
  moved = tied & ((dist_err > POINT_ATOL) | (near & (pos_err > POINT_ATOL)))
  return (f'{card[0].shape[1]} points a sample, {int((cpu[0] < 0).sum())} '
          f'in contact; outside the ties depths, positions and normals max '
          f'abs err {worst[0]:.3g}, {worst[1]:.3g}, {worst[2]:.3g} (tol '
          f'{POINT_ATOL:g}, {POINT_ATOL:g}, {NORMAL_ATOL:g}); tied points '
          f'{int(tied.sum())} of {tied.numel()} ({n_ill} of them by the '
          f'float64 colliders alone), samples with a tied point '
          f'in contact {int(tied_contact[:rest].sum())} of the '
          f'{rest} at {label} and {n_rest} of the rest (cap {cap}); '
          f'{int(moved.any(-1).sum())} samples with a tied point that '
          f'differs')


def check_box_kernels(spec, cpu_spec, gen):
  """Phase 3o for one task: both kernels on the inputs its step gives them
  at BOX_STATES box_states (B1 on qM and the Euler system within 1e-4
  relative, B2 by phase 3e's rule), and its contact points card vs CPU
  under the tie rule. Returns the states."""
  m = spec.model
  states = box_states(spec, gen, BOX_STATES)
  spd_in, (args, gargs, condims, dmasks) = solver_inputs(spec, states)
  _, spd_err = check_spd_inputs(spd_in, 1e-4, spec.name)
  _, euler_err = check_spd_inputs(euler_inputs(spec, states), 1e-4,
                                  spec.name + ' Euler')
  kw = dict(cap=m.opt.iterations, tol=1e-5, condims=condims, dmasks=dmasks)
  _, line = check_newton_task(spec.name, args, gargs, kw)
  print(f'phase 3o {spec.name} step inputs (B {BOX_STATES}, the first '
        f'{BOX_QPOS0} at qpos0; condims {condims}, P {gargs[1].shape[1]}, ns '
        f'{args[6].shape[1]}): chol_solve n {m.nv} rel err qM '
        f'{spd_err:.3g}, Euler system {euler_err:.3g} (tol 1e-4); {line}')
  print(f'phase 3o {spec.name} contact points, card vs the CPU plain path: '
        + check_box_points(spec, cpu_spec, states))
  return states


def box_timing(specs, states, kern):
  """Phase 4's rows of the box-pair paths (manipulation_kernels), each
  task's rollout batch: Walker (B 129, nv 9), Bimanual Insert (B 97, nv
  18), Allegro Cube (B 129, nv 18) and Humanoid Interact (B 129, nv 23),
  and Allegro Cube at BOX_WIDE + 1. Fills `kern` for every path; returns
  their (B1, B2) max abs errors."""
  errs = {}
  for n in BOX_TASKS:
    errs[manip_path(n)] = manipulation_kernels(
        specs[n], states[n], own_settings(specs[n])[0] + 1, kern,
        manip_path(n))
  errs[BOX_WIDE_PATH] = manipulation_kernels(
      specs['Allegro Cube'], states['Allegro Cube'], BOX_WIDE + 1, kern,
      BOX_WIDE_PATH)
  return errs


def interact_mode_switch(spec, samples, points, gen):
  """Phase 42: Humanoid Interact's plan-act loop, PLAN_ACT_STEPS steps in
  Sitting (mode 0, the default), then as many with select_mode set to
  Standing (1) from where the first stopped; the transition at the next
  plan must write Standing's preset into the weights and store the mode.
  Returns (steps, simulated s, wall s, real-time factor, mean cost, last
  cost)."""
  import torch
  from mujoco_mpc_tpu_torch import agent
  from mujoco_mpc_tpu_torch.physics.model import make_data
  from mujoco_mpc_tpu_torch.tasks import registry
  names = spec.residual_param_names
  sel, cur = names.index('select_mode'), names.index('_cur_mode')
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  carry, costs0 = agent.synchronous_mpc(
      spec, samples, PLAN_ACT_STEPS, 4, gen, num_spline_points=points,
      sim0=make_data(spec.model))
  rp = carry.params.residual_params.clone()
  rp[sel] = 1.0
  carry, costs1 = agent.synchronous_mpc(
      spec, samples, PLAN_ACT_STEPS, 4, gen, num_spline_points=points,
      sim0=carry.sim, params=carry.params.replace(residual_params=rp))
  costs = torch.cat([costs0, costs1]).cpu()
  wall = time.perf_counter() - t0
  terms = [spec.term_names.index(n) for n in registry._INTERACT_TERMS]
  preset = torch.tensor(registry._INTERACT_MODE_WEIGHTS[1],
                        dtype=torch.float32)
  check(bool(torch.equal(carry.params.weights[terms].cpu(), preset)),
        'the mode switch did not write the Standing preset')
  check(float(carry.params.residual_params[cur]) == 1.0,
        'the mode switch did not store the mode')
  check(bool(torch.isfinite(costs).all()), 'plan-act costs not finite')
  sim_time = len(costs) * float(spec.model.opt.timestep)
  return (len(costs), sim_time, wall, sim_time / wall, float(costs.mean()),
          float(costs[-1]))


def box_phases(specs, cpu_specs, gen, elapsed):
  """Phases 38-43 from the four tasks' specs (card and CPU): each task's
  main path at its own candidates x horizon and knots from qpos0 with its
  launches as predicted (2 T B1, T B2 a plan), and its card-vs-CPU golden
  at its own candidates with phase 9's bounds and best_return within
  BOX_GOLDEN_RTOL (38-41); Humanoid Interact's plan-act loop with a mode
  switch (42); Allegro Cube's plan at BOX_WIDE candidates (43, timed, no
  golden). Returns ({path: main path record}, {path: golden best_return
  rel err})."""
  from mujoco_mpc_tpu_torch.physics.model import make_data
  main, rel_err = {}, {}
  for phase, name in enumerate(BOX_TASKS, 38):
    spec, cpu_spec = specs[name], cpu_specs[name]
    samples, _, points = own_settings(spec)
    d0 = make_data(spec.model)
    r = main_path(spec, d0, samples, BOX_PLANS, gen, points)
    print_main_path(phase, name, samples, BOX_PLANS, r)
    br_gpu, br_cpu, rel, win_gpu, win_cpu, drift = golden(
        spec, cpu_spec, d0, make_data(cpu_spec.model), gen, 0.2, samples,
        points)
    print(f'phase {phase} golden: {name} {samples}-candidate plan '
          f'({points} knots) best_return card {br_gpu:.6g} vs CPU plain '
          f'{br_cpu:.6g}: rel err {rel:.3g} (tol {BOX_GOLDEN_RTOL:g}); '
          f'winner card {win_gpu} vs CPU {win_cpu} (match '
          f'{win_gpu == win_cpu}); 5-step rollout qpos drift {drift:.3g} '
          f'(tol 0.05)')
    check(rel <= BOX_GOLDEN_RTOL, f'{name} golden best_return rel err '
          f'{rel:.3g} > {BOX_GOLDEN_RTOL:g}')
    main[manip_path(name)], rel_err[manip_path(name)] = r, rel
    elapsed(str(phase))
  inter = specs['Humanoid Interact']
  samples, _, points = own_settings(inter)
  steps, sim_t, wall, rtf, mean, last = interact_mode_switch(
      inter, samples, points, gen)
  print(f'phase 42 plan-act: Humanoid Interact {steps} steps ({sim_t:.2f} s '
        f'simulated, {steps // 4} plans of 4 steps, {samples} candidates, '
        f'Sitting then Standing: the preset weights written at the switch) '
        f'in {wall:.2f} s wall: real-time factor {rtf:.3f}; mean cost '
        f'{mean:.4g}, last {last:.4g}')
  elapsed('42')
  allegro = specs['Allegro Cube']
  samples, _, points = own_settings(allegro)
  r = main_path(allegro, make_data(allegro.model), BOX_WIDE, BOX_WIDE_PLANS,
                gen, points)
  print_main_path(43, 'Allegro Cube', BOX_WIDE, BOX_WIDE_PLANS, r)
  main[BOX_WIDE_PATH] = r
  elapsed('43')
  return main, rel_err


# ---------------------------------------------------------------------------
# The last four tasks: Acrobot, Quadrotor (site transmissions), OP3 Stand
# and Quadruped Hill (height fields) (phases 3p, 44-49, and their rows in
# phase 4)
# ---------------------------------------------------------------------------


def last_states(spec, gen, bsz):
  """bsz states of one of the last four tasks, the first LAST_HOME at
  rest: Acrobot's angles uniform on the circle (the first at qpos0),
  velocities normal (scale 1); Quadrotor at `home`, the rest moved by
  ~0.3 m (normal) and turned at random; OP3 Stand at `home` lowered onto
  the floor 1 mm, the rest with its joints uniform in their ranges and
  turned about z; Quadruped Hill at `home` (its feet on the floor and on
  the flattened terrain at once), the rest out on the rough terrain: x
  and y uniform in [-3.5, 3.5] at least 1.5 m from the centre, turned
  about z, the joints spread by 0.2 rad. OP3's and Hill's moved states
  are lowered until their deepest point (twice: a slope turns the
  vertical move) is 0-3 mm in. Velocities normal (scale 0.1), controls
  uniform in their ranges, both zero at rest."""
  import math
  import torch
  from mujoco_mpc_tpu_torch.physics import kinematics as kin
  from mujoco_mpc_tpu_torch.physics.model import make_data
  from mujoco_mpc_tpu_torch.utils import math as tm
  m, b, name = spec.model, bsz, spec.name
  u = lambda *s: torch.rand(s, generator=gen, device=DEV)  # noqa: E731
  rest = torch.arange(b, device=DEV) < LAST_HOME
  moved = ~rest
  home = m.keyframe_qpos('home') if m.keyframe_names else m.qpos0
  qpos = home.expand(b, -1).clone()
  depth = 0.003 * u(b)
  if name == 'Acrobot':
    qpos = torch.where(rest[:, None], m.qpos0,
                       (2 * u(b, m.nq) - 1) * math.pi)
  elif name == 'Quadrotor':
    qpos[moved, :3] += 0.3 * torch.randn((b, 3), generator=gen,
                                         device=DEV)[moved]
    qpos[moved, 3:7] = tm.quat_normalize(torch.randn(
        (b, 4), generator=gen, device=DEV))[moved]
  else:
    if name == 'OP3 Stand':
      limited = [j for j in range(m.njnt) if m.jnt_limited[j]]
      adr = torch.tensor([m.jnt_qposadr[j] for j in limited], device=DEV)
      lo, hi = m.jnt_range[limited, 0], m.jnt_range[limited, 1]
      spread = qpos.clone()
      spread[:, adr] = lo + (hi - lo) * u(b, len(limited))
      qpos = torch.where(moved[:, None], spread, qpos)
    else:
      r = 1.5 + 2.0 * u(b)
      ang = 2 * math.pi * u(b)
      xy = torch.stack([r * torch.cos(ang), r * torch.sin(ang)], -1)
      qpos[moved, :2] = torch.clamp(xy, -3.5, 3.5)[moved]
      qpos[moved, 7:] += 0.2 * torch.randn((b, 12), generator=gen,
                                           device=DEV)[moved]
    qpos[moved, 3:7] = yaw_quats((2 * u(b) - 1) * math.pi)[moved]
    depth[rest] = 0.001 if name == 'OP3 Stand' else 0.0
    for _ in range(2):
      d = kin.kinematics(m, make_data(m, b).replace(qpos=qpos))
      low = stacked_points(spec, d)[0].amin(-1)
      shift = low + depth
      if name == 'Quadruped Hill':   # `home` as it stands
        shift = torch.where(rest, 0.0, shift)
      qpos[:, 2] -= shift
  clo, chi = m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1]
  qvel = torch.randn((b, m.nv), generator=gen, device=DEV)
  qvel *= 1.0 if name == 'Acrobot' else 0.1
  ctrl = clo + (chi - clo) * u(b, m.nu)
  qvel[rest], ctrl[rest] = 0.0, 0.0
  return make_data(m, b).replace(qpos=qpos, qvel=qvel, ctrl=ctrl)


def hfield_ties(m, d):
  """3p's tie rule, (B, P) over the stacked condim-3 points of the step
  from CPU states d after kinematics, in float64: a height-field point
  whose centre lies within HFIELD_TIE cell units of a cell's edge or of
  its diagonal (the card and the CPU may take different triangles there:
  the same height, another normal), and all four points of a box whose
  4th and 5th deepest corners lie within TIE_MARGIN m of each other or
  one of whose corners lies on such a line (its corner set is then
  decided by rounding)."""
  import torch
  from mujoco_mpc_tpu_torch.physics import collision as col
  from mujoco_mpc_tpu_torch.physics.model import GeomType as G
  bsz = d.qpos.shape[0]
  cols = []
  for g1, g2 in m.collision_pairs:
    n = col.points_per_pair(m, g1, g2)
    tie = torch.zeros((bsz, n), dtype=torch.bool)
    if m.geom_type[g1] == G.HFIELD:
      grid, size = (x.double() for x in m.geom_hfield[g1])
      p1, m1 = d.geom_xpos[:, g1].double(), d.geom_xmat[:, g1].double()
      p2, m2 = d.geom_xpos[:, g2].double(), d.geom_xmat[:, g2].double()
      s2 = m.geom_size[g2].double()
      t2 = m.geom_type[g2]
      if t2 == G.BOX:
        c = p2[:, None] + (m.idx.box_signs.double() * s2) @ m2.transpose(
            -1, -2)
      elif t2 == G.CAPSULE:
        ha = s2[1] * m2[..., 2]
        c = torch.stack([p2 + ha, p2 - ha], 1)
      else:
        c = p2[:, None]
      lc = col._mtv(m1[:, None], c - p1[:, None])
      nrow, ncol = grid.shape
      fx = (lc[..., 0] + size[0]) / (2.0 * size[0] / (ncol - 1))
      fy = (lc[..., 1] + size[1]) / (2.0 * size[1] / (nrow - 1))
      ux, uy = fx - torch.floor(fx), fy - torch.floor(fy)
      line = ((torch.minimum(ux, 1 - ux) < HFIELD_TIE)
              | (torch.minimum(uy, 1 - uy) < HFIELD_TIE)
              | (torch.abs(ux - uy) < HFIELD_TIE))
      if t2 == G.BOX:
        depth = col._hfield_point(grid, size, p1[:, None], m1[:, None], c,
                                  0.0).dist
        srt = torch.sort(depth, -1).values
        tie[:] = (line.any(-1) | (srt[:, 4] - srt[:, 3] < TIE_MARGIN))[:, None]
      else:
        tie = line
    cols.append(tie)
  return torch.cat(cols, 1)


def check_last_kernels(spec, cpu_spec, gen):
  """Phase 3p for one task: both kernels on the inputs its step gives them
  at LAST_STATES last_states (B1 on qM and the Euler system within 1e-4
  relative; B2, where the model has rows, by phase 3e's rule), the
  contact points card vs CPU under the tie rule (hfield_ties), and
  Quadrotor's actuator moment and qfrc_actuator card vs CPU within
  LAST_ACT_RTOL relative. Returns the states."""
  import torch
  from mujoco_mpc_tpu_torch.physics import forward as fwd
  m = spec.model
  states = last_states(spec, gen, LAST_STATES)
  spd_in, (args, gargs, condims, dmasks) = solver_inputs(spec, states)
  _, spd_err = check_spd_inputs(spd_in, 1e-4, spec.name)
  _, euler_err = check_spd_inputs(euler_inputs(spec, states), 1e-4,
                                  spec.name + ' Euler')
  head = (f'phase 3p {spec.name} step inputs (B {LAST_STATES}, the first '
          f'{LAST_HOME} at rest): chol_solve n {m.nv} rel err qM '
          f'{spd_err:.3g}, Euler system {euler_err:.3g} (tol 1e-4)')
  if not has_rows(m):
    print(head + '; no constraint rows, no newton')
  else:
    kw = dict(cap=m.opt.iterations, tol=1e-5, condims=condims, dmasks=dmasks)
    _, line = check_newton_task(spec.name, args, gargs, kw)
    print(f'{head}; condims {condims}, P {gargs[1].shape[1]}, ns '
          f'{args[6].shape[1]}: {line}')
    print(f'phase 3p {spec.name} contact points, card vs the CPU plain path: '
          + check_box_points(spec, cpu_spec, states, hfield_ties, LAST_HOME,
                             '3p', 'home'))
  if m.nu and any(t != 0 for t in m.actuator_trntype):
    card = fwd.fwd_actuation(m, fwd.fwd_velocity(m, fwd.fwd_position(
        m, states)))
    cpu = fwd.fwd_actuation(cpu_spec.model, fwd.fwd_velocity(
        cpu_spec.model, fwd.fwd_position(cpu_spec.model, to_cpu(states))))
    errs = [errors(getattr(card, k).cpu(), getattr(cpu, k))
            for k in ('actuator_moment', 'qfrc_actuator')]
    check(max(e[1] for e in errs) <= LAST_ACT_RTOL,
          f'{spec.name} site transmissions card vs CPU: {errs}')
    print(f'phase 3p {spec.name} site transmissions, card vs CPU: '
          f'actuator_moment {tuple(card.actuator_moment.shape)} rel err '
          f'{errs[0][1]:.3g}, qfrc_actuator rel err {errs[1][1]:.3g} (tol '
          f'{LAST_ACT_RTOL:g})')
  return states


def spd_path_kernels(label, spd_args, spd_tol):
  """B1 alone at a path's shapes (a model with no constraint rows):
  checked against its plain version and timed with its bound. Returns
  (timings as phase 4 keeps them, (B1, None) max abs errors)."""
  spd_abs = check_spd_inputs(spd_args, spd_tol, label)[0]
  spd_times = time_spd(spd_args, PLAIN_REPS)
  print(f'phase {label} timing per call, wall / device only: '
        + spd_timing_line(*spd_times, spd_args[0]) + '; no newton')
  return dict(wall=spd_times[0], dev=spd_times[1],
              spd_bound=spd_times[2]), (spd_abs, None)


def spread_batch(d, bsz, first=0):
  """bsz samples of batched Data d from its sample `first` on, spread
  over them (the first, then evenly), or, past their number, all of them
  and the last ones again."""
  import dataclasses
  import torch
  b = d.batch - first
  ar = torch.arange(bsz, device=d.qpos.device)
  idx = first + (ar * b // bsz if bsz <= b else (ar - (bsz - b)) % b)
  return d.replace(**{f.name: getattr(d, f.name)[idx]
                      for f in dataclasses.fields(d)
                      if getattr(d, f.name) is not None})


def home_ties(spec, states, bsz):
  """B2 at bsz copies of 3p's state at rest (`home`) against its plain
  version, held to 3d's rule for dense problems (every sample outside the
  tolerance a near tie, no share: the copies are one state, all of them
  or none). Quadruped Hill's `home` puts each foot on the floor and on
  the flattened terrain at once: duplicate rows, which at B 61 B2 and its
  plain version split differently within cap 6 (on an NVIDIA H100,
  relative cost gap 7.83e-12), while at B 4096 (3p) they agree."""
  m = spec.model
  _, (args, gargs, condims, dmasks) = solver_inputs(
      spec, batch_of(states, 1).expand(bsz))
  args = tuple(t.contiguous() for t in args)
  gargs = tuple(t.contiguous() for t in gargs)
  nbad, gap, _, bad_gap = compare_newton(
      args, gargs, cap=m.opt.iterations, tol=1e-5, condims=condims,
      dmasks=dmasks)
  newton_ok(f'{spec.name} at home', bsz, nbad, gap, bad_gap, share=False)
  print(f'phase 4 {manip_path(spec.name)} at `home` (B {bsz}, one state): '
        f'newton {newton_line(nbad, bsz, gap, bad_gap, share=False)}')


def last_timing(specs, states, kern):
  """Phase 4's rows of the last four paths, each task's rollout batch of
  phase 3p's moved states spread over them (spread_batch; the states at
  rest are one state, which home_ties checks alone): Acrobot (B 129, n
  2) and Quadrotor (B 129, n 6), B1 alone; OP3 Stand (B 97, nv 18, P 29)
  and Quadruped Hill (B 61, nv 18, P 36), and Hill at LAST_WIDE + 1.
  B2's samples outside the tolerance must each be a near tie; their share
  is held to 3e's 1 % at LAST_WIDE + 1 and, as at 3p's B 4096, not at B
  61-97, where 1 % is no sample (3p's near ties come once in ~1,000
  samples at OP3 and Hill). Fills `kern` for every path; returns their
  (B1, B2) max abs errors."""
  errs = {}
  for n in LAST_TASKS:
    spec = specs[n]
    bsz = own_settings(spec)[0] + 1
    d = spread_batch(states[n], bsz, LAST_HOME)
    if has_rows(spec.model):
      errs[manip_path(n)] = manipulation_kernels(spec, d, bsz, kern,
                                                 manip_path(n), share=False)
      home_ties(spec, states[n], bsz)
    else:
      spd_in, _ = solver_inputs(spec, d)
      kern[manip_path(n)], errs[manip_path(n)] = spd_path_kernels(
          f'4 {manip_path(n)} (B {bsz})', spd_in, 1e-4)
  hill = 'Quadruped Hill'
  errs[LAST_WIDE_PATH] = manipulation_kernels(
      specs[hill], spread_batch(states[hill], LAST_WIDE + 1, LAST_HOME),
      LAST_WIDE + 1, kern, LAST_WIDE_PATH)
  return errs


def quadrotor_hover(spec):
  """Phase 49: JAX's tests/test_tasks.py test_quadrotor_hovers_with_
  planning on the card: synchronous MPC from qpos0, HOVER_SAMPLES
  candidates, HOVER_STEPS steps, HOVER_STEPS_PER_PLAN a plan, the goal
  moving on its circle. Returns (steps, simulated s, wall s, real-time
  factor, mean cost, last cost, final z)."""
  import torch
  from mujoco_mpc_tpu_torch import agent
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  carry, costs = agent.synchronous_mpc(
      spec, HOVER_SAMPLES, HOVER_STEPS, HOVER_STEPS_PER_PLAN,
      torch.Generator(device=DEV).manual_seed(0))
  costs = costs.cpu()
  wall = time.perf_counter() - t0
  z = float(carry.sim.qpos[0, 2])
  check(bool(torch.isfinite(costs).all()), 'hover costs not finite')
  check(z > 0.4, f'the quadrotor fell: z {z:.3f} <= 0.4')
  sim_time = len(costs) * float(spec.model.opt.timestep)
  return (len(costs), sim_time, wall, sim_time / wall, float(costs.mean()),
          float(costs[-1]), z)


def last_phases(specs, cpu_specs, gen, elapsed):
  """Phases 44-49 from the four tasks' specs (card and CPU): each task's
  main path at its own candidates x horizon and knots from `home`
  (Acrobot hanging down) with its launches as predicted (2 T B1 a plan; T B2 for
  OP3 and Hill, none for Acrobot and Quadrotor), and its card-vs-CPU
  golden at its own candidates with phase 9's bounds (44-47); Quadruped
  Hill at LAST_WIDE candidates (48, timed, no golden); Quadrotor's
  plan-act hover (49). Returns ({path: main path record}, {path: golden
  best_return rel err})."""
  from mujoco_mpc_tpu_torch.physics.model import make_data
  main, rel_err = {}, {}

  def start(spec):
    """`home`; Acrobot (no keyframe; qpos0 is its upright goal, where a
    plan at rest costs nothing) hanging down, the swing-up's start."""
    import torch
    m = spec.model
    d0 = make_data(m)
    if m.keyframe_names:
      return d0.replace(qpos=m.keyframe_qpos('home')[None])
    return d0.replace(qpos=torch.tensor([[ACROBOT_HANG, 0.0]], device=DEV))
  for phase, name in enumerate(LAST_TASKS, 44):
    spec, cpu_spec = specs[name], cpu_specs[name]
    samples, _, points = own_settings(spec)
    d0 = start(spec)
    r = main_path(spec, d0, samples, LAST_PLANS, gen, points)
    print_main_path(phase, name, samples, LAST_PLANS, r)
    br_gpu, br_cpu, rel, win_gpu, win_cpu, drift = golden(
        spec, cpu_spec, d0, to_cpu(d0), gen, 0.2, samples, points)
    print(f'phase {phase} golden: {name} {samples}-candidate plan '
          f'({points} knots) best_return card {br_gpu:.6g} vs CPU plain '
          f'{br_cpu:.6g}: rel err {rel:.3g} (tol 0.02); winner card '
          f'{win_gpu} vs CPU {win_cpu} (match {win_gpu == win_cpu}); 5-step '
          f'rollout qpos drift {drift:.3g} (tol 0.05)')
    main[manip_path(name)], rel_err[manip_path(name)] = r, rel
    elapsed(str(phase))
  hill = specs['Quadruped Hill']
  r = main_path(hill, start(hill), LAST_WIDE, LAST_WIDE_PLANS, gen,
                own_settings(hill)[2])
  print_main_path(48, 'Quadruped Hill', LAST_WIDE, LAST_WIDE_PLANS, r)
  main[LAST_WIDE_PATH] = r
  elapsed('48')
  steps, sim_t, wall, rtf, mean, last, z = quadrotor_hover(specs['Quadrotor'])
  print(f'phase 49 plan-act: Quadrotor {steps} steps ({sim_t:.2f} s '
        f'simulated, {steps // HOVER_STEPS_PER_PLAN} plans of '
        f'{HOVER_STEPS_PER_PLAN} steps, {HOVER_SAMPLES} candidates, the goal '
        f'moving) in {wall:.2f} s wall: real-time factor {rtf:.3f}; mean cost '
        f'{mean:.4g}, last {last:.4g}; final z {z:.3f} (> 0.4)')
  elapsed('49')
  return main, rel_err


def load_physics_models(device, dtype=None):
  """{name: (family, Model, (qpos, qvel, ctrl) its test's state)} from
  assets/physics_models.npz (tools/export_torch_snapshot.py
  --physics-models), float32 unless `dtype`, in the families' order."""
  import numpy as np
  import torch
  from mujoco_mpc_tpu_torch import convert
  from mujoco_mpc_tpu_torch.physics import model as model_lib
  from mujoco_mpc_tpu_torch.tasks import registry
  dtype = dtype or torch.float32
  out = {}
  with np.load(os.path.join(registry.ASSETS, 'physics_models.npz'),
               allow_pickle=False) as z:
    arrays = {k: z[k] for k in z.files}
  for key in arrays:
    if not key.endswith('/family'):
      continue
    name = key.split('/')[0]
    m = model_lib.from_arrays(convert.group(arrays, f'{name}/model/'),
                              json.loads(str(arrays[f'{name}/static'])),
                              device=device, dtype=dtype)
    out[name] = (str(arrays[key]), m, tuple(
        torch.tensor(arrays[f'{name}/{k}'], dtype=dtype, device=device)
        for k in ('qpos', 'qvel', 'ctrl')))
  return dict(sorted(out.items(), key=lambda kv: PHYS_FAMILIES.index(
      kv[1][0])))


def physics_states(m, init, gen, bsz):
  """bsz states of a physics model from its test's state: the first as
  it is, the rest moved by 0.01 in qpos (quaternions renormalised) and
  0.1 in qvel."""
  import torch
  from mujoco_mpc_tpu_torch.physics.model import make_data
  qpos, qvel, ctrl = (x[None].repeat(bsz, 1) for x in init)
  noise = torch.randn(qpos.shape, generator=gen, device=qpos.device)
  qpos = qpos + 0.01 * torch.cat([torch.zeros_like(noise[:1]), noise[1:]])
  noise = torch.randn(qvel.shape, generator=gen, device=qpos.device)
  qvel = qvel + 0.1 * torch.cat([torch.zeros_like(noise[:1]), noise[1:]])
  for t, adr in zip(m.jnt_type, m.jnt_qposadr):
    quat = {0: adr + 3, 1: adr}.get(t)
    if quat is not None:
      q = qpos[:, quat:quat + 4]
      qpos = torch.cat([qpos[:, :quat], q / torch.linalg.vector_norm(
          q, dim=1, keepdim=True), qpos[:, quat + 4:]], 1)
  return make_data(m, bsz).replace(qpos=qpos, qvel=qvel, ctrl=ctrl)


def physics_controls(m, gen, steps, bsz):
  """Controls (steps, bsz, nu) uniform in the actuators' ctrlrange where
  limited, in [-1, 1] elsewhere."""
  import torch
  lim = torch.tensor(m.actuator_ctrllimited, dtype=torch.bool,
                     device=m.device)
  lo = torch.where(lim, m.actuator_ctrlrange[:, 0], -1.0)
  hi = torch.where(lim, m.actuator_ctrlrange[:, 1], 1.0)
  u = torch.rand((steps, bsz, m.nu), generator=gen, device=m.device)
  return lo + (hi - lo) * u


def physics_rollout(m, d, ctrl):
  """d after len(ctrl) steps of forward.step under ctrl (T, B, nu)."""
  from mujoco_mpc_tpu_torch.physics import forward as fwd
  for u in ctrl:
    d = fwd.step(m, d.replace(ctrl=u))
  return d


def physics_launches(m):
  """(B1, B2) launches a step: a forward's qM solve, then Euler's damping
  system, or RK4's three more forward passes; B2 once a forward pass
  where the model has rows."""
  from mujoco_mpc_tpu_torch.physics.model import IntegratorType
  forwards = 4 if m.opt.integrator == IntegratorType.RK4 else 1
  return (forwards + (forwards == 1), forwards * int(has_rows(m)))


def physics_points(m, d):
  """(dist, pos, normal) of every condim group's stacked candidates of a
  model from states d after kinematics."""
  import torch
  from mujoco_mpc_tpu_torch.physics import constraint
  groups = constraint._contact_groups(m, d).values()
  return tuple(torch.cat([getattr(s, k) for s in groups], 1)
               for k in ('dist', 'pos3', 'normal'))


def _points_apart(a, b):
  """(B, P) bool: points of two stackings apart beyond the tolerances
  (POINT_ATOL in depth, and where a's depth is a point's, in position;
  NORMAL_ATOL in normal)."""
  import torch
  near = a[0] < 1e5
  return ((torch.abs(a[0] - b[0]) > POINT_ATOL)
          | (near & (torch.amax(torch.abs(a[1] - b[1]), -1) > POINT_ATOL))
          | (near & (torch.amax(torch.abs(a[2] - b[2]), -1) > NORMAL_ATOL)))


def physics_ties(m64, card_d, cpu_d, gen):
  """(B, P) bool, the conditioning tie rule of 3q's contact points: the
  float64 colliders on the CPU's geom poses against the same poses moved
  by PHYS_TIE (m, rad) twice at random, and against the card's poses. A
  point they move beyond the tolerances sits at a decision (a tied
  argmax face, a k-deepest boundary, a flat or upright cylinder's rim
  choice, a sphere on a cylinder's axis or edge)."""
  import torch
  from mujoco_mpc_tpu_torch.physics.model import make_data
  from mujoco_mpc_tpu_torch.utils import math as tm
  bsz = cpu_d.qpos.shape[0]

  def at(xpos, xmat):
    return physics_points(m64, make_data(m64, bsz).replace(
        geom_xpos=xpos.double().cpu(), geom_xmat=xmat.double().cpu()))
  xpos, xmat = cpu_d.geom_xpos.double(), cpu_d.geom_xmat.double()
  ref = at(xpos, xmat)
  tied = _points_apart(ref, at(card_d.geom_xpos, card_d.geom_xmat))
  cpu_gen = torch.Generator().manual_seed(int(torch.randint(
      1 << 30, (1,), generator=gen, device=DEV)))
  for _ in range(2):
    dp = PHYS_TIE * torch.randn(xpos.shape, generator=cpu_gen,
                                dtype=torch.float64)
    w = PHYS_TIE * torch.randn(xpos.shape, generator=cpu_gen,
                               dtype=torch.float64)
    rot = tm.quat_to_mat(tm.quat_exp(w))
    tied |= _points_apart(ref, at(xpos + dp, xmat @ rot))
  return tied


def check_physics_points(name, m, m_cpu, m64, d, gen):
  """3q's contact points of a physics model: the card's stacking from
  states d after kinematics against the CPU plain path's, float32 both;
  outside physics_ties every point within POINT_ATOL in depth (and where
  it is a point, in position) and NORMAL_ATOL in normal; samples with a
  tied point in contact at most PHYS_TIE_CAP. Returns the line's text."""
  import torch
  from mujoco_mpc_tpu_torch.physics import forward as fwd
  card_d = fwd.fwd_position(m, d)
  card = [x.cpu() for x in physics_points(m, card_d)]
  cpu_d = fwd.fwd_position(m_cpu, to_cpu(d))
  cpu = physics_points(m_cpu, cpu_d)
  tied = physics_ties(m64, card_d, cpu_d, gen)
  bad = _points_apart(cpu, card) & ~tied
  for b, k in torch.nonzero(bad)[:4].tolist():
    print(f'phase 3q {name} point off: sample {b} point {k} card '
          f'{[round(float(x), 7) for x in (card[0][b, k], *card[1][b, k])]}'
          f' CPU {[round(float(x), 7) for x in (cpu[0][b, k], *cpu[1][b, k])]}')
  check(not bool(bad.any()), f'{name}: {int(bad.sum())} contact points '
        f'card vs CPU beyond the tolerances outside the ties')
  free = ~tied
  errs = [float(torch.where(free & mask, torch.abs(x), 0.0).max())
          for x, mask in ((card[0] - cpu[0], free),
                          (torch.amax(torch.abs(card[1] - cpu[1]), -1),
                           cpu[0] < 1e5),
                          (torch.amax(torch.abs(card[2] - cpu[2]), -1),
                           cpu[0] < 1e5))]
  tied_contact = (tied & (cpu[0] < 0)).any(-1)
  cap = int(PHYS_TIE_CAP * tied.shape[0])
  check(int(tied_contact.sum()) <= cap, f'{name}: '
        f'{int(tied_contact.sum())} samples with a tied point in contact, '
        f'more than {cap}')
  return (f'{cpu[0].shape[1]} points a sample, {int((cpu[0] < 0).sum())} in '
          f'contact; outside the ties depths, positions and normals max abs '
          f'err {errs[0]:.3g}, {errs[1]:.3g}, {errs[2]:.3g} (tol '
          f'{POINT_ATOL:g}, {POINT_ATOL:g}, {NORMAL_ATOL:g}); tied points '
          f'{int(tied.sum())} of {tied.numel()}, samples with one in contact '
          f'{int(tied_contact.sum())} (cap {cap})')


def row_count(args, gargs, condims):
  """Dense, one-hot and facet rows a sample of B2's operands."""
  from mujoco_mpc_tpu_torch.ops import newton
  return args[2].shape[1] + args[6].shape[1] + sum(
      len(newton.PYRAMID_FACETS[c]) * g.shape[1]
      for c, g in zip(condims, gargs[1::4]))


def check_physics_kernels(name, m, m_cpu, m64, init, gen):
  """Phase 3q for one physics model: both kernels on the inputs its step
  gives them at PHYS_SAMPLES states (PHYS_STATE_STEPS steps of rollouts
  from physics_states): B1 on qM and the Euler system within 1e-4
  relative, B2 (where the model has rows) by 3e's rule, and the contact
  points card vs CPU (check_physics_points). Returns (the states, the
  (B1, B2) solver inputs, the (B1, B2) max abs errors)."""
  import types
  spec = types.SimpleNamespace(model=m, name=name)
  d = physics_rollout(m, physics_states(m, init, gen, PHYS_SAMPLES),
                      physics_controls(m, gen, PHYS_STATE_STEPS,
                                       PHYS_SAMPLES))
  spd_in, n_in = solver_inputs(spec, d)
  spd_abs, spd_err = check_spd_inputs(spd_in, 1e-4, name)
  _, euler_err = check_spd_inputs(euler_inputs(spec, d), 1e-4,
                                  name + ' Euler')
  line = (f'phase 3q {name} step inputs (B {PHYS_SAMPLES}, after '
          f'{PHYS_STATE_STEPS} steps): chol_solve n {m.nv} rel err qM '
          f'{spd_err:.3g}, Euler system {euler_err:.3g} (tol 1e-4)')
  n_abs = None
  if has_rows(m):
    args, gargs, condims, dmasks = n_in
    nbad, gap, n_abs, bad_gap = compare_newton(
        args, gargs, cap=m.opt.iterations, tol=1e-5, condims=condims,
        dmasks=dmasks)
    newton_ok(f'{name} inputs', PHYS_SAMPLES, nbad, gap, bad_gap)
    n_eq = int((args[5] > 0.5).sum()) // PHYS_SAMPLES
    line += (f'; newton: {args[2].shape[1]} dense rows ({n_eq} '
             f'equality), {args[6].shape[1]} one-hot, condims {condims} P '
             f'{[g.shape[1] for g in gargs[1::4]]}, cap {m.opt.iterations}: '
             + newton_line(nbad, PHYS_SAMPLES, gap, bad_gap))
  else:
    line += '; no constraint rows, no newton'
  print(line)
  if m.collision_pairs:
    print(f'phase 3q {name} contact points, card vs the CPU plain path: '
          + check_physics_points(name, m, m_cpu, m64, d, gen))
  return d, (spd_in, n_in), (spd_abs, n_abs)


def check_physics(gen):
  """Phase 3q over every physics model. Returns ({name: (family, card
  model, CPU model, test state)}, {name: check_physics_kernels' result})."""
  import torch
  card, cpu = load_physics_models(DEV), load_physics_models('cpu')
  cpu64 = load_physics_models('cpu', torch.float64)
  models = {n: (f, m, cpu[n][1], init) for n, (f, m, init) in card.items()}
  out = {name: check_physics_kernels(name, m, m_cpu, cpu64[name][1], init,
                                     gen)
         for name, (_, m, m_cpu, init) in models.items()}
  torch.cuda.synchronize()
  return models, out


def physics_timing(models, checked, kern):
  """Phase 4's rows of the physics families: both kernels at each
  family's largest row set (3q's inputs of its model with the most rows a
  sample), checked against their plain versions and timed with their
  bounds. Fills kern['physics_<family>'] and returns their (B1, B2) max
  abs errors and the models timed."""
  errs, timed = {}, {}
  for fam in PHYS_FAMILIES:
    rows = {n: row_count(*checked[n][1][1][:2], checked[n][1][1][2])
            for n, (f, m, _, _) in models.items()
            if f == fam and has_rows(m)}
    name = max(rows, key=rows.get)
    m = models[name][1]
    spd_in, (args, gargs, condims, dmasks) = checked[name][1]
    path = 'physics_' + fam
    kern[path], e = path_kernels(
        f'4 {path} ({name}, B {PHYS_SAMPLES}, {rows[name]} rows a sample)',
        spd_in, args, gargs, dict(cap=m.opt.iterations, tol=1e-5,
                                  condims=condims, dmasks=dmasks), 1e-4)
    errs[path], timed[path] = e[:2], name
  return errs, timed


def physics_golden(name, m):
  """The golden's PHYSICS_GOLDEN_BATCH states of a model stepped on the
  card under its controls against JAX's float64 trajectory: each sample's
  largest |card - JAX| / max(1, |JAX|) over qpos and qvel and the steps,
  and its sensitivity (physics_sensitivity)."""
  import numpy as np
  import torch
  from mujoco_mpc_tpu_torch.physics.model import make_data
  from mujoco_mpc_tpu_torch.tasks import registry
  with np.load(os.path.join(registry.ASSETS, 'physics_features_golden.npz'),
               allow_pickle=False) as z:
    g = {k: z[k] for k in z.files if k.startswith(name + '/')}

  def t(x):
    return torch.tensor(x, dtype=torch.float32, device=DEV)
  ctrl = g[f'{name}/ctrl']
  d0 = make_data(m, ctrl.shape[1]).replace(qpos=t(g[f'{name}/in_qpos']),
                                           qvel=t(g[f'{name}/in_qvel']))
  d, err = d0, torch.zeros(ctrl.shape[1], dtype=torch.float64)
  for k in range(ctrl.shape[0]):
    d = physics_rollout(m, d, t(ctrl[k:k + 1]))
    want = d.replace(**{f: torch.tensor(g[f'{name}/{f}'][k])
                        for f in ('qpos', 'qvel')})
    err = torch.maximum(err, _state_err(d, want))
  return err, physics_sensitivity(name, to_cpu(d0), torch.tensor(ctrl),
                                  err > PHYS_LEVELS[0])


def _state_err(a, b):
  """Per sample, max |a - b| / max(1, |b|) over qpos and qvel (b on the
  CPU)."""
  import torch
  return torch.stack([torch.amax(
      torch.abs(getattr(a, f).cpu().double() - getattr(b, f).double())
      / torch.clamp(torch.abs(getattr(b, f).double()), min=1.0), -1)
                      for f in ('qpos', 'qvel')]).amax(0)


def physics_sensitivity(name, d, ctrl, which):
  """(B,) float64: for the samples `which` of CPU states d under controls
  ctrl, how far their float64 trajectory moves (_state_err, the larger of
  two draws) when qpos and qvel move by 1e-7; 0 elsewhere. A sample is
  chaotic at a level its sensitivity exceeds: a rocking contact at a tie
  (a cylinder on its disc's rim: its deepest rim point turns with
  rounding) makes two float32 programs part there."""
  import dataclasses
  import torch
  out = torch.zeros(which.shape, dtype=torch.float64)
  if not bool(which.any()):
    return out
  m64 = load_physics_models('cpu', torch.float64)[name][1]
  idx = torch.nonzero(which)[:, 0]
  d = d.replace(**{f.name: getattr(d, f.name)[idx].double()
                   for f in dataclasses.fields(d)
                   if getattr(d, f.name) is not None})
  u = ctrl[:, idx].double()
  base = physics_rollout(m64, d, u)
  gen = torch.Generator().manual_seed(1)
  for _ in range(2):
    moved = d.replace(
        qpos=d.qpos + 1e-7 * torch.randn(d.qpos.shape, generator=gen,
                                          dtype=torch.float64),
        qvel=d.qvel + 1e-7 * torch.randn(d.qvel.shape, generator=gen,
                                          dtype=torch.float64))
    out[idx] = torch.maximum(out[idx],
                             _state_err(physics_rollout(m64, moved, u), base))
  return out


def exempt_check(name, what, err, sens, tol, cap):
  """Holds per-sample errors to tol, exempting a sample beyond it only if
  it is chaotic at tol, at most cap of them. Returns (the largest error of
  the samples not exempt, the number exempt, the levels' text: at each of
  PHYS_LEVELS the samples beyond it and of them those not chaotic at
  it)."""
  import torch
  ill = (err > tol) & (sens > tol)
  bad = (err > tol) & ~ill
  check(not bool(bad.any()), f'{name}: {what} '
        f'{float(err[bad].max()) if bad.any() else 0:.3g} > {tol:g} at '
        f'{int(bad.sum())} samples that are not chaotic')
  check(int(ill.sum()) <= cap, f'{name}: {what}: {int(ill.sum())} chaotic '
        f'samples exempt, more than {cap}')
  levels = ', '.join(f'{lv:g} {int((err > lv).sum())}/'
                     f'{int(((err > lv) & (sens <= lv)).sum())}'
                     for lv in PHYS_LEVELS)
  return (float(torch.where(ill, 0.0, err).max()), int(ill.sum()),
          f'max {float(err.max()):.3g}, beyond/not chaotic at {levels}')


def physics_model_phase(phase, name, m, m_cpu, init, gen):
  """Phase 50-54's run of one physics model: the timed PHYS_SAMPLES x
  PHYS_STEPS rollout with the launch counts, the profiled rollout, card
  vs CPU and the golden. Returns (launches, the rollout's ms, ops a step,
  busy share, card-vs-CPU error, golden error)."""
  import torch
  d0 = physics_states(m, init, gen, PHYS_SAMPLES)
  ctrl = physics_controls(m, gen, PHYS_STEPS, PHYS_SAMPLES)
  physics_rollout(m, d0, ctrl[:2])                   # warm-up
  torch.cuda.synchronize()
  _reset_counts()
  start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
  start.record()
  d = physics_rollout(m, d0, ctrl)
  end.record()
  end.synchronize()
  ms = start.elapsed_time(end)
  launches = _launch_counts()
  b1, b2 = physics_launches(m)
  check(launches == {'chol_solve': b1 * PHYS_STEPS,
                     'newton': b2 * PHYS_STEPS},
        f'{name}: launches {launches}, predicted {b1} and {b2} a step')
  check(bool(torch.isfinite(d.qpos).all() and torch.isfinite(d.qvel).all()),
        f'{name}: a state not finite after {PHYS_STEPS} steps')
  short = ctrl[:PHYS_PROFILE_STEPS]
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  physics_rollout(m, d0, short)
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  dev_us, ops, _ = device_us(lambda: physics_rollout(m, d0, short), reps=1,
                             top=1, warm=False, host=False)
  busy = dev_us / 1e6 / wall
  # card vs CPU on the first PHYS_CPU_SAMPLES samples
  dc = batch_of(d0, PHYS_CPU_SAMPLES)
  cc = ctrl[:PHYS_CPU_STEPS, :PHYS_CPU_SAMPLES]
  got = physics_rollout(m, dc, cc)
  want = physics_rollout(m_cpu, to_cpu(dc), cc.cpu())
  err = _state_err(got, want)                       # (PHYS_CPU_SAMPLES,)
  cpu_err, cpu_ill, cpu_lv = exempt_check(
      name, 'card vs CPU', err, physics_sensitivity(
          name, to_cpu(dc), cc.cpu(), err > PHYS_LEVELS[0]),
      PHYS_CPU_TOL, int(PHYS_CHAOS_CAP * PHYS_CPU_SAMPLES))
  gold, gold_ill, gold_lv = exempt_check(
      name, 'card vs JAX golden', *physics_golden(name, m), PHYS_GOLDEN_TOL,
      PHYS_GOLDEN_EXEMPT)
  print(f'phase {phase} {name}: {PHYS_SAMPLES} x {PHYS_STEPS} steps in '
        f'{ms:.1f} ms ({ms / PHYS_STEPS:.3f} ms a step); launches chol_solve '
        f'{launches["chol_solve"]}, newton {launches["newton"]} (predicted '
        f'{b1} and {b2} a step); profiled {PHYS_PROFILE_STEPS} steps: '
        f'{ops / PHYS_PROFILE_STEPS:.0f} device ops a step, device busy '
        f'{100 * busy:.1f}% of {wall * 1e3:.1f} ms; card vs CPU '
        f'({PHYS_CPU_SAMPLES} x {PHYS_CPU_STEPS}) max err / max(1, |CPU|) '
        f'{cpu_err:.3g} (tol {PHYS_CPU_TOL:g}) outside {cpu_ill} exempt '
        f'chaotic samples ({cpu_lv}); golden vs JAX float64 (4 x 20) '
        f'{gold:.3g} (tol {PHYS_GOLDEN_TOL:g}) outside {gold_ill} exempt '
        f'({gold_lv}); states finite')
  return launches, ms, ops / PHYS_PROFILE_STEPS, busy, cpu_err, gold


def physics_phases(models, gen, elapsed):
  """Phases 50-54: every model of each family (physics_model_phase).
  Returns ({path: {'launches': summed over the family}}, {path: the
  family's worst golden error})."""
  main, gold = {}, {}
  for phase, fam in enumerate(PHYS_FAMILIES, 50):
    path = 'physics_' + fam
    total = {'chol_solve': 0, 'newton': 0}
    worst = 0.0
    for name, (f, m, m_cpu, init) in models.items():
      if f != fam:
        continue
      launches, *_, g = physics_model_phase(phase, name, m, m_cpu, init, gen)
      total = {k: total[k] + launches[k] for k in total}
      worst = max(worst, g)
    main[path], gold[path] = {'launches': total}, worst
    elapsed(str(phase))
  return main, gold


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

  check_spd_wide(gen)
  check_newton_wide(gen)
  cube = registry.get_task('Cube Solving')
  c_spd_in, c_n_in, (c_spd_abs, c_newton_abs) = check_cube_kernels(cube,
                                                                   gen)
  # the estimators' truth (phases 28-30) and the kernels' operands in one
  # EKF and one UKF update (3m, phase 4)
  est_truth = estimator_truth(quad, max(EST_UPDATES, BATCH_WINDOW), 17)
  est_start = filter_start(quad, est_truth, 19)
  est_in = estimator_kernel_inputs(quad, est_truth, est_start)
  est_errs = check_estimator_kernels(est_in)
  # the manipulation tasks' step inputs and contact points (3n)
  manip = {n: registry.get_task(n) for n in MANIP_TASKS}
  manip_cpu = {n: registry.get_task(n, device='cpu') for n in MANIP_TASKS}
  manip_in = {n: check_manipulation_kernels(manip[n], manip_cpu[n], gen)
              for n in MANIP_TASKS}
  # the box-pair tasks' step inputs and contact points (3o)
  boxes = {n: registry.get_task(n) for n in BOX_TASKS}
  boxes_cpu = {n: registry.get_task(n, device='cpu') for n in BOX_TASKS}
  boxes_in = {n: check_box_kernels(boxes[n], boxes_cpu[n], gen)
              for n in BOX_TASKS}
  # the last four tasks' step inputs, contact points and transmissions (3p)
  lasts = {n: registry.get_task(n) for n in LAST_TASKS}
  lasts_cpu = {n: registry.get_task(n, device='cpu') for n in LAST_TASKS}
  lasts_in = {n: check_last_kernels(lasts[n], lasts_cpu[n], gen)
              for n in LAST_TASKS}
  # the physics slice's models' step inputs and contact points (3q)
  phys_gen = torch.Generator(device=DEV).manual_seed(PHYS_SEED)
  phys, phys_in = check_physics(phys_gen)

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
  time_cube_kernels(cube, c_spd_in, c_n_in, gen, kern)
  time_estimator_kernels(est_in, kern)
  manip_errs = manipulation_timing(manip, manip_in, kern)
  box_errs = box_timing(boxes, boxes_in, kern)
  last_errs = last_timing(lasts, lasts_in, kern)
  phys_errs, _ = physics_timing(phys, phys_in, kern)

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
  for phase, name, spec_, iters, prof in (
      (17, 'Particle', part, PARTICLE_ITERS, True),
      (19, 'Swimmer', swim, SWIMMER_ITERS, SWIMMER_PROFILE)):
    r = ilqg_main_path(spec_, iters, ILQG_CANDIDATES, profile=prof)
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

  # 25-26. Cube Solving (bench.py's rubik_ps512)
  cube_main, cube_rel = cube_phases(
      cube, registry.get_task('Cube Solving', device='cpu'), gen, elapsed)

  # 27-30. the estimators on Quadruped Flat
  est = estimator_phases(quad, quad_cpu, gen, elapsed, est_truth, est_start)

  # 31-37. the manipulation tasks on the sphere-box pair
  manip_main, manip_rel = manipulation_phases(manip, manip_cpu, gen, elapsed)

  # 38-43. the box-pair tasks
  box_main, box_rel = box_phases(boxes, boxes_cpu, gen, elapsed)

  # 44-49. the last four tasks
  last_main, last_rel = last_phases(lasts, lasts_cpu, gen, elapsed)

  # 50-54. the physics slice's families
  phys_main, phys_gold = physics_phases(phys, phys_gen, elapsed)

  def entry(name, path, launches, err, k=None):
    k = k or kern[path]
    short = 'chol' if name == 'chol_solve' else 'newton'
    if short == 'newton' and 'newton_bound' not in k:   # no rows, no B2
      return {'launches': launches[name], 'max_abs_err': None, 'ms': None,
              'plain_ms': None, 'device_ms': None, 'bound_ms': None,
              'bound_by': None, 'library_ms': None}
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

  def est_entry(name, path):
    """A filter's entry at its kernels' B 1 (EKF) or B 2 ndx + 1 (UKF)
    shapes, with launches, p50 and busy share an update; the EKF's B1
    carries its tangents' shape (B ndx) under 'tangent'."""
    filt = path[len('quadruped_'):]
    r = est[filt]
    key = min(k for k in est_errs if k[:2] == (name, filt))
    e = entry(name, path, r['launches'], est_errs[key])
    e.update(launches_per_update=r['per_update'][name],
             update_p50_ms=r['p50_ms'], device_busy=r['busy'])
    tkey = max(k for k in est_errs if k[:2] == (name, filt))
    if tkey != key:
      n_t = r['batches'].get((name, tkey[2]), 0)
      e['tangent'] = entry(name, path, {name: n_t}, est_errs[tkey],
                           dict(kern[path]['tangent'], newton_bound=None))
      e['tangent']['launches_per_update'] = n_t / r['updates']
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
    paths['cube_solving'] = entry(
        name, 'cube_solving', cube_main['launches'],
        c_spd_abs if name == 'chol_solve' else c_newton_abs)
    paths['cube_solving']['golden_rel_err'] = cube_rel
    for p in ('quadruped_ekf', 'quadruped_ukf'):
      paths[p] = est_entry(name, p)
    for main_, errs_, rel_ in ((manip_main, manip_errs, manip_rel),
                               (box_main, box_errs, box_rel),
                               (last_main, last_errs, last_rel),
                               (phys_main, phys_errs, {})):
      for p, r in main_.items():
        paths[p] = entry(name, p, r['launches'],
                         errs_[p][0 if name == 'chol_solve' else 1])
        if p in rel_:
          paths[p]['golden_rel_err'] = rel_[p]
        if p in phys_gold:
          paths[p]['golden_jax_err'] = phys_gold[p]
    out.append({'name': name, 'route': 'cuda', 'source': source,
                'replaces': replaces, **paths['quadruped'], 'paths': paths})
  print(json.dumps({'kernels': out}))
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
  main()
