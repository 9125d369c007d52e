"""Time each stage of one rollout step of the port's tasks on the card.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/step_stages.py

For Cartpole (8192 samples at the start state (1.0, 3.14159)), Quadruped
Flat (4096 samples at `home`), Humanoid Track (512 samples at `home`,
the clip's first pose) and Shadow Reorient (8192 samples at qpos0 with
the cube lowered 20 mm onto the palm, where a rollout from qpos0 brings
it), with random controls in the control range, it
runs the stages of a rollout step (planners/rollout.py: forward, residual
and cost, Euler) one after the other, each on the output of the one
before. Each stage is timed alone:
wall time per call (median of 30 between two CUDA events, host launch
overhead included) and device ops and device time per call (profiler, 5
calls). It prints one table per task, the card's name and power limit
first.
"""

import concurrent.futures
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from chip_smoke import cuda_time_ms, device_us  # noqa: E402
from mujoco_mpc_tpu_torch.ops import cuda_build  # noqa: E402
from mujoco_mpc_tpu_torch.physics import constraint  # noqa: E402
from mujoco_mpc_tpu_torch.physics import fluid as fluid_mod  # noqa: E402
from mujoco_mpc_tpu_torch.physics import forward as fwd  # noqa: E402
from mujoco_mpc_tpu_torch.physics import kinematics as kin  # noqa: E402
from mujoco_mpc_tpu_torch.physics import smooth  # noqa: E402
from mujoco_mpc_tpu_torch.physics.model import make_data  # noqa: E402
from mujoco_mpc_tpu_torch.tasks import registry  # noqa: E402


def stages(spec):
  """(name, fn(d) -> d) for the stages of one rollout step."""
  m, p = spec.model, spec.default_params
  rows = {}

  def split(d):
    rows['split'] = constraint.make_rows_split(m, d)
    return d

  def solve(d):
    return constraint.solve(m, d, *rows['split'])

  def residual_cost(d):
    spec.cost(spec.residual_fn(m, d, p.residual_params), p)
    return d

  return (
      ('kinematics', lambda d: kin.kinematics(m, d)),
      ('com_pos', lambda d: kin.com_pos(m, d)),
      ('tendon + transmission',
       lambda d: smooth.transmission(m, smooth.tendon(m, d))),
      ('com_vel', lambda d: kin.com_vel(m, d)),
      ('rne', lambda d: smooth.rne(m, d)),
      ('passive + fluid',
       lambda d: fluid_mod.fluid(m, smooth.passive(m, d))),
      ('actuation', lambda d: smooth.actuation(m, d)),
      ('crb', lambda d: smooth.crb(m, d).replace(
          qfrc_constraint=torch.zeros_like(d.qvel))),
      ('fwd_acceleration (B1)', lambda d: fwd.fwd_acceleration(m, d)),
      ('make_rows_split (limits, contacts)', split),
      ('constraint.solve (B2)', solve),
      ('residual + cost', residual_cost),
      ('integrate (B1)', lambda d: fwd.integrate(m, d)),
  )


def table(name, spec, d):
  print(f'{name}, B {d.batch}: stage | wall ms | device ops | device us')
  total = [0.0, 0.0, 0.0]
  for stage, fn in stages(spec):
    wall = cuda_time_ms(lambda x=d, fn=fn: fn(x))
    dev, ops, _ = device_us(lambda x=d, fn=fn: fn(x), reps=5, top=1)
    print(f'  {stage} | {wall:.3f} | {ops:.0f} | {dev:.1f}')
    total = [total[0] + wall, total[1] + ops, total[2] + dev]
    d = fn(d)
  print(f'  whole step (sum of the stages) | {total[0]:.3f} | {total[1]:.0f}'
        f' | {total[2]:.1f}')


def main():
  if not torch.cuda.is_available():
    raise SystemExit('step_stages: no CUDA device')
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip()
  print(smi.splitlines()[0], f'(torch {torch.__version__})')
  with concurrent.futures.ThreadPoolExecutor(2) as pool:
    list(pool.map(cuda_build.build, ('chol_solve', 'newton')))
  gen = torch.Generator(device='cuda').manual_seed(0)
  for name, bsz, qpos0 in (('Cartpole', 8192, None),
                           ('Quadruped Flat', 4096, 'home'),
                           ('Humanoid Track', 512, 'home'),
                           ('Shadow Reorient', 8192, 'on the palm')):
    spec = registry.get_task(name)
    m = spec.model
    if qpos0 == 'on the palm':
      qpos = m.qpos0.clone()
      qpos[2] -= 0.02
    else:
      qpos = (m.keyframe_qpos(qpos0) if qpos0 else
              torch.tensor([1.0, 3.14159], device='cuda'))
    lo, hi = m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1]
    ctrl = lo + (hi - lo) * torch.rand((bsz, m.nu), generator=gen,
                                       device='cuda')
    d = make_data(m, bsz).replace(qpos=qpos.expand(bsz, -1).clone(),
                                  ctrl=ctrl)
    table(name, spec, d)


if __name__ == '__main__':
  main()
