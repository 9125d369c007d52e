"""Headless synchronous planning benchmark (the reference testspeed binary).

Port of mujoco_mpc_tpu/testspeed.py (synchronous_planning_cost :22, the
CLI :75), over the port's Agent: a synchronous plan-act loop (transition,
a plan every steps_per_planning_iteration steps, the policy's action, a
step) reporting the wall time, the real-time factor and the mean cost per
step. The per-step costs stay on the device until the clock has stopped;
the device is synchronized before it stops. Usage:

  python -m mujoco_mpc_tpu_torch.testspeed --task Cartpole --planner 0 \\
      --total_time 10.0 --steps_per_planning_iteration 4 --num_samples 128

On the CPU add --device cpu.
"""

from __future__ import annotations

import argparse
import json
import time

import torch


def synchronous_planning_cost(task_name: str, planner_id: int,
                              total_time: float,
                              steps_per_planning_iteration: int,
                              num_samples: int, seed: int = 0,
                              verbose: bool = True, device='cuda'):
  """SynchronousPlanningCost (testspeed.cc:44-129)."""
  from mujoco_mpc_tpu_torch import agent as agent_mod
  from mujoco_mpc_tpu_torch.tasks import registry

  spec = registry.get_task(task_name, device=device)
  agent = agent_mod.Agent(spec, num_samples=num_samples, seed=seed,
                          planner_id=planner_id)
  on_card = spec.model.device.type == 'cuda'
  timestep = float(spec.model.opt.timestep)
  total_steps = int(total_time / timestep)

  # warm-up, out of the timing as the reference's first plan is
  agent.plan_iteration()
  agent.action()

  costs = []
  if on_card:
    torch.cuda.synchronize()
  t_start = time.perf_counter()
  for i in range(total_steps):
    agent.transition()
    if i % steps_per_planning_iteration == 0:
      agent.plan_iteration()
    agent.step()
    costs.append(agent.cost_terms().sum())
  if on_card:
    torch.cuda.synchronize()
  wall = time.perf_counter() - t_start

  sim_time = total_steps * timestep
  result = {
      'task': task_name,
      'planner': planner_id,
      'total_steps': total_steps,
      'wall_time_s': wall,
      'x_realtime': sim_time / wall,
      'avg_cost': float(torch.stack(costs).mean()) if costs else float('nan'),
  }
  if verbose:
    print(f'task: {task_name}  planner: {planner_id}')
    print(f'  total wall time: {wall:.3f} s over {sim_time:.2f} s sim '
          f'({result["x_realtime"]:.2f}x realtime)')
    print(f'  average cost/step: {result["avg_cost"]:.5f}')
  return result


def main():
  p = argparse.ArgumentParser()
  p.add_argument('--task', default='Cartpole')
  p.add_argument('--planner', type=int, default=0)
  p.add_argument('--total_time', type=float, default=10.0)
  p.add_argument('--steps_per_planning_iteration', type=int, default=4)
  p.add_argument('--num_samples', type=int, default=128)
  p.add_argument('--seed', type=int, default=0)
  p.add_argument('--device', default='cuda')
  p.add_argument('--json', action='store_true')
  args = p.parse_args()
  result = synchronous_planning_cost(
      args.task, args.planner, args.total_time,
      args.steps_per_planning_iteration, args.num_samples, seed=args.seed,
      verbose=not args.json, device=args.device)
  if args.json:
    print(json.dumps(result))


if __name__ == '__main__':
  main()
