"""The port's host-driven Agent and testspeed.

* Agent plans, acts and steps with each of the seven planner ids on
  Cartpole on the CPU (tests/test_agent_registry.py:14 for JAX's), with
  an 11-step horizon;
* the Agent API against JAX's Agent where it is deterministic, float64:
  cost_terms, best_trajectory of a given policy, cost weights, task
  parameters and modes;
* plan_iteration is make_planner(...).optimize under the same generator
  state;
* testspeed.synchronous_planning_cost on ParticleFixed, and its CLI;
* convert's new planner states (Cross Entropy, Sample Gradient, iLQS)
  from JAX's leaves. Continuing a converted JAX state in both packages
  needs JAX's optimize compiled, so those checks sit beside the compiles
  they reuse: tests/test_torch_planners.py (Cross Entropy, Sample
  Gradient) and tests/test_torch_gradient_ilqs.py (iLQS).
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu import agent as jagent
from mujoco_mpc_tpu.planners import cross_entropy as jcem
from mujoco_mpc_tpu.planners import ilqs as jilqs
from mujoco_mpc_tpu.planners import sample_gradient as jsg
from mujoco_mpc_tpu.tasks import registry as jregistry
from mujoco_mpc_tpu_torch import agent
from mujoco_mpc_tpu_torch import convert
from mujoco_mpc_tpu_torch import testspeed
from mujoco_mpc_tpu_torch.planners import cross_entropy
from mujoco_mpc_tpu_torch.planners import ilqs
from mujoco_mpc_tpu_torch.planners import registry as planners
from mujoco_mpc_tpu_torch.planners import sample_gradient
from mujoco_mpc_tpu_torch.planners import sampling
from mujoco_mpc_tpu_torch.tasks import registry

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64


def _short(spec):
  """The task with a 0.1 s planning horizon (11 steps), so that the
  derivative planners' CPU passes stay short."""
  return dataclasses.replace(spec, config={**spec.config,
                                           'agent_horizon': 0.1})


@pytest.fixture(scope='module')
def cart():
  return _short(registry.get_task('Cartpole', device='cpu'))


@pytest.mark.parametrize('planner_id', range(7))
def test_agent_all_planners(cart, planner_id):
  ag = agent.Agent(cart, num_samples=8, planner_id=planner_id)
  assert ag.planner_id == planner_id
  ag.set_state(qpos=np.asarray([0.5, 3.0]), qvel=np.zeros(2))
  info = ag.plan_iteration()
  assert np.isfinite(float(info['best_return'])), planner_id
  u = ag.action()
  assert u.shape == (1,)
  assert np.isfinite(float(u[0]))
  assert abs(float(u[0])) <= 1.0 + 1e-5
  assert ag.action(nominal=True).shape == (1,)
  assert torch.equal(ag.action(use_previous_policy=True),
                     ag.planner.action(ag.prev_policy, ag.sim_data.qpos,
                                       ag.sim_data.qvel, ag.sim_data.act,
                                       ag.sim_data.time)[0])
  d = ag.step()
  assert float(d.time[0]) == pytest.approx(float(cart.model.opt.timestep))
  ag.transition()
  # the second iteration starts from the carried state
  info = ag.plan_iteration()
  assert np.isfinite(float(info['best_return']))
  assert bool(torch.isfinite(ag.sim_data.qpos).all())


def test_agent_defaults_and_plan_iteration_is_the_planner(cart):
  """Without a planner id the task's agent_planner; plan_iteration is the
  registry's optimize on the synced plan state with the agent's
  generator."""
  ag = agent.Agent(cart, num_samples=8, seed=5)
  assert ag.planner_id == int(cart.config['agent_planner'])
  assert ag.num_samples == 8
  assert ag.generator.device.type == 'cpu'
  for pid in (planners.CEM, planners.ROBUST):
    ag = agent.Agent(cart, num_samples=8, seed=5, planner_id=pid)
    ag.set_state(qpos=[0.2, 2.5], qvel=[0.1, 0.3], time=0.4)
    plan = planners.make_planner(agent.plan_spec(cart), pid, 8,
                                 agent.horizon_steps(cart), 10)
    d0 = agent.sync_plan_state(ag.plan_data, ag.sim_data)
    want, winfo = plan.optimize(ag.policy, d0, ag.params,
                                torch.Generator().manual_seed(5))
    info = ag.plan_iteration()
    for got_t, want_t in zip(
        jax.tree.leaves(dataclasses.astuple(ag.policy)),
        jax.tree.leaves(dataclasses.astuple(want))):
      assert torch.equal(got_t, want_t)
    assert float(info['best_return']) == float(winfo['best_return'])


@pytest.fixture(scope='module')
def agents():
  """JAX's Agent (f64, no native act path) and the port's, on Cartpole,
  from the same state."""
  jspec = jregistry.get_task('Cartpole')
  f64 = lambda t: jax.tree.map(  # noqa: E731
      lambda x: x.astype(jnp.float64)
      if jnp.issubdtype(getattr(x, 'dtype', np.int32), jnp.floating) else x,
      t)
  jspec = _short(dataclasses.replace(
      jspec, model=f64(jspec.model),
      default_params=f64(jspec.default_params)))
  spec = _short(registry.get_task('Cartpole', device='cpu', dtype=F64))
  jag = jagent.Agent(jspec, num_samples=8, use_native_act=False)
  ag = agent.Agent(spec, num_samples=8)
  q, v = [0.4, 2.9], [0.3, -0.7]
  jag.set_state(qpos=np.asarray(q), qvel=np.asarray(v), time=0.25)
  ag.set_state(qpos=q, qvel=v, time=0.25)
  yield jag, ag
  jax.clear_caches()


def test_agent_cost_terms_and_best_trajectory_match_jax(agents):
  jag, ag = agents
  np.testing.assert_allclose(ag.cost_terms().numpy(),
                             np.asarray(jag.cost_terms()), rtol=1e-10,
                             atol=1e-12)
  values = np.random.default_rng(2).uniform(-0.9, 0.9, (10, 1))
  times = 0.25 + np.arange(10) * 0.01
  jag.install_policy(jag.policy.replace(times=jnp.asarray(times),
                                        values=jnp.asarray(values)))
  ag.install_policy(sampling.SamplingPolicy(torch.from_numpy(times),
                                            torch.from_numpy(values)))
  got = ag.best_trajectory()
  want = jag.best_trajectory()
  assert got[0].shape == (ag.horizon_steps, 4)
  for name, g, w in zip(('states', 'actions', 'costs'), got, want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9,
                               atol=1e-12, err_msg=name)
  np.testing.assert_allclose(ag.action().numpy(), np.asarray(jag.action()),
                             rtol=1e-12)
  ag.record_plots()
  ag.record_plots()
  plots = ag.plots()
  assert plots['term_names'] == ag.spec.term_names
  assert plots['time'] == [0.25, 0.25]
  np.testing.assert_allclose(plots['total_cost'][0],
                             float(np.asarray(jag.cost_terms()).sum()),
                             rtol=1e-10)


def test_agent_weights_parameters_and_modes_match_jax(agents):
  jag, ag = agents
  name = ag.spec.term_names[1]
  jag.set_cost_weights({name: 0.37})
  ag.set_cost_weights({name: 0.37})
  np.testing.assert_array_equal(ag.params.weights.numpy(),
                                np.asarray(jag.params.weights))
  pname = ag.spec.residual_param_names[0]
  jag.set_task_parameter(pname, 0.8)
  ag.set_task_parameter(pname, 0.8)
  np.testing.assert_array_equal(ag.params.residual_params.numpy(),
                                np.asarray(jag.params.residual_params))
  np.testing.assert_allclose(ag.cost_terms().numpy(),
                             np.asarray(jag.cost_terms()), rtol=1e-10,
                             atol=1e-12)
  # Cartpole has no modes
  assert ag.mode() == jag.mode() == 0
  ag.set_mode(0)
  with pytest.raises(ValueError):
    ag.set_mode(1)
  # Quadruped's mode is its first select_ parameter (select_Gait)
  jq = jagent.Agent(jregistry.get_task('Quadruped Flat'), num_samples=8,
                    use_native_act=False)
  q = agent.Agent(registry.get_task('Quadruped Flat', device='cpu'),
                  num_samples=8)
  assert q._mode_param() == jq._mode_param()
  for mode in (3, 1):
    jq.set_mode(mode)
    q.set_mode(mode)
    assert q.mode() == jq.mode() == mode
  np.testing.assert_array_equal(q.params.residual_params.numpy(),
                                np.asarray(jq.params.residual_params))


def test_testspeed_runs():
  result = testspeed.synchronous_planning_cost(
      'ParticleFixed', planner_id=0, total_time=0.3,
      steps_per_planning_iteration=5, num_samples=15, verbose=False,
      device='cpu')
  assert result['total_steps'] == 30
  assert result['wall_time_s'] > 0
  assert result['x_realtime'] > 0
  assert np.isfinite(result['avg_cost'])


def test_testspeed_cli_and_the_card_default():
  """The CLI on the CPU with nothing of JAX importable; without a card the
  default device raises."""
  block = ("import sys\n"
           "for name in ('jax', 'jaxlib', 'flax', 'mujoco', "
           "'mujoco_mpc_tpu'):\n"
           "  sys.modules[name] = None\n"
           "from mujoco_mpc_tpu_torch import testspeed\n"
           "sys.argv = ['testspeed'] + sys.argv[1:]\n"
           "testspeed.main()\n")
  env = dict(os.environ, PYTHONPATH=ROOT)
  proc = subprocess.run(
      [sys.executable, '-c', block, '--task', 'ParticleFixed', '--planner',
       '5', '--total_time', '0.05', '--num_samples', '8', '--device', 'cpu',
       '--json'], cwd=ROOT, env=env, capture_output=True, text=True,
      timeout=300, check=False)
  assert proc.returncode == 0, proc.stderr
  result = json.loads(proc.stdout.strip().splitlines()[-1])
  assert result['planner'] == 5 and result['total_steps'] == 5
  assert np.isfinite(result['avg_cost'])
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match='no CUDA device'):
      testspeed.synchronous_planning_cost('ParticleFixed', 0, 0.05, 5, 8,
                                          verbose=False)


def test_convert_planner_states():
  jspec = jregistry.get_task('Cartpole')
  rng = np.random.default_rng(4)
  jcfg = jcem.default_config(jspec, dtype=jnp.float64)
  jc = jcem.default_state(jspec, 5, jcfg, dtype=jnp.float64)
  jc = jc.replace(variance=jnp.asarray(rng.uniform(size=(5, 1))))
  c = convert.cem_state_from_arrays(
      {'times': jc.policy.times, 'values': jc.policy.values}, jc.variance,
      device='cpu', dtype=F64)
  assert isinstance(c, cross_entropy.CEMState)
  np.testing.assert_array_equal(c.variance.numpy(), np.asarray(jc.variance))
  js = jsg.default_state(jspec, 5, dtype=jnp.float64)
  js = js.replace(gradient=jnp.asarray(rng.normal(size=(5, 1))))
  s = convert.sg_state_from_arrays(
      vars(js.policy), js.gradient, js.gradient_prev, device='cpu',
      dtype=F64)
  assert isinstance(s, sample_gradient.SGState)
  np.testing.assert_array_equal(s.gradient.numpy(), np.asarray(js.gradient))
  ji = jilqs.default_state(jspec, 5, 7, dtype=jnp.float64).replace(
      active=jnp.asarray(1, jnp.int32))
  i = convert.ilqs_state_from_arrays(
      vars(ji.sampling_policy), vars(ji.ilqg_state.policy),
      {k: getattr(ji.ilqg_state, k) for k in convert.ILQG_STATE_FIELDS},
      ji.active, device='cpu', dtype=F64)
  assert isinstance(i, ilqs.ILQSState)
  assert i.active.dtype == torch.int32 and int(i.active) == ilqs.ACTIVE_ILQG
  assert i.ilqg_state.policy.feedback_gain.shape == (7, 1, 4)
  np.testing.assert_array_equal(i.sampling_policy.times.numpy(),
                                np.asarray(ji.sampling_policy.times))
