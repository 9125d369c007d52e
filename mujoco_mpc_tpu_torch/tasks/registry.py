"""Task registry: built-in tasks, loaded from model snapshots.

Port of mujoco_mpc_tpu/tasks/registry.py: the Cartpole entry (:114-129),
Particle and ParticleFixed (:133-171), Swimmer (:254-280),
Quadruped Flat (_make_quadruped :354-699, registered at :702), Humanoid
Stand and Walk (_make_humanoid :722-765, registered at :767-782),
Shadow Reorient (_hand_task :925-988 without a goal schedule, registered
at :991-995) and Humanoid Track (:1381-1508, its procedural clip). The
JAX registry compiles models/*.xml with `mujoco`; the port loads the
compiled model, the task parameters and the task's own arrays (Track's
clip) from mujoco_mpc_tpu_torch/assets/ (written by
tools/export_torch_snapshot.py), so it runs where neither `mujoco` nor
JAX is installed. Residuals are batch-first; a transition takes the
B = 1 simulation state.

Tasks load on the card unless the caller asks for another device
(`device='cpu'` in the tests); with no CUDA device the default raises.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from mujoco_mpc_tpu_torch import convert
from mujoco_mpc_tpu_torch.physics import support
from mujoco_mpc_tpu_torch.tasks import base
from mujoco_mpc_tpu_torch.utils import math as tm

ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'assets')


def _cartpole(spec: base.TaskSpec, task: dict):
  def residual(m, d, rp):
    """Reference: mjpc/tasks/cartpole/cartpole.cc Residual."""
    return torch.stack([
        torch.cos(d.qpos[:, 1]) - 1.0,   # Vertical
        d.qpos[:, 0] - rp[0],            # Centered (goal parameter)
        d.qvel[:, 1],                    # Velocity
        d.ctrl[:, 0],                    # Control
    ], dim=-1)
  return residual, None


# ---------------------------------------------------------------------------
# Particle (reference: mjpc/tasks/particle/particle.cc), registry.py
# :133-171
# ---------------------------------------------------------------------------


def _particle_goal_of_time(t: torch.Tensor) -> torch.Tensor:
  return torch.stack([0.25 * torch.sin(t), 0.25 * torch.cos(t / np.pi)], -1)


def _particle(spec: base.TaskSpec, task: dict, fixed: bool):
  """Particle tracks a goal moving with time; ParticleFixed the goal
  mocap body where it stands."""
  tip = spec.model.site('tip')

  def residual(m, d, rp):
    goal = (d.mocap_pos[:, 0, :2] if fixed
            else _particle_goal_of_time(d.time))
    pos = d.site_xpos[:, tip, :2] - goal
    vel = support.site_linvel(m, d, tip)[:, :2]
    return torch.cat([pos, vel, d.ctrl], -1)

  def transition(m, d, params, generator):
    """The goal mocap body follows the moving goal."""
    goal = _particle_goal_of_time(d.time).to(d.mocap_pos.dtype)
    first = torch.cat([goal, d.mocap_pos[:, 0, 2:]], -1)[:, None]
    return d.replace(mocap_pos=torch.cat([first, d.mocap_pos[:, 1:]],
                                         1)), params

  return residual, (None if fixed else transition)


# ---------------------------------------------------------------------------
# Swimmer (reference: mjpc/tasks/swimmer/swimmer.cc), registry.py :254-280
# ---------------------------------------------------------------------------


def _swimmer(spec: base.TaskSpec, task: dict):
  m = spec.model
  nose = m.site('nose')
  target = m.body_mocapid[m.body('target')]

  def residual(m, d, rp):
    return torch.cat([d.ctrl, d.site_xpos[:, nose, :2]
                      - d.mocap_pos[:, target, :2]], -1)

  def transition(m, d, params, generator):
    """On the B = 1 state: once the nose is within 0.04 of the target, a
    new target uniform in [-0.8, 0.8)^2, drawn from `generator` (JAX
    draws it with jax.random.uniform)."""
    new_xy = torch.rand((2,), generator=generator, dtype=m.dtype,
                        device=generator.device).to(m.device) * 1.6 - 0.8
    nose_xy = d.site_xpos[:, nose, :2]
    target_xy = d.mocap_pos[:, target, :2]
    reached = torch.linalg.vector_norm(target_xy - nose_xy, dim=-1) < 0.04
    xy = torch.where(reached[:, None], new_xy, target_xy)
    row = torch.cat([xy, d.mocap_pos[:, target, 2:]], -1)[:, None]
    return d.replace(mocap_pos=torch.cat(
        [d.mocap_pos[:, :target], row, d.mocap_pos[:, target + 1:]],
        1)), params

  return residual, transition


# ---------------------------------------------------------------------------
# Quadruped (reference: mjpc/tasks/quadruped/quadruped.{h,cc}), registry.py
# :294-303 and :354-699
# ---------------------------------------------------------------------------

_QUAD_GAIT_PHASE = np.array([
    [0.0, 0.0, 0.0, 0.0],      # stand
    [0.0, 0.5, 0.75, 0.25],    # walk (lateral sequence)
    [0.0, 0.5, 0.5, 0.0],      # trot
    [0.0, 0.33, 0.33, 0.66],   # canter
    [0.0, 0.05, 0.4, 0.35],    # gallop
])
_QUAD_GAIT_DUTY = np.array([1.0, 0.75, 0.45, 0.4, 0.3])
_QUAD_FOOT_RADIUS = 0.025
_QUAD_HEIGHT_GOAL = 0.33
# per-gait (duty, cadence, amplitude, balance_w, upright_w, height_w),
# applied on a gait switch (reference kGaitParam, quadruped.h:88-97)
_QUAD_GAIT_TABLE = np.array([
    [1.0, 1.0, 0.00, 0.0, 1.0, 1.0],
    [0.75, 1.0, 0.03, 0.0, 1.0, 1.0],
    [0.45, 2.0, 0.03, 0.2, 1.0, 1.0],
    [0.4, 4.0, 0.05, 0.03, 0.5, 0.2],
    [0.3, 3.5, 0.10, 0.03, 0.2, 0.1]])
# auto-gait speed thresholds (reference kGaitAuto)
_QUAD_GAIT_AUTO = np.array([0.0, 0.02, 0.02, 0.6, 2.0, 1e9])

# backflip trajectory constants (reference quadruped.cc:560-600)
_G = 9.81
_HQ, _HCROUCH, _HLEAP, _HMAX = _QUAD_HEIGHT_GOAL, 0.15, 0.5, 0.8
_JUMP_VEL = float(np.sqrt(2 * _G * (_HMAX - _HLEAP)))
_FLIGHT_TIME = 2 * _JUMP_VEL / _G
_JUMP_ACC = _JUMP_VEL ** 2 / (2 * (_HLEAP - _HCROUCH))
_CROUCH_TIME = float(np.sqrt(2 * (_HQ - _HCROUCH) / _JUMP_ACC))
_LEAP_TIME = _JUMP_VEL / _JUMP_ACC
_JUMP_TIME = _CROUCH_TIME + _LEAP_TIME
_CROUCH_VEL = -_JUMP_ACC * _CROUCH_TIME
_LAND_TIME = 2 * (_HLEAP - _HQ) / _JUMP_VEL
_LAND_ACC = _JUMP_VEL / _LAND_TIME
_FLIGHT_ROT_VEL = 1.25 * np.pi / _FLIGHT_TIME
_JUMP_ROT_VEL = np.pi / _LEAP_TIME - _FLIGHT_ROT_VEL
_JUMP_ROT_ACC = (_FLIGHT_ROT_VEL - _JUMP_ROT_VEL) / _LEAP_TIME
_LAND_ROT_ACC = (2 * (_FLIGHT_ROT_VEL * _LAND_TIME - np.pi / 4)
                 / _LAND_TIME ** 2)
_FLIP_TOTAL = _JUMP_TIME + _FLIGHT_TIME + _LAND_TIME


def _flip_height(t, ground):
  h_jump = _HQ + t * _CROUCH_VEL + 0.5 * _JUMP_ACC * t * t
  tf = t - _JUMP_TIME
  h_flight = _HLEAP + _JUMP_VEL * tf - 0.5 * _G * tf * tf
  tl = t - _JUMP_TIME - _FLIGHT_TIME
  h_land = _HLEAP - _JUMP_VEL * tl + 0.5 * _LAND_ACC * tl * tl
  h = torch.where(t < _JUMP_TIME, h_jump,
                  torch.where(t < _JUMP_TIME + _FLIGHT_TIME, h_flight,
                              torch.where(t < _FLIP_TOTAL, h_land,
                                          torch.full_like(t, _HQ))))
  return h + ground


def _flip_angle(t):
  tc = t - _CROUCH_TIME
  a_leap = 0.5 * _JUMP_ROT_ACC * tc * tc + _JUMP_ROT_VEL * tc
  tf = t - _JUMP_TIME
  a_flight = np.pi / 2 + _FLIGHT_ROT_VEL * tf
  tl = t - _JUMP_TIME - _FLIGHT_TIME
  a_land = (1.75 * np.pi + _FLIGHT_ROT_VEL * tl
            - 0.5 * _LAND_ROT_ACC * tl * tl)
  return torch.where(
      t < _CROUCH_TIME, torch.zeros_like(t),
      torch.where(t < _JUMP_TIME, a_leap,
                  torch.where(t < _JUMP_TIME + _FLIGHT_TIME, a_flight,
                              torch.where(t < _FLIP_TOTAL, a_land,
                                          torch.full_like(t, 2 * np.pi)))))


def _quadruped(spec: base.TaskSpec, task: dict):
  """Quadruped locomotion with the reference's modes Quadruped / Biped /
  Walk / Scramble / Flip, automatic gait switching and the backflip
  trajectory; the mode state lives in hidden residual-param slots that
  the transition updates."""
  m = spec.model
  torso, head = m.site('torso_site'), m.site('head_site')
  trunk = m.body('trunk')
  goal_mocap = m.body_mocapid[m.body('goal')]
  kw = dict(device=m.device, dtype=m.dtype)
  feet = torch.tensor([m.geom(f'{f}_foot') for f in ('fl', 'fr', 'hl', 'hr')],
                      device=m.device)
  home = m.keyframe_qpos('home')[7:]
  crouch = m.keyframe_qpos('crouch')[7:]
  idx = {n: i for i, n in enumerate(spec.residual_param_names)}
  widx = {n: i for i, n in enumerate(spec.term_names)}

  def f32(a):   # JAX's float32 tables, promoted to the model's dtype
    return torch.as_tensor(np.asarray(a, np.float32), device=m.device).to(
        m.dtype)
  gait_phase, gait_duty = f32(_QUAD_GAIT_PHASE), f32(_QUAD_GAIT_DUTY)
  gait_table, gait_auto = f32(_QUAD_GAIT_TABLE), f32(_QUAD_GAIT_AUTO)
  height_goals = torch.tensor([_QUAD_HEIGHT_GOAL, 0.5], **kw)  # quad, biped
  e_z = torch.tensor([0.0, 0.0, 1.0], **kw)
  e_y = torch.tensor([0.0, 1.0, 0.0], **kw)
  front_hands = torch.tensor([0.0, 0.0, 1.0, 1.0], **kw)
  hind_hands = torch.tensor([1.0, 1.0, 0.0, 0.0], **kw)
  front_loose = torch.tensor([1, .03, .03, 1, .03, .03, 1, 1, 1, 1, 1, 1],
                             **kw)
  hind_loose = torch.tensor([1, 1, 1, 1, 1, 1, 1, .03, .03, 1, .03, .03],
                            **kw)

  def select(rp, name):
    return torch.clamp(torch.round(rp[idx[name]]).long(), 0, 4)

  def residual(m, d, rp):
    cadence, amplitude, duty_param = rp[0], rp[1], rp[2]
    walk_speed, heading = rp[3], rp[4]
    gait, mode = select(rp, 'select_Gait'), select(rp, 'select_Mode')
    handstand = torch.round(rp[idx['select_Biped type']]) > 0.5
    is_biped, is_scramble, is_flip = mode == 1, mode == 3, mode == 4
    mode_time = d.time - rp[idx['_mode_start']]                  # (B,)
    flip_quat0 = rp[idx['_flip_quat_w']:idx['_flip_quat_w'] + 4]
    flip_ground = rp[idx['_flip_ground']]

    foot_pos = d.geom_xpos[:, feet]                               # (B, 4, 3)
    torso_pos = d.site_xpos[:, torso]
    head_pos = d.site_xpos[:, head]
    trunk_mat = d.xmat[:, trunk]
    bsz = d.qpos.shape[0]

    # biped average foot: front or hind pair only (AverageFootPos)
    biped_pair = torch.where(handstand, foot_pos[:, :2].mean(1),
                             foot_pos[:, 2:].mean(1))
    avg_foot = torch.where(is_biped, biped_pair, foot_pos.mean(1))

    # Upright: trunk z vs world up; biped: x vertical; flip: the flip
    # quaternion trajectory
    r_upright_quad = trunk_mat[..., 2] - e_z
    sgn = torch.where(handstand, -1.0, 1.0).to(m.dtype)
    r_upright_biped = torch.cat(
        [(trunk_mat[:, 2, 0] - sgn)[:, None], torch.zeros((bsz, 2), **kw)],
        -1)
    fq = tm.quat_mul(flip_quat0,
                     tm.axis_angle_to_quat(e_y, _flip_angle(mode_time)))
    r_upright_flip = tm.quat_sub(d.xquat[:, trunk], fq)
    r_upright = torch.where(is_flip, r_upright_flip,
                            torch.where(is_biped, r_upright_biped,
                                        r_upright_quad))

    # Height
    height_goal = height_goals[is_biped.long()]
    r_height_std = torso_pos[:, 2] - avg_foot[:, 2] - height_goal
    r_height_flip = torso_pos[:, 2] - _flip_height(mode_time, flip_ground)
    r_height = torch.where(is_scramble, torch.zeros_like(r_height_std),
                           torch.where(is_flip, r_height_flip,
                                       r_height_std))[:, None]

    # Position: head to the goal mocap (the transition moves it)
    goal = d.mocap_pos[:, goal_mocap]
    r_pos_z = torch.where(is_scramble, 2.0 * (head_pos[:, 2] - goal[:, 2]),
                          torch.zeros_like(goal[:, 2]))
    r_position = torch.cat([head_pos[:, :2] - goal[:, :2], r_pos_z[:, None]],
                           -1)

    # Gait: per-foot swing height over the ground under each foot
    duty = torch.where(duty_param > 0, duty_param, gait_duty[gait])
    phase = torch.remainder(cadence * d.time[:, None] + gait_phase[gait], 1.0)
    swing_frac = torch.clamp(1.0 - duty, min=1e-3)
    swing = torch.clamp((phase - duty) / swing_frac, 0.0, 1.0)
    target_h = amplitude * torch.sin(np.pi * swing)
    target_h = torch.where(gait == 0, torch.zeros_like(target_h), target_h)
    ground = support.ground_height(m, d, foot_pos)                # (B, 4)
    r_gait = foot_pos[..., 2] - ground - _QUAD_FOOT_RADIUS - target_h
    r_gait = torch.where(is_scramble, torch.clamp(r_gait, max=0.0), r_gait)
    hand_mask = torch.where(handstand, front_hands, hind_hands)
    r_gait = torch.where(is_biped, r_gait * hand_mask, r_gait)

    # Balance: capture point vs feet centroid
    com = d.subtree_com[:, trunk]
    com_vel = support.subtree_linvel(m, d, trunk)
    fall_time = torch.sqrt(torch.clamp(torso_pos[:, 2] - avg_foot[:, 2],
                                       min=0.01) / 9.81)
    capture = com[:, :2] + fall_time[:, None] * com_vel[:, :2]
    r_balance = capture - avg_foot[:, :2]

    r_effort = 0.02 * d.actuator_force

    # Posture: home; the crouch keyframe during the flip crouch; free in
    # flight; biped loosens the hand legs
    posture_ref = torch.where(
        (is_flip & (mode_time < _CROUCH_TIME))[:, None], crouch, home)
    r_posture = d.qpos[:, 7:] - posture_ref
    in_flight = is_flip & (mode_time >= _CROUCH_TIME) & (
        mode_time < _JUMP_TIME + _FLIGHT_TIME)
    r_posture = torch.where(in_flight[:, None], torch.zeros_like(r_posture),
                            r_posture)
    biped_scale = torch.where(handstand, hind_loose, front_loose)
    r_posture = torch.where(is_biped, r_posture * biped_scale, r_posture)

    # Orientation: trunk heading vs the goal direction or the commanded
    # heading; biped: the vertical axis becomes the heading axis
    fwd_vec = torch.where(is_biped, sgn * trunk_mat[:, :2, 2],
                          trunk_mat[:, :2, 0])
    fwd_vec = fwd_vec / torch.clamp(
        torch.linalg.vector_norm(fwd_vec, dim=-1, keepdim=True), min=1e-6)
    to_goal = goal[:, :2] - torso_pos[:, :2]
    to_goal = to_goal / torch.clamp(
        torch.linalg.vector_norm(to_goal, dim=-1, keepdim=True), min=1e-6)
    cmd_dir = torch.stack([torch.cos(heading), torch.sin(heading)])
    r_orient = fwd_vec - torch.where(walk_speed > 1e-3, cmd_dir, to_goal)

    r_angmom = support.subtree_angmom(m, d, trunk)

    return torch.cat([
        r_upright, r_height, r_position, r_gait, r_balance, r_effort,
        r_posture, r_orient, r_angmom], -1)

  def transition(m, d, params, generator):
    """Mode state machine (reference TransitionLocked, quadruped.cc:225+)
    on the B = 1 state: auto-gait switching on the filtered com speed,
    per-gait presets, the Walk goal trajectory, Flip entry snapshots, and
    a new goal drawn from `generator` when the goal is reached."""
    rp = params.residual_params.clone()
    w = params.weights.clone()
    time = d.time[0]
    mode = select(rp, 'select_Mode')
    dt = torch.clamp(time - rp[idx['_last_t']], min=0.0)

    # filtered com speed (kAutoGaitFilter = 0.2 s)
    beta = torch.exp(-dt / 0.2)
    com_vel = support.subtree_linvel(m, d, trunk)[0, :2]
    c = idx['_comvel_x']
    filt = beta * rp[c:c + 2] + (1 - beta) * com_vel
    rp[c:c + 2] = filt

    # automatic gait switching (quadruped.cc:254-285): biped always trots
    speed = torch.linalg.vector_norm(filt)
    auto_on = torch.round(rp[idx['select_Gait switch']]) > 0.5
    cur_gait = select(rp, 'select_Gait')
    waited = (time - rp[idx['_gait_switch_t']]) > 1.0
    in_range = (speed > gait_auto[:5]) & (speed <= gait_auto[1:6])
    in_range[4] = speed > gait_auto[4]
    in_range[0] = in_range[0] & (mode != 3)    # scramble: never stand
    auto_gait = torch.argmax(in_range.to(torch.int32))
    switch = auto_on & waited & (auto_gait != cur_gait)
    new_gait = torch.where(mode == 1, 2, torch.where(switch, auto_gait,
                                                     cur_gait))
    rp[idx['select_Gait']] = new_gait.to(rp.dtype)
    rp[idx['_gait_switch_t']] = torch.where(switch, time,
                                            rp[idx['_gait_switch_t']])

    # per-gait presets on a gait change (kGaitParam semantics)
    gait_changed = new_gait != torch.clamp(
        torch.round(rp[idx['_cur_gait']]).long(), 0, 4)
    preset = gait_table[new_gait]
    for i, v in ((0, preset[1]), (1, preset[2]), (2, preset[0])):
      rp[i] = torch.where(gait_changed, v, rp[i])   # cadence, amplitude, duty
    for name, v in (('Balance', preset[3]), ('Upright', preset[4]),
                    ('Height', preset[5])):
      w[widx[name]] = torch.where(gait_changed, v, w[widx[name]])
    rp[idx['_cur_gait']] = new_gait.to(rp.dtype)

    # mode entry: snapshot time, orientation and ground for Flip and Walk
    entered = mode != select(rp, '_cur_mode')
    rp[idx['_mode_start']] = torch.where(entered, time,
                                         rp[idx['_mode_start']])
    q = idx['_flip_quat_w']
    rp[q:q + 4] = torch.where(entered, d.xquat[0, trunk], rp[q:q + 4])
    com = d.subtree_com[:, trunk]
    rp[idx['_flip_ground']] = torch.where(
        entered, support.ground_height(m, d, com)[0], rp[idx['_flip_ground']])
    # walk origin and heading snapshot
    torso_xy = d.xpos[0, trunk, :2]
    fwd = d.xmat[0, trunk, :2, 0]
    fwd = fwd / torch.clamp(torch.linalg.vector_norm(fwd), min=1e-6)
    leftward = torch.stack([-fwd[1], fwd[0]])
    wspeed, wturn = rp[3], rp[idx['Walk turn']]
    use_turn = torch.abs(wturn) > 0.01
    axis_xy = torso_xy + torch.where(
        use_turn, (wspeed / torch.where(use_turn, wturn, 1.0)) * leftward,
        torch.zeros_like(leftward))
    goal_xy = d.mocap_pos[0, goal_mocap, :2]
    p, h = idx['_walk_pos_x'], idx['_walk_head_x']
    rp[p:p + 2] = torch.where(entered, axis_xy, rp[p:p + 2])
    rp[h:h + 2] = torch.where(entered, goal_xy - axis_xy, rp[h:h + 2])
    rp[idx['_cur_mode']] = mode.to(rp.dtype)
    rp[idx['_last_t']] = time

    # Walk: move the goal along the circle or line (quadruped.cc:627-643)
    t_mode = time - rp[idx['_mode_start']]
    pos0, head0 = rp[p:p + 2], rp[h:h + 2]
    hd_norm = head0 / torch.clamp(torch.linalg.vector_norm(head0), min=1e-6)
    straight = pos0 + head0 + t_mode * wspeed * hd_norm
    ang = t_mode * wturn
    rot = torch.stack([torch.stack([torch.cos(ang), -torch.sin(ang)]),
                       torch.stack([torch.sin(ang), torch.cos(ang)])])
    walk_goal = torch.where(use_turn, pos0 + rot @ head0, straight)
    mocap = d.mocap_pos.clone()
    mocap[0, goal_mocap, :2] = torch.where(mode == 2, walk_goal,
                                           mocap[0, goal_mocap, :2])

    # Quadruped and Scramble: a new random goal once the goal is reached
    reached = torch.linalg.vector_norm(torso_xy - goal_xy) < 0.25
    new_xy = torch.rand((2,), generator=generator, dtype=m.dtype,
                        device=generator.device).to(m.device) * 6.0 - 3.0
    randomize = reached & ((mode == 0) | (mode == 3))
    mocap[0, goal_mocap, :2] = torch.where(randomize, new_xy,
                                           mocap[0, goal_mocap, :2])
    return (d.replace(mocap_pos=mocap),
            params.replace(residual_params=rp, weights=w))

  return residual, transition


# ---------------------------------------------------------------------------
# Humanoid Stand / Walk (reference: mjpc/tasks/humanoid/humanoid.cc),
# registry.py :722-782. Walk's default speed goal (residual_params[1] = 1)
# travels in its snapshot's parameters.
# ---------------------------------------------------------------------------


def _humanoid(spec: base.TaskSpec, task: dict, walk: bool):
  m = spec.model
  torso, head = m.body('torso'), m.site('head_site')
  feet = torch.tensor([m.site('right_foot_site'), m.site('left_foot_site')],
                      device=m.device)
  e_z = torch.tensor([0.0, 0.0, 1.0], device=m.device, dtype=m.dtype)

  def residual(m, d, rp):
    foot_pos = d.site_xpos[:, feet]                               # (B, 2, 3)
    avg_foot_z = foot_pos[..., 2].mean(1)
    # Height: head height above the feet vs the goal
    r_height = (d.site_xpos[:, head, 2] - avg_foot_z - rp[0])[:, None]
    # Balance: capture point vs the feet's centroid
    com = d.subtree_com[:, torso]
    com_vel = support.subtree_linvel(m, d, torso)
    fall_time = torch.sqrt(torch.clamp(com[:, 2] - avg_foot_z, min=0.01)
                           / 9.81)
    capture = com[:, :2] + fall_time[:, None] * com_vel[:, :2]
    r_balance = capture - foot_pos[..., :2].mean(1)
    # CoM Vel.: the commanded forward speed (0 for Stand)
    r_comvel = com_vel[:, :2]
    if walk:
      fwd_vec = d.xmat[:, torso, :2, 0]
      fwd_vec = fwd_vec / torch.clamp(
          torch.linalg.vector_norm(fwd_vec, dim=-1, keepdim=True), min=1e-6)
      r_comvel = r_comvel - rp[1] * fwd_vec
    # Upright: torso z axis vs world up
    r_upright = d.xmat[:, torso, :, 2] - e_z
    return torch.cat([r_height, r_balance, r_comvel, 0.1 * d.qvel[:, 6:],
                      d.ctrl, r_upright], -1)

  return residual, None


# ---------------------------------------------------------------------------
# Humanoid Track (reference: mjpc/tasks/humanoid/tracking/tracking.cc),
# registry.py :1270-1508: body markers tracked along a clip baked at 30
# fps, linear interpolation between its frames on each sample's time.
# ---------------------------------------------------------------------------

_TRACK_FPS = 30.0
_TRACK_MARKERS = (
    'torso', 'pelvis', 'right_thigh', 'right_shin', 'right_foot',
    'left_thigh', 'left_shin', 'left_foot', 'right_upper_arm',
    'right_lower_arm', 'left_upper_arm', 'left_lower_arm')


def _humanoid_track(spec: base.TaskSpec, task: dict):
  """The procedural branch of the JAX task, which runs where the
  reference's CMU clips are absent: the 12 bodies of _TRACK_MARKERS track
  the clip's marker table (task['markers'] (frames, 12, 3), float32 as JAX
  holds it, :1433) inside the window of clip `_clip` (task['starts'],
  task['lengths']), with the clip time restarted by the transition on a
  rewind of the simulation time."""
  if 'marker_sites' in task:
    raise NotImplementedError(
        'Humanoid Track on the CMU clips (marker sites, site_linvel) is not '
        'ported yet: it waits for the CMU clip files in the repository '
        '(ROADMAP, Queue A item 1)')
  m = spec.model
  idx = {n: i for i, n in enumerate(spec.residual_param_names)}
  # JAX's float32 table, promoted to the model's dtype in the residual
  markers = torch.as_tensor(np.asarray(task['markers'], np.float32),
                            device=m.device).to(m.dtype)
  starts = torch.as_tensor(np.asarray(task['starts']), device=m.device,
                           dtype=torch.long)
  lengths = torch.as_tensor(np.asarray(task['lengths']), device=m.device,
                            dtype=torch.long)
  bodies = torch.tensor([m.body(b) for b in _TRACK_MARKERS],
                        device=m.device)

  def frames(t, clip):
    """Reference ComputeInterpolationValues (tracking.cc:28-39) in the
    clip's window (:57-66): the bracketing frames and the weight of the
    later one, per sample. On a time that sits on a frame boundary, f32
    on the card and f64 on the CPU may floor to neighbouring frames."""
    start = starts[clip].to(m.dtype)
    last = (starts[clip] + lengths[clip] - 1).to(m.dtype)
    ft = torch.minimum(torch.maximum(t * _TRACK_FPS + start, start), last)
    i0 = torch.floor(ft)
    return i0.long(), torch.minimum(i0 + 1, last).long(), ft - i0

  def residual(m, d, rp):
    bsz = d.qpos.shape[0]
    clip = torch.clamp(torch.round(rp[idx['_clip']]).long(), 0,
                       starts.shape[0] - 1)
    i0, i1, a = frames(d.time - rp[idx['_ref_time']], clip)
    m0, m1 = markers[i0], markers[i1]                     # (B, nmark, 3)
    target = (1.0 - a)[:, None, None] * m0 + a[:, None, None] * m1
    cur = d.xpos[:, bodies]
    cur_v = support.point_velocity(m, d, bodies, cur)
    avg_t, avg_c = target.mean(1, keepdim=True), cur.mean(1, keepdim=True)
    r_avg = (avg_t - avg_c)[:, 0]
    r_pos = ((target - avg_t) - (cur - avg_c)).reshape(bsz, -1)
    # finite-difference marker velocity of the unweighted bracketing
    # frames (tracking.cc:189-210)
    r_vel = ((m1 - m0) * _TRACK_FPS - cur_v).reshape(bsz, -1)
    return torch.cat([d.qvel[:, 6:], d.ctrl, r_avg, r_pos, r_vel], -1)

  def transition(m, d, params, generator):
    """Reference-time handling (tracking.cc TransitionLocked): when the
    simulation time went back (a reset or rewind), the clip restarts from
    the current time."""
    rp = params.residual_params.clone()
    time = d.time[0]
    ref, last = idx['_ref_time'], idx['_last_time']
    rp[ref] = torch.where(time < rp[last], time, rp[ref])
    rp[last] = time
    return d, params.replace(residual_params=rp)

  return residual, transition


# ---------------------------------------------------------------------------
# Shadow Reorient (reference: mjpc/tasks/shadow_reorient/hand.cc),
# registry.py :925-995: the generated hand of models/hands.py with the
# chamfered-mesh cube, reoriented to a goal quaternion held by a mocap body.
# ---------------------------------------------------------------------------

_HAND_CUBE_RESET = (0.0, 0.0, 0.065, 1.0, 0.0, 0.0, 0.0)


def _hand_task(spec: base.TaskSpec, task: dict):
  """The branch of the JAX hand task without a goal schedule: hold the
  cube 4.5 cm above the palm centre in the goal mocap's orientation; the
  transition draws a new goal on success and puts a dropped cube back
  above the palm. The cube's free joint is the first joint."""
  if 'goal_schedule' in task:
    raise NotImplementedError(
        'a hand task with a goal schedule (Cube Solving) is not ported yet '
        '(ROADMAP, Queue A item 3)')
  m = spec.model
  cube = m.body('cube')
  cube_site, palm_site = m.site('cube_site'), m.site('palm_site')
  goal_mocap = m.body_mocapid[m.body('goal')]
  kw = dict(device=m.device, dtype=m.dtype)
  above_palm = torch.tensor([0.0, 0.0, 0.045], **kw)
  reset_pose = torch.tensor(_HAND_CUBE_RESET, **kw)

  def residual(m, d, rp):
    r_pos = d.site_xpos[:, cube_site] - (d.site_xpos[:, palm_site]
                                         + above_palm)
    r_quat = tm.quat_sub(d.xquat[:, cube], d.mocap_quat[:, goal_mocap])
    return torch.cat([r_pos, r_quat, 0.3 * d.cvel[:, cube], d.ctrl], -1)

  def transition(m, d, params, generator):
    """On the B = 1 state: a new goal quaternion, a normal draw from
    `generator` made unit, once the orientation error is under 0.25; a
    cube that fell below -0.12 goes back to _HAND_CUBE_RESET at rest."""
    goal = d.mocap_quat[0, goal_mocap]
    solved = torch.linalg.vector_norm(
        tm.quat_sub(d.xquat[0, cube], goal)) < 0.25
    dropped = d.site_xpos[0, cube_site, 2] < -0.12
    q = torch.randn((4,), generator=generator, dtype=m.dtype,
                    device=generator.device).to(m.device)
    q = q / torch.clamp(torch.linalg.vector_norm(q), min=1e-9)
    mocap_quat = d.mocap_quat.clone()
    mocap_quat[0, goal_mocap] = torch.where(solved, q, goal)
    qpos = torch.where(dropped, torch.cat([reset_pose, d.qpos[0, 7:]]),
                       d.qpos[0])[None]
    qvel = torch.where(dropped, torch.zeros_like(d.qvel), d.qvel)
    return d.replace(qpos=qpos, qvel=qvel, mocap_quat=mocap_quat), params

  return residual, transition


# task name -> (snapshot file, (spec, task arrays) -> (residual_fn,
# transition_fn))
TASKS = {'Cartpole': ('cartpole.npz', _cartpole),
         'Particle': ('particle.npz',
                      functools.partial(_particle, fixed=False)),
         'ParticleFixed': ('particle_fixed.npz',
                           functools.partial(_particle, fixed=True)),
         'Swimmer': ('swimmer.npz', _swimmer),
         'Quadruped Flat': ('quadruped_flat.npz', _quadruped),
         'Humanoid Track': ('humanoid_track.npz', _humanoid_track),
         'Humanoid Stand': ('humanoid_stand.npz',
                            functools.partial(_humanoid, walk=False)),
         'Humanoid Walk': ('humanoid_walk.npz',
                           functools.partial(_humanoid, walk=True)),
         'Shadow Reorient': ('shadow_reorient.npz', _hand_task)}


def task_names():
  return tuple(TASKS)


@functools.lru_cache(maxsize=None)
def get_task(name: str, device='cuda', dtype=torch.float32) -> base.TaskSpec:
  """The task `name` with its model on `device` (the card by default) in
  `dtype`."""
  fname, make_fns = TASKS[name]
  arrays, static = convert.load_snapshot(os.path.join(ASSETS, fname))
  spec = convert.spec_from_arrays(arrays, static, None, device=device,
                                  dtype=dtype)
  residual_fn, transition_fn = make_fns(spec,
                                        convert.group(arrays, 'task/'))
  return dataclasses.replace(spec, residual_fn=residual_fn,
                             transition_fn=transition_fn)
