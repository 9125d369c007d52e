"""The port's sensors, contact forces, rays and inverse dynamics against
the JAX package and the MuJoCo C engine, float64 on the CPU.

The MJCF of tests/test_sensors.py and of
tests/test_direct.py::test_inverse_dynamics_golden, compiled by the JAX
package's put_model and carried into the port as the snapshot tool
carries a task's model.
* sensordata: joint, frame, velocimeter, gyro, accelerometer,
  magnetometer and subtree sensors at three random states as one batch
  (atol 1e-8 against mj_forward's, as JAX's test; 1e-10 against JAX's);
* force, torque and touch sensors and the contact weight balance
  (constraint.contact_forces): FORCE_XML rests a box on a box plate, a
  pair the port does not collide yet (box-box), so the port's case rests
  the box on a plane geom of the same plate body, the sites as in
  FORCE_XML (atol 0.02 against MuJoCo, as JAX's test; 1e-9 against
  JAX's);
* the rangefinder (support.raycast) against box, sphere, capsule,
  cylinder and plane, and a miss, at four yaws as one batch (atol 1e-9),
  with the head's own sphere, which every ray excludes, visual-only and
  colliding with the floor, the wall (sphere-box) and the ball, and on
  RANGE_XML itself (its sphere also against the capsule and the
  cylinder);
* inverse dynamics against mj_inverse (atol 1e-9) and JAX's;
* the refusals: an unsupported sensor type at load, elliptic cones where
  they are evaluated; the tendon sensors, refused before the physics
  slice, against JAX and MuJoCo;
* assets/sensor_models.npz (these models and their states, which
  chip_smoke.py runs on the card) matches a fresh export.
JAX's forward, sensordata, contact forces, inverse dynamics and body
queries (eager JAX, a few seconds a call here) are replayed from
assets/sensors_jax_calls_golden.npz (tests/torch_recorded.py
RecordedJax; record anew with MJPC_TORCH_RECORD=1 in one process; the
slow test_jax_calls_golden_is_jaxs makes them live).
"""

import functools
import os

import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu.physics import constraint as jconstraint
from mujoco_mpc_tpu.physics import forward as jforward
from mujoco_mpc_tpu.physics import inverse as jinverse
from mujoco_mpc_tpu.physics import sensors as jsensors
from mujoco_mpc_tpu.physics.model import make_data as jmake_data
from mujoco_mpc_tpu.physics.model import put_model
from mujoco_mpc_tpu_torch.physics import constraint
from mujoco_mpc_tpu_torch.physics import forward as fwd
from mujoco_mpc_tpu_torch.physics import inverse
from mujoco_mpc_tpu_torch.physics import model as model_lib
from mujoco_mpc_tpu_torch.physics import sensors
from mujoco_mpc_tpu_torch.physics import support
from mujoco_mpc_tpu_torch.tasks import registry as port_registry
from tests.test_direct import XML as INVERSE_XML
from tests.test_sensors import RANGE_XML, XML as SENSOR_XML
from tests.torch_recorded import RecordedJax
from tools import export_torch_snapshot as export

torch.set_num_threads(1)

JAX_CALLS = 'sensors_jax_calls_golden.npz'

# FORCE_XML's plate and sites, with the plate's collision geom a plane
# (the box-box pair is not ported) and its mass on a visual-only box
FORCE_PLANE_XML = """
<mujoco>
  <option timestep="0.002" gravity="0 0 -9.81"/>
  <worldbody>
    <body name="plate" pos="0 0 0.3">
      <geom name="plate_g" type="plane" size="0.2 0.2 0.02" contype="2"
            conaffinity="2"/>
      <geom name="plate_m" type="box" size="0.2 0.2 0.02" pos="0 0 -0.02"
            mass="0.3" contype="0" conaffinity="0"/>
      <site name="fs" pos="0 0 0" type="box" size="0.01 0.01 0.01"/>
      <site name="ts" pos="0 0 0.02" type="box" size="0.21 0.21 0.08"/>
    </body>
    <body name="box" pos="0.05 0 0.36">
      <freejoint/>
      <geom name="box_g" type="box" size="0.05 0.05 0.05" mass="0.2"
            contype="3" conaffinity="3"/>
    </body>
  </worldbody>
  <sensor>
    <force name="f" site="fs"/>
    <torque name="t" site="fs"/>
    <touch name="touch" site="ts"/>
  </sensor>
</mujoco>
"""

# RANGE_XML with the head's sphere visual-only: the rays exclude it, and
# it pairs with nothing (assets/sensor_models.npz carries this model)
RANGE_PORT_XML = RANGE_XML.replace(
    '<geom type="sphere" size="0.05" mass="0.2"/>',
    '<geom type="sphere" size="0.05" mass="0.2" contype="0" '
    'conaffinity="0"/>')
assert RANGE_PORT_XML != RANGE_XML

# the sensor types the XMLs above leave out: a ball joint, frame axes of
# a site, a body and a geom, subtree velocities, actuator sensors, clock
MORE_XML = """
<mujoco>
  <option timestep="0.005" gravity="0 0 -9.81"/>
  <worldbody>
    <body name="b1" pos="0 0 1">
      <joint name="ball" type="ball" damping="0.1"/>
      <geom name="g1" type="capsule" size="0.04" fromto="0 0 0 0.3 0 0"
            mass="0.4"/>
      <site name="s1" pos="0.3 0 0" quat="0.92 0 0.38 0"/>
      <body name="b2" pos="0.3 0 0" quat="0.96 0.28 0 0">
        <joint name="h" type="hinge" axis="0 1 0" damping="0.05"/>
        <geom name="g2" type="sphere" size="0.05" mass="0.2" pos="0.05 0 0"/>
      </body>
    </body>
  </worldbody>
  <actuator><motor name="m" joint="h" gear="2"/></actuator>
  <sensor>
    <ballquat joint="ball"/>
    <ballangvel joint="ball"/>
    <framexaxis objtype="site" objname="s1"/>
    <frameyaxis objtype="body" objname="b2"/>
    <framezaxis objtype="geom" objname="g2"/>
    <framequat objtype="xbody" objname="b2"/>
    <framepos objtype="geom" objname="g2"/>
    <framelinvel objtype="body" objname="b2"/>
    <subtreelinvel body="b1"/>
    <subtreeangmom body="b1"/>
    <actuatorpos actuator="m"/>
    <actuatorvel actuator="m"/>
    <actuatorfrc actuator="m"/>
    <clock/>
  </sensor>
</mujoco>
"""


def _models(xml):
  """(mujoco model, JAX model, the port's model), float64."""
  mjm = mujoco.MjModel.from_xml_string(xml)
  jm = put_model(mjm, dtype=jnp.float64)
  return mjm, jm, model_lib.from_arrays(*export.model_snapshot(jm),
                                        device='cpu', dtype=torch.float64)


def _batch(m, states):
  """A port Data of B = len(states) from mujoco (qpos, qvel, ctrl)."""
  cat = lambda i: torch.tensor(np.stack([s[i] for s in states]))  # noqa: E731
  return model_lib.make_data(m, len(states)).replace(
      qpos=cat(0), qvel=cat(1), ctrl=cat(2))


# the models whose JAX calls the tests replay, by key
XMLS = {'sensors': SENSOR_XML, 'more': MORE_XML, 'force': FORCE_PLANE_XML,
        'range_port': RANGE_PORT_XML, 'range': RANGE_XML,
        'inverse': INVERSE_XML}


def _jax_forward(key, q, v, u, t):
  """JAX's float64 forward of model XMLS[key] at one state: (sensordata,
  its contact forces' (pos, frame, force6, b1, b2) or (), its inverse
  dynamics' (qfrc_smooth, sensordata) at qacc u for key 'inverse', its
  bodies' angular velocities and subtree masses)."""
  from mujoco_mpc_tpu.physics import support as jsupport
  jm = put_model(mujoco.MjModel.from_xml_string(XMLS[key]),
                 dtype=jnp.float64)
  jd = jmake_data(jm, dtype=jnp.float64).replace(qpos=q, qvel=v, time=t)
  if key == 'inverse':
    jd = jinverse.inverse(jm, jd.replace(qacc=u))
    return (jd.qfrc_smooth, jsensors.sensordata(jm, jd))
  jd = jforward.forward(jm, jd.replace(ctrl=u))
  cf = jconstraint.contact_forces(jm, jd) if key == 'force' else None
  return (jsensors.sensordata(jm, jd),
          () if cf is None else (cf.pos, cf.frame, cf.force6,
                                 jnp.asarray(cf.b1), jnp.asarray(cf.b2)),
          [jsupport.body_angvel(jm, jd, b) for b in range(jm.nbody)],
          [jsupport.subtree_mass(jm, b) for b in range(jm.nbody)])


_REC = RecordedJax(os.path.join(port_registry.ASSETS, JAX_CALLS),
                   lambda: {f'forward/{k}': functools.partial(_jax_forward, k)
                            for k in XMLS})


@pytest.fixture(scope='module', autouse=True)
def _record():
  yield
  if _REC.recording:
    _REC.save()


def _jax(key, qpos, qvel, ctrl, time=0.0):
  """_jax_forward replayed (see JAX_CALLS)."""
  return _REC(f'forward/{key}', *(jnp.asarray(np.asarray(x, np.float64))
                                  for x in (qpos, qvel, ctrl, time)))


def _jax_sensordata(key, qpos, qvel, ctrl):
  return np.asarray(_jax(key, qpos, qvel, ctrl)[0])


def test_sensordata_matches_jax_and_mujoco():
  mjm, jm, m = _models(SENSOR_XML)
  rng = np.random.default_rng(2)
  states, want = [], []
  for _ in range(3):
    mjd = mujoco.MjData(mjm)
    mjd.qpos[:] = rng.standard_normal(mjm.nq) * 0.4
    mjd.qvel[:] = rng.standard_normal(mjm.nv) * 0.5
    mjd.ctrl[:] = rng.standard_normal(mjm.nu) * 0.3
    mujoco.mj_forward(mjm, mjd)
    states.append((mjd.qpos.copy(), mjd.qvel.copy(), mjd.ctrl.copy()))
    want.append(mjd.sensordata.copy())
  got = sensors.sensordata(m, fwd.forward(m, _batch(m, states))).numpy()
  assert got.shape == (3, mjm.nsensordata)
  fq = mjm.sensor_adr[3]
  for b, (state, mj_sd) in enumerate(zip(states, want)):
    if np.dot(got[b, fq:fq + 4], mj_sd[fq:fq + 4]) < 0:  # a quat's sign
      mj_sd[fq:fq + 4] *= -1
    np.testing.assert_allclose(got[b], mj_sd, atol=1e-8)
    jax_sd = _jax_sensordata('sensors', *state)
    np.testing.assert_allclose(got[b], jax_sd, atol=1e-10)


def test_more_sensor_types_match_jax_and_mujoco():
  """Ball joint, frame axes and quaternions of sites, bodies and geoms,
  subtree velocity and momentum, actuator sensors and the clock, at three
  random states as one batch (atol 1e-8 against MuJoCo, 1e-10 against
  JAX)."""
  mjm, jm, m = _models(MORE_XML)
  rng = np.random.default_rng(4)
  states, want = [], []
  for _ in range(3):
    mjd = mujoco.MjData(mjm)
    q = rng.standard_normal(4)
    mjd.qpos[:] = np.concatenate([q / np.linalg.norm(q),
                                  rng.standard_normal(1)])
    mjd.qvel[:] = rng.standard_normal(mjm.nv) * 0.5
    mjd.ctrl[:] = rng.standard_normal(mjm.nu) * 0.3
    mjd.time = rng.uniform(0, 2)
    mujoco.mj_forward(mjm, mjd)
    states.append((mjd.qpos.copy(), mjd.qvel.copy(), mjd.ctrl.copy(),
                   mjd.time))
    want.append(mjd.sensordata.copy())
  d = _batch(m, states).replace(
      time=torch.tensor([s[3] for s in states], dtype=torch.float64))
  got = sensors.sensordata(m, fwd.forward(m, d)).numpy()
  quats = [mjm.sensor_adr[i] for i in range(mjm.nsensor)
           if mjm.sensor_type[i] in (sensors.BALLQUAT, sensors.FRAMEQUAT)]
  for b, (state, mj_sd) in enumerate(zip(states, want)):
    for a in quats:                     # a quaternion's sign
      if np.dot(got[b, a:a + 4], mj_sd[a:a + 4]) < 0:
        mj_sd[a:a + 4] *= -1
    np.testing.assert_allclose(got[b], mj_sd, atol=1e-8)
    jax_sd = np.asarray(_jax('more', *state)[0])
    np.testing.assert_allclose(got[b], jax_sd, atol=1e-10)


@pytest.fixture(scope='module')
def resting_box():
  """FORCE_PLANE_XML's box settled on the plate by MuJoCo (500 steps):
  (mujoco model, its data after mj_forward, JAX model, JAX Data after
  forward, the port's model, its Data after forward)."""
  mjm, jm, m = _models(FORCE_PLANE_XML)
  mjd = mujoco.MjData(mjm)
  for _ in range(500):
    mujoco.mj_step(mjm, mjd)
  mujoco.mj_forward(mjm, mjd)
  state = (mjd.qpos.copy(), mjd.qvel.copy(), np.zeros(0))
  jax_out = _jax('force', *state)
  d = fwd.forward(m, _batch(m, [state]))
  return mjm, mjd, jm, jax_out, m, d


def test_force_torque_touch_match_jax_and_mujoco(resting_box):
  """The plate's interface force carries the plate's and the box's
  weight; touch reads the box's weight on the plate."""
  mjm, mjd, jm, jax_out, m, d = resting_box
  got = sensors.sensordata(m, d).numpy()[0]
  want = mjd.sensordata.copy()
  weight = 9.81 * (0.3 + 0.2)
  assert abs(abs(want[2]) - weight) < 0.05, want
  assert abs(want[6] - 9.81 * 0.2) < 0.05, want
  np.testing.assert_allclose(got, want, atol=0.02)
  np.testing.assert_allclose(got, np.asarray(jax_out[0]), atol=1e-9)


def test_contact_forces_match_jax_and_balance_the_weight(resting_box):
  """contact_forces decodes the facet forces in the port's stacking
  order, which is JAX's: positions, frames, wrenches and bodies agree,
  and the vertical force on the box is its weight."""
  mjm, _, jm, jax_out, m, d = resting_box
  cf = constraint.contact_forces(m, d)
  jpos, jframe, jforce6, jb1, jb2 = jax_out[1]
  np.testing.assert_array_equal(cf.b1, np.asarray(jb1))
  np.testing.assert_array_equal(cf.b2, np.asarray(jb2))
  for got, want in ((cf.pos, jpos), (cf.frame, jframe),
                    (cf.force6, jforce6)):
    np.testing.assert_allclose(got.numpy()[0], np.asarray(want), atol=1e-9)
  fw = np.einsum('prx,pr->px', cf.frame.numpy()[0],
                 cf.force6.numpy()[0, :, :3])
  box = mujoco.mj_name2id(mjm, mujoco.mjtObj.mjOBJ_BODY, 'box')
  up = fw[cf.b2 == box, 2].sum() - fw[cf.b1 == box, 2].sum()
  assert abs(up - 9.81 * 0.2) < 0.02, up


@pytest.mark.parametrize('xml', ['sphere visual-only', 'sphere colliding'])
def test_rangefinder_matches_jax_and_mujoco(xml):
  """Rays against box, sphere, capsule, cylinder and plane, and a miss
  (-1), at four yaws as one batch of four: on RANGE_PORT_XML, and on
  RANGE_XML itself, whose head sphere collides with the floor, the wall
  (sphere-box), the ball, the post (sphere-capsule) and the drum
  (sphere-cylinder, refused at load before the physics slice)."""
  mjm, jm, m = _models(RANGE_PORT_XML if xml == 'sphere visual-only'
                       else RANGE_XML)
  types = {tuple(int(m.geom_type[g]) for g in p) for p in m.collision_pairs}
  for pair in ((model_lib.GeomType.SPHERE, model_lib.GeomType.BOX),
               (model_lib.GeomType.SPHERE, model_lib.GeomType.CYLINDER)):
    assert (tuple(map(int, pair)) in types) == (xml == 'sphere colliding')
  yaws = (0.0, 0.4, -1.1, 2.5)
  want, jax_sd = [], []
  for yaw in yaws:
    mjd = mujoco.MjData(mjm)
    mjd.qpos[0] = yaw
    mujoco.mj_forward(mjm, mjd)
    want.append(mjd.sensordata.copy())
    jax_sd.append(_jax_sensordata(
        'range_port' if xml == 'sphere visual-only' else 'range',
        mjd.qpos.copy(), np.zeros(mjm.nv), np.zeros(0)))
  d = fwd.forward(m, _batch(m, [(np.array([y]), np.zeros(1), np.zeros(0))
                                for y in yaws]))
  got = sensors.sensordata(m, d).numpy()
  assert (got == -1.0).any() and (got > 0).any()
  np.testing.assert_allclose(got, np.stack(want), atol=1e-9)
  np.testing.assert_allclose(got, np.stack(jax_sd), atol=1e-12)
  # raycast itself: from above the head straight down onto the floor
  origin = torch.tensor([[0.3, 0.3, 2.0]], dtype=torch.float64)
  down = torch.tensor([[0.0, 0.0, -3.0]], dtype=torch.float64)
  t = support.raycast(m, d.replace(**{k: getattr(d, k)[:1] for k in (
      'geom_xpos', 'geom_xmat')}), origin, down)
  np.testing.assert_allclose(t.numpy(), [2.0], atol=1e-12)


def test_level_rays_miss_the_plane_in_float32_as_in_mujoco():
  """In float32 a level ray's n.dir against the floor is rounding noise
  (~1e-7): the rangefinder reads MuJoCo's -1 for it, not a hit millions
  of metres away (atol 1e-5 against mj_forward at 16 random yaws), and
  the floor alone misses a ray tilted by one such rounding either way."""
  mjm, _, _ = _models(RANGE_PORT_XML)
  jm = put_model(mjm)
  m = model_lib.from_arrays(*export.model_snapshot(jm), device='cpu',
                            dtype=torch.float32)
  yaws = np.random.default_rng(5).uniform(-np.pi, np.pi, 16)
  want = []
  for yaw in yaws:
    mjd = mujoco.MjData(mjm)
    mjd.qpos[0] = yaw
    mujoco.mj_forward(mjm, mjd)
    want.append(mjd.sensordata.copy())
  d = model_lib.make_data(m, len(yaws)).replace(
      qpos=torch.tensor(yaws[:, None], dtype=torch.float32))
  d = fwd.forward(m, d)
  got = sensors.sensordata(m, d).numpy()
  assert (got == -1.0).any()
  np.testing.assert_allclose(got, np.stack(want), atol=1e-5)
  floor = int(np.flatnonzero(np.asarray(m.geom_type) == 0)[0])
  one = d.replace(**{k: getattr(d, k)[:1] for k in ('geom_xpos',
                                                    'geom_xmat')})
  for tilt in (-1.2e-7, 1.2e-7):
    t = support._ray_geom(m, one, floor, torch.tensor([[0.0, 0.0, 0.5]]),
                          torch.tensor([[0.6, 0.8, tilt]]))
    assert float(t[0]) == 1e9, (tilt, t)


def test_inverse_matches_jax_and_mujoco():
  mjm, jm, m = _models(INVERSE_XML)
  rng = np.random.default_rng(0)
  qpos, qvel, qacc, want = [], [], [], []
  for _ in range(2):
    mjd = mujoco.MjData(mjm)
    mjd.qpos[:] = rng.standard_normal(mjm.nq) * 0.3
    mjd.qvel[:] = rng.standard_normal(mjm.nv) * 0.4
    mjd.qacc[:] = rng.standard_normal(mjm.nv) * 1.5
    mujoco.mj_inverse(mjm, mjd)
    qpos.append(mjd.qpos.copy())
    qvel.append(mjd.qvel.copy())
    qacc.append(mjd.qacc.copy())
    want.append(mjd.qfrc_inverse.copy())
  d = model_lib.make_data(m, 2).replace(
      qpos=torch.tensor(np.stack(qpos)), qvel=torch.tensor(np.stack(qvel)),
      qacc=torch.tensor(np.stack(qacc)))
  got = inverse.inverse(m, d)
  np.testing.assert_allclose(got.qfrc_smooth.numpy(), np.stack(want),
                             atol=1e-9)
  jqfrc, jsd = _jax('inverse', qpos[0], qvel[0], qacc[0])
  np.testing.assert_allclose(got.qfrc_smooth.numpy()[0], np.asarray(jqfrc),
                             atol=1e-12)
  np.testing.assert_allclose(sensors.sensordata(m, got).numpy()[0],
                             np.asarray(jsd), atol=1e-12)


def test_support_body_queries_match_jax():
  """body_angvel and subtree_mass (the gyro's and subtree sensors'
  helpers) against JAX's."""
  mjm, jm, m = _models(SENSOR_XML)
  state = (np.array([0.3, -0.1]), np.array([0.7, 0.2]), np.zeros(1))
  _, _, angvel, mass = _jax('sensors', *state)
  d = fwd.forward(m, _batch(m, [state]))
  for b in range(m.nbody):
    np.testing.assert_allclose(support.body_angvel(m, d, b).numpy()[0],
                               np.asarray(angvel[b]), atol=1e-12)
    np.testing.assert_allclose(float(support.subtree_mass(m, b)),
                               float(mass[b]), atol=1e-12)


def test_refusals():
  """An unsupported sensor type is refused when the model loads (JAX's
  put_model refuses it when it compiles); contact forces over elliptic
  cones raise where they are evaluated (ROADMAP A8); the tendon sensors,
  refused here before the physics slice, read JAX's and MuJoCo's
  values."""
  mjm, jm, m = _models(SENSOR_XML)
  arrays, static = export.model_snapshot(jm)
  static = dict(static, sensor_type=[8] + list(static['sensor_type'][1:]))
  with pytest.raises(NotImplementedError, match='unsupported sensor'):
    model_lib.from_arrays(arrays, static, device='cpu', dtype=torch.float64)
  # the tendon sensors, refused before the physics slice, read the
  # tendons: tests/test_tendons.py's COUPLED against JAX's and MuJoCo's
  from tests.test_torch_convex_pairs import golden_file, port_model, xmls
  mjt = mujoco.MjModel.from_xml_string(xmls()['coupled'])
  mjd = mujoco.MjData(mjt)
  mjd.qpos[:], mjd.qvel[:], mjd.ctrl[:] = [0.3, -0.2], [0.5, 0.8], [1.0]
  mujoco.mj_forward(mjt, mjd)
  mt = port_model('coupled')
  assert set(mt.sensor_type) == {sensors.TENDONPOS, sensors.TENDONVEL}
  sd = sensors.sensordata(mt, fwd.forward(mt, _batch(
      mt, [(mjd.qpos.copy(), mjd.qvel.copy(), mjd.ctrl.copy())])))
  np.testing.assert_allclose(sd.numpy(),
                             golden_file()['coupled/fwd/sensordata'],
                             rtol=1e-8, atol=1e-10)
  np.testing.assert_allclose(sd[0].numpy(), mjd.sensordata, atol=1e-12)
  _, _, mb = _models(FORCE_PLANE_XML)
  elliptic = mb.replace(opt=mb.opt.replace(cone=1))
  db = model_lib.make_data(mb)
  with pytest.raises(NotImplementedError, match='elliptic'):
    constraint.contact_forces(elliptic, db)


def test_sensor_models_snapshot_is_current():
  fresh = export.sensor_model_arrays()
  hint = ': stale; run python tools/export_torch_snapshot.py --sensor-models'
  with np.load(os.path.join(port_registry.ASSETS, export.SENSOR_MODELS),
               allow_pickle=False) as z:
    assert sorted(z.files) == sorted(fresh), hint
    for k, v in fresh.items():
      np.testing.assert_array_equal(z[k], v, err_msg=k + hint)


@pytest.mark.slow
def test_jax_calls_golden_is_jaxs():
  """The recorded JAX calls are what the JAX package computes now."""
  _REC.check_live()
