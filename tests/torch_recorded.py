"""A JAX function replayed from a file of its recorded calls, for the
port's CPU tests.

A contact task's jitted JAX step takes 45-100 s to trace and compile on a
CPU, more than the rest of its test file. The tests that hold the port's
step to it make their own inputs (numpy, seeded, or from the port's
planner) and call it a few times; `Recorded` answers each call with the
outputs stored for the recorded call whose inputs equal these within
rtol 1e-12 / atol 1e-14 (rounding of the inputs' last bits on another
CPU), and raises for inputs it has not recorded.

With the environment variable MJPC_TORCH_RECORD set, it builds the live
function instead, calls it, records each call and writes the file when
the test module ends; in one process, since each pytest-xdist worker
would write only its own calls:

    MJPC_TORCH_RECORD=1 JAX_PLATFORMS=cpu python -m pytest \\
        tests/test_torch_humanoid.py -m 'not slow'

Each file that records has a slow test that calls the live function on
every recorded input and holds its outputs to the file (`check_live`).

`RecordedJax` does the same for jitted JAX functions of pytrees (planner
states, configs, PRNG keys), named, so that one file holds a test
module's calls of several: a call's inputs are the function's name and
its arguments' leaves; its outputs, the result's leaves with the tree
structures of arguments and result (pickled PyTreeDefs).
"""

import os
import pickle

import numpy as np

RECORD = 'MJPC_TORCH_RECORD'


class Recorded:
  """Calls of a function of numpy arrays returning a dict of arrays,
  replayed from `path`, or recorded from `make_live()` (the function,
  built only when needed) when MJPC_TORCH_RECORD is set."""

  def __init__(self, path, make_live):
    self.path, self.make_live = path, make_live
    self.recording = bool(os.environ.get(RECORD))
    if self.recording and os.environ.get('PYTEST_XDIST_WORKER'):
      raise RuntimeError(f'{RECORD}: record in one process, without -n')
    self.calls = []       # [(inputs, outputs)]
    self._live = None
    if not self.recording:
      with np.load(path) as z:
        self.calls = [
            ([z[f'{i}/in/{j}'] for j in range(int(z[f'{i}/inputs']))],
             {k.split('/', 2)[2]: z[k] for k in z.files
              if k.startswith(f'{i}/out/')})
            for i in range(int(z['calls']))]

  def live(self):
    if self._live is None:
      self._live = self.make_live()
    return self._live

  def __call__(self, *args):
    args = [np.asarray(a) for a in args]
    if self.recording:
      out = {k: np.asarray(v) for k, v in self.live()(*args).items()}
      self.calls.append((args, out))
      return out
    for inputs, out in self.calls:
      if len(inputs) == len(args) and all(
          a.shape == b.shape and np.allclose(a, b, rtol=1e-12, atol=1e-14)
          for a, b in zip(args, inputs)):
        return out
    raise KeyError(f'{os.path.basename(self.path)} has no call with these '
                   f'inputs: record it anew with {RECORD}=1 (tests/'
                   f'torch_recorded.py)')

  def save(self):
    arrays = {'calls': np.asarray(len(self.calls))}
    for i, (inputs, out) in enumerate(self.calls):
      arrays[f'{i}/inputs'] = np.asarray(len(inputs))
      arrays.update({f'{i}/in/{j}': a for j, a in enumerate(inputs)})
      arrays.update({f'{i}/out/{k}': v for k, v in out.items()})
    np.savez(self.path, **arrays)

  def check_live(self):
    """Every recorded call, made live: the outputs the file holds (rtol
    1e-10, atol 1e-12, as the other goldens' slow tests)."""
    assert self.calls
    for inputs, out in self.calls:
      got = self.live()(*inputs)
      for k, v in out.items():
        np.testing.assert_allclose(np.asarray(got[k]), v, rtol=1e-10,
                                   atol=1e-12, err_msg=k)


def _pickled(obj):
  return np.frombuffer(pickle.dumps(obj), np.uint8)


def _unpickled(arr):
  return pickle.loads(np.asarray(arr, np.uint8).tobytes())


def _flat_leaves(tree):
  """(numpy leaves, key mask, structure) of a pytree: a typed PRNG key
  leaf as its key data."""
  import jax
  import jax.numpy as jnp
  leaves, struct = jax.tree.flatten(tree)
  keys = [jnp.issubdtype(getattr(x, 'dtype', np.float64),
                         jax.dtypes.prng_key) for x in leaves]
  return ([np.asarray(jax.random.key_data(x) if k else x)
           for x, k in zip(leaves, keys)], np.asarray(keys, bool), struct)


def _tree(leaves, keys, struct):
  import jax
  import jax.numpy as jnp
  return jax.tree.unflatten(struct, [
      jax.random.wrap_key_data(jnp.asarray(x)) if k else jnp.asarray(x)
      for x, k in zip(leaves, keys)])


class RecordedJax:
  """Named JAX functions of pytrees, called as `rec(name, *args,
  **kwargs)` and replayed from `path` (or recorded from
  `make_live()`, a dict of the functions, built only when needed)."""

  def __init__(self, path, make_live):
    self._in = None       # (key mask, structure) of the call being recorded
    self.recorded = Recorded(path, lambda: self._flat(make_live()))

  @property
  def recording(self):
    return self.recorded.recording

  def _flat(self, fns):
    def call(name, *leaves):
      keys, struct = self._in
      args, kwargs = _tree(leaves, keys, struct)
      out, out_keys, out_struct = _flat_leaves(
          fns[bytes(name).decode()](*args, **kwargs))
      return {'in_keys': keys, 'in_tree': _pickled(struct),
              'keys': out_keys, 'tree': _pickled(out_struct),
              **{f'leaf/{i}': x for i, x in enumerate(out)}}
    return call

  def __call__(self, name, *args, **kwargs):
    leaves, keys, struct = _flat_leaves((args, kwargs))
    self._in = (keys, struct)
    out = self.recorded(np.frombuffer(name.encode(), np.uint8), *leaves)
    n = len([k for k in out if k.startswith('leaf/')])
    return _tree([out[f'leaf/{i}'] for i in range(n)], out['keys'],
                 _unpickled(out['tree']))

  def save(self):
    self.recorded.save()

  def check_live(self):
    """Every recorded call made live: the leaves the file holds (rtol
    1e-10, atol 1e-12) and the same structure."""
    rec = self.recorded
    assert rec.calls
    for inputs, out in rec.calls:
      self._in = (out['in_keys'], _unpickled(out['in_tree']))
      got = rec.live()(*inputs)
      assert _unpickled(got['tree']) == _unpickled(out['tree'])
      for k, v in out.items():
        if k.startswith('leaf/'):
          np.testing.assert_allclose(np.asarray(got[k]), v, rtol=1e-10,
                                     atol=1e-12, err_msg=k)
