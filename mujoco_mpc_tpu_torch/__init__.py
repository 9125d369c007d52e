"""PyTorch + CUDA port of mujoco_mpc_tpu (the JAX package beside it).

Each module mirrors one module of `mujoco_mpc_tpu` and names it in its
docstring. Physics, planner and cost code are plain functions on
batch-first tensors; the two Pallas kernels of the JAX package are CUDA
C++ kernels for Hopper under `csrc/`, each with its plain PyTorch version
beside its wrapper (`ops/spd_solve.py`, `ops/newton.py`).
"""
