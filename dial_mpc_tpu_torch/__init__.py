"""DIAL-MPC on PyTorch and CUDA.

A second implementation of the planner, the task environments and the
MuJoCo-semantics physics engine, beside the JAX package ``dial_mpc_tpu``.
Plain tensor code is PyTorch with the sample axis written out as a leading
batch dimension; the whole-physics-step kernel is CUDA C++ under ``csrc/``.
This package imports ``torch``, never ``jax``.
"""

__version__ = "0.1.0"
