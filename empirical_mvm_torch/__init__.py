"""PyTorch/CUDA port of empirical_mvm_tpu for NVIDIA Hopper (H100).

The JAX package beside it is the reference. This package imports torch and
never jax or empirical_mvm_tpu. Its hand-written CUDA kernels live in
``csrc/`` and build at first use (``ops/_build.py``).
"""
