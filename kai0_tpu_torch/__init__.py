"""PyTorch + CUDA port of π₀.₅ serving and fine-tuning, for NVIDIA Hopper (H100).

The JAX package ``kai0_tpu`` is the reference this package is held against; the
module layout mirrors it (``ops/``, ``models/``, ``transforms.py``, ``shared/``,
``policies/`` with ``policy_config.create_trained_policy``, ``serving/``,
``training/``). Parameter names follow the ``PI0Pytorch`` state-dict layout
that ``kai0_tpu.interop.torch_safetensors.jax_to_torch_state`` emits.

The eight kernels of the JAX package's Pallas code are hand-written CUDA
(``ops/csrc/``), built with ``nvcc`` at first use (``ops/_build.py``). Tensors
on the CPU take the kernels' plain PyTorch versions; there is no other
fallback.

This package imports neither ``jax`` nor anything from ``kai0_tpu``.
"""
