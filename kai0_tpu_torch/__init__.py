"""PyTorch + CUDA port of the π₀.₅ serving path, for NVIDIA Hopper (H100).

The JAX package ``kai0_tpu`` is the reference this package is held against; the
module layout mirrors it (``ops/masks.py``, ``ops/attention.py``,
``models/{siglip,gemma,model,pi0}.py``, ``policies/policy.py``). Parameter names
follow the ``PI0Pytorch`` state-dict layout that
``kai0_tpu.interop.torch_safetensors.jax_to_torch_state`` emits.

Attention runs through two hand-written CUDA kernels (``ops/csrc/``), built with
``nvcc`` at first use (``ops/_build.py``). Tensors on the CPU take the kernels'
plain PyTorch versions; there is no other fallback.

This package imports neither ``jax`` nor anything from ``kai0_tpu``.
"""
