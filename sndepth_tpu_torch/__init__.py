"""PyTorch + CUDA port of ``sndepth_tpu`` for NVIDIA Hopper.

The JAX package ``sndepth_tpu`` is the reference; this package mirrors its
layout (``core/``, ``ops/``, ``kernels/``, ``models/``, ``losses/``,
``train/``, ``data/``, ``utils/``, ``cli/``) and imports ``torch``, never
``jax``. Tensors are NCHW unless a docstring says otherwise.
"""
