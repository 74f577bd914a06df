"""PyTorch/CUDA port of aa_rmvsnet_tpu for NVIDIA Hopper (H100).

The JAX package ``aa_rmvsnet_tpu`` is the unchanged reference; this package
imports nothing of it and nothing of JAX.  Layers mirror the reference:
``core`` (file formats, cameras, samplers, transforms), ``ops`` (geometry,
sampling, and the hand-written CUDA kernels under ``csrc``), ``models``
(the 187,203-parameter AA-RMVSNet core and its depth sweep), ``data``,
``pipeline`` (inference and training drivers, checkpoints) and ``cli``.
"""
