"""Tensor ops of the port: plane-sweep geometry, patch-table sampling,
deformable convolution, align-corners resize, and the ConvLSTM gate kernel
(``gates``; CUDA source in ``csrc/``)."""
