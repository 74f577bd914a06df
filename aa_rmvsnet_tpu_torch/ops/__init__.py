"""Tensor ops of the port: plane-sweep geometry, patch-table sampling,
deformable convolution, align-corners resize, the ConvLSTM gate kernels,
forward and backward (``gates``), fusion's reproject-and-vote kernel
(``fusion``; CUDA sources in ``csrc/``) and cv2's resize and pyrDown for
fusion (``image``)."""
