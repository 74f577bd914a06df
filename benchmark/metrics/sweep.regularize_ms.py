"""Device milliseconds of the kernels under the ``sweep.regularize`` range
(one ConvLSTM U-Net step with its gate kernels), per depth step."""


def read(summary):
    seconds = summary["range_s"].get("sweep.regularize")
    steps = summary.get("depth_steps")
    return seconds / steps * 1e3 if seconds and steps else None
