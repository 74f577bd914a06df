"""Device milliseconds of the kernels under the ``sweep.warp`` range (each
source view's warp gather with its blend and, where fused, its squared
residual), per depth step."""


def read(summary):
    seconds = summary["range_s"].get("sweep.warp")
    steps = summary.get("depth_steps")
    return seconds / steps * 1e3 if seconds and steps else None
