"""Device milliseconds of the kernels under the ``sweep.omega`` range (each
source view's omega network on its squared residual), per depth step."""


def read(summary):
    seconds = summary["range_s"].get("sweep.omega")
    steps = summary.get("depth_steps")
    return seconds / steps * 1e3 if seconds and steps else None
