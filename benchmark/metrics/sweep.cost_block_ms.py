"""Device milliseconds of the kernels under the ``sweep.cost_block`` range
(warp, squared residual, omega, view mean), per depth step."""


def read(summary):
    seconds = summary["range_s"].get("sweep.cost_block")
    steps = summary.get("depth_steps")
    return seconds / steps * 1e3 if seconds and steps else None
