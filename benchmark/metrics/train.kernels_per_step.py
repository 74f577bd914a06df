"""Device kernels launched per training step in the window."""


def read(summary):
    steps = summary.get("steps")
    return summary["kernels"] / steps if summary["kernels"] and steps else None
