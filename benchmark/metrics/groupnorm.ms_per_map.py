"""Device milliseconds of the kernels under the ``groupnorm`` range (every
GroupNorm of the core: FeatNet's, omega's and the regularizer's, from its
statistics to its affine), per map."""


def read(summary):
    seconds = summary["range_s"].get("groupnorm")
    maps = summary.get("maps")
    return seconds / maps * 1e3 if seconds and maps else None
