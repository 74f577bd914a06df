"""Device milliseconds of the kernels under the ``head.deconv`` range (each
transposed 3D convolution of the evidential head), per map."""


def read(summary):
    seconds = summary["range_s"].get("head.deconv")
    maps = summary.get("maps")
    return seconds / maps * 1e3 if seconds and maps else None
