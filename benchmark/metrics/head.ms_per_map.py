"""Device milliseconds of the kernels under the evidential head's ranges
(``evidential.volumes``, ``.dres``, ``.hourglass_up``, ``.hourglass``,
``.classify``, which follow one another), per map."""


def read(summary):
    seconds = sum(s for name, s in summary["range_s"].items() if name.startswith("evidential."))
    maps = summary.get("maps")
    return seconds / maps * 1e3 if seconds and maps else None
