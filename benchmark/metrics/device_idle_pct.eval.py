"""Share of the traced window in which no operation runs on the device:
the window's span less the union of the device operations' intervals,
over the span, in percent."""


def read(summary):
    window = summary["window_s"]
    return (window - summary["busy_s"]) / window * 100.0 if window > 0 else None
