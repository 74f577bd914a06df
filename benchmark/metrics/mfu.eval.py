"""The whole step's share of the card's peak: for each precision the
model FLOPs the window's work needs (``benchmark/flops.py``, from shapes)
over that precision's peak (``benchmark/peaks.json``), summed, over the
window's seconds, in percent: the least time the card could take over the
time it took."""


def read(summary):
    peaks = summary.get("peaks")
    if not peaks or not summary.get("flops") or summary["window_s"] <= 0:
        return None
    least_s = sum(f / peaks["flops"][dtype] for dtype, f in summary["flops"].items())
    return least_s / summary["window_s"] * 100.0
