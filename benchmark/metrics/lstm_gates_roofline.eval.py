"""The ConvLSTM gate kernels' share of their roofline: the bytes the gate
calls need (each input read once, each output written once, from their
shapes, ``gate_bytes``) over the card's memory rate, over the device time
of the ``lstm_gates`` kernels (forward and backward), in percent."""


def read(summary):
    peaks = summary.get("peaks")
    seconds = sum(s for name, (_, s) in summary["ops"].items() if "lstm_gates" in name)
    if not peaks or not seconds or not summary.get("gate_bytes"):
        return None
    return summary["gate_bytes"] / peaks["hbm_bytes_per_s"] / seconds * 100.0
