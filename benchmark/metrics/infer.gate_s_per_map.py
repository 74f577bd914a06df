"""Host seconds of ``run_inference``'s packed gate, the mean over the
window's maps (its ``gate_seconds``)."""


def read(summary):
    gates = summary.get("gate_seconds")
    return sum(gates) / len(gates) if gates else None
