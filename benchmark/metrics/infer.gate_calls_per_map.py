"""``pick_packed_rows`` calls of ``run_inference``'s packed gate, the mean
over the window's maps (its ``gate_calls``): one a map under the defaults,
up to four under the super-pack and 6x6 levers, each a host pass over
every pixel of every source view."""


def read(summary):
    calls = summary.get("gate_calls")
    return sum(calls) / len(calls) if calls else None
