"""``lstm_gates_roofline.eval``'s reading, of the training cells' window."""

from benchmark.manifest import reader

read = reader("lstm_gates_roofline.eval")
