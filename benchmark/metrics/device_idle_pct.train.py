"""``device_idle_pct.eval``'s reading, of the training cells' window."""

from benchmark.manifest import reader

read = reader("device_idle_pct.eval")
