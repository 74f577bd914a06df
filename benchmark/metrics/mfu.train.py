"""``mfu.eval``'s reading, of the training cells' window."""

from benchmark.manifest import reader

read = reader("mfu.eval")
