"""The benchmark harness: inputs and weights from the seed, the windows
that drive the program, the trace reduction and the comparison that decides
``correct``."""
