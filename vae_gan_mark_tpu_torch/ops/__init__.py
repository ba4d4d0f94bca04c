"""Tensor ops and the GRU kernel."""
