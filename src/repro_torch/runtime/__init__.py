"""Fault tolerance of the training loop (``fault_tolerance``)."""
