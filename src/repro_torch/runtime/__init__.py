"""Fault tolerance of the training loop (``fault_tolerance``) and the
elastic mesh plan the membership driver prices (``elastic``)."""
