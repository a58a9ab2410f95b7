"""The synthetic training data stream (``pipeline``)."""
