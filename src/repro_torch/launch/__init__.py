"""Serving steps of the port on one device."""
