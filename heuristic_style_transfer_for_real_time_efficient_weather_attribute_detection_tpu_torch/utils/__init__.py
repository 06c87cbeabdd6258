"""Utilities of the port: golden-fixture parity walks, metrics in numpy,
parameter counts."""
