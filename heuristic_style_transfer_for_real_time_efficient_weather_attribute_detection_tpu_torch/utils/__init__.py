"""Utilities of the port: golden-fixture parity walks."""
