"""Checkpoint loading and the batch execution engine of the port."""
