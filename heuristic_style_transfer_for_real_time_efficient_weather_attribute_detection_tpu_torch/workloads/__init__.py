"""Workloads of the port: the camera/stream path."""
