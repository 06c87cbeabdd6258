"""Workloads of the port: evaluation (classifier mode), external benchmark,
folder inference and the watch-folder service, and the camera/stream path."""
