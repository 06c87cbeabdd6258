"""Workloads of the port: evaluation (classifier mode), external benchmark,
folder inference and the watch-folder service, the camera/stream path,
training, serving, explainability (Grad-CAM and integrated gradients,
``explain``) and patch-Gram style transfer (``style_transfer``)."""
