"""Workloads of the port: evaluation (classifier mode), external benchmark,
folder inference and the watch-folder service, the camera/stream path
(float32 and bf16), training, serving, explainability (Grad-CAM and
integrated gradients, ``explain``), patch-Gram style transfer
(``style_transfer``), and embeddings with t-SNE and HDBSCAN clustering
(``embed``)."""
