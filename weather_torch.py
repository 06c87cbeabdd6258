#!/usr/bin/env python
"""Repo-root launcher for the PyTorch port's CLI: ``python weather_torch.py pmg --mode ...``
(classifier, benchmark, inference, folder, watch_folder, camera, serve,
export, train; ``--device cpu`` off the card)."""

import sys

from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
