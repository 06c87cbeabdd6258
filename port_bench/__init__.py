"""The benchmark of the PyTorch and CUDA port on one NVIDIA H100.

``BENCHMARK.json`` at the root names its cells; each is a configuration
(``configs/<name>.json``), a traffic mix (``traffic/<name>.json``, whose
``driver`` names ``drivers/<driver>.py``) and the limits of its
correctness check (``limits/<cell>.json``); each per-layer metric is a
reader in ``layer_metrics/<metric>.py``, or in the file of the quantity
before its first dot (``idle_pct.py`` reads ``idle_pct.infer`` and
``idle_pct.train``).  ``reference/`` holds the plain
PyTorch models the check holds the program to, ``families/`` what a run
needs to know of each model family beside it.  A run::

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The tests (``python -m pytest port_bench/tests``) run tiny cells on the
CPU; ``python3 -m port_bench.calibrate`` reads the limits' readings on the
card.
"""
