"""The benchmark of ``volpick_tpu_torch``, the PyTorch and CUDA port.

``python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once on the card and prints one JSON
line. Everything that belongs to one configuration, traffic mix or
per-layer metric sits in a file of its own under ``configs/``, ``mixes/``
and ``metrics/``, found by the name the manifest gives.
"""
