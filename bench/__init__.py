"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON line.
Every configuration, traffic mix, driver kind and per-layer metric is a
file of its own here, found by the name ``BENCHMARK.json`` gives it. The
plain reference that decides ``correct`` is ``bench/reference``.
"""
