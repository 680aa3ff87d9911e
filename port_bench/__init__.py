"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the CUDA card
and prints one JSON line.  Every configuration, traffic mix, check and
per-layer metric is a file of its own, found by the name
``BENCHMARK.json`` gives it (see ``cell.py``).
"""
