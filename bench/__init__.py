"""The benchmark of the PyTorch/CUDA port: LIMIT queries served by ``repro_torch``.

``python bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` on the card and prints one JSON line.
Each configuration (``configs/``), table layout (``layouts/``), traffic mix
(``traffic/``), cell (``cells/``) and per-layer metric (``metrics/``) is a
file of its own, found by the name ``BENCHMARK.json`` gives it.  The plain
reference that decides ``correct`` is in ``reference/`` and imports nothing
of the program.
"""
