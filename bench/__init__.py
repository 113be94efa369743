"""The port's benchmark: one cell of ``BENCHMARK.json`` a run.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Configurations (``configs/``), traffic mixes (``traffic/``), a cell's own
numbers (``cells/``) and metric readers (``metrics/``) are files found by
the names in ``BENCHMARK.json``. ``reference/`` is the plain f32 model that
decides ``correct``; it imports nothing of the program.
"""
