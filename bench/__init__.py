"""The port's benchmark: one cell of ``BENCHMARK.json`` run once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything a cell needs is found by name: ``configs/<config>.json``,
``workloads/<traffic>.json`` (whose ``kind`` names ``traffic/<kind>.py``),
``families/<family>.py`` and ``reference/<family>.py`` for the config's
family, and ``metrics/<metric>.py`` for each metric, or the reader that
metrics of one kind share, ``metrics/<metric before its first dot>.py``. The benchmark imports
the port (``repro_torch``) and never JAX or the JAX package.
"""
