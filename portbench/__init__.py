"""portbench: the benchmark of the PyTorch and CUDA port (``repro_torch``).

One command runs one cell once::

    python3 portbench/run.py --workload <config>.<traffic> --seed <n> \\
        --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix or metric is a
file of its own (``configs/``, ``traffic/``, ``metrics/``, ``checks/``),
found by the names in ``BENCHMARK.json``.  Nothing here imports JAX or the
JAX package; the plain reference (``reference.py``) imports nothing of the
port either.
"""
