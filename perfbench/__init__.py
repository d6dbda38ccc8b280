"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``. Everything a cell
needs is found by name: its configuration (``configs/<name>.json``), its
traffic mix (``traffic/<name>.json``, whose ``loop`` names the loop kind
in ``loops/``), its correctness limits (``limits/<workload>.json``) and
one reader a per-layer metric (``metrics/<metric>.py``).

Nothing here imports JAX or the JAX package ``repro``; the plain
reference (``reference/``), the weights, the traffic generator and the
counts (``counts.py``) import nothing of ``repro_torch`` either.
"""
