"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and prints
one JSON result line. Everything a cell is made of is found by name:
``configs/<config>.json`` (sizes, engine settings, the check's limit and
the plain reference that goes with them), ``traffic/<mix>.json`` (the
parameters of ``gen.py``'s one generator) and ``metrics/<metric>.py``
(one reader a metric). Nothing here imports ``jax`` or the JAX package
``repro``; the system under test is ``repro_torch``.
"""
