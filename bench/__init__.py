"""The benchmark of the PyTorch and CUDA port (``repro_torch``): tenants
served through its ``ServingGateway`` on one card, driven from
``BENCHMARK.json`` at the root of the repository.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once and prints one JSON line last. A cell
is a configuration (``configs/<name>.json``) under a traffic mix
(``traffic/<name>.json``); each per-layer metric is a reader of its own
(``metrics/<name>.py``). Nothing here imports JAX or the JAX package, and
the plain reference (``reference/``) imports nothing of the port.
"""
