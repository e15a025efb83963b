"""The benchmark of the PyTorch and CUDA port (``intro_tc_vae_tpu_torch``).

``python3 perfbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything one configuration, traffic mix, cell or per-layer
metric needs is a file of its own under this directory, found by name
(``core/spec.py``).
"""
