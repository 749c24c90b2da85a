"""The benchmark of the PyTorch port ``virtex_tpu_torch`` on NVIDIA cards.

``python3 -m portbench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``; see ``harness.py``.
Nothing here imports JAX or the JAX package.
"""
