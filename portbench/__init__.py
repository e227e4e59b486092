"""The benchmark of the PyTorch and CUDA port (``dstack_tpu_torch``).

``python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card it is
started on.  Nothing here imports JAX or the JAX package.
"""
