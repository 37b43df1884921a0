"""The benchmark of ``ncf_tpu_torch``, the PyTorch/CUDA port.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and
prints its result as the last line of standard output.  Everything a
cell needs is found by name: its configuration in ``configs/``, its
traffic mix in ``traffic/``, its per-layer metrics in ``metrics/``.
Nothing here imports JAX or the JAX package.
"""
