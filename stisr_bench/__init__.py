"""The benchmark of ``tatt_tpu_torch``, the PyTorch and CUDA port of TATT.

``python3 -m stisr_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card.  Each
configuration (``configs/``), cell (``workloads/``), traffic mix
(``mixes/``, with its driver in ``drivers/``) and per-layer metric
(``metrics/``, with a kernel roofline's spec beside it and its bound in
``bounds/``) is a file of its own, found by its name in the manifest.
``reference/`` is the plain PyTorch reference that decides ``correct``,
one file an arch in ``reference/archs/``; ``calibrate.py`` takes the
readings that the limits were set from.
"""
