"""The benchmark of ``sparse_matrix_mult_tpu_torch`` on NVIDIA GPUs.

``python smmbench/run.py --workload NAME --seed N --seconds S --trace 0|1``
runs one cell of ``BENCHMARK.json``.  Each cell names a configuration
(``configs/<name>.json``: the operands' shapes and entry counts) and a
traffic mix (``traffic/<name>.json``: which entry of the port it calls and
with what); each metric is a reader (``metrics/<name>.py``); each cell's
map from kernel names to stages is ``kernel_maps/<cell>.json``.  The plain
references that decide ``correct`` are in ``reference/`` and import
nothing of the port.
"""
