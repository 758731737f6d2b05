"""The benchmark of ``deformationpyramid_tpu_torch``, the PyTorch and CUDA
port: ``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own that the harness finds by the name
in ``BENCHMARK.json``: ``configs/<config>.json``,
``traffic/<traffic>.json`` (which names its driver,
``drivers/<driver>.py``) and ``metrics/<metric>.py``. ``reference/`` is the
plain PyTorch / NumPy reference that decides ``correct``; it imports
nothing of the port.
"""
