"""The benchmark of ``diasss_tpu_torch``, the PyTorch and CUDA port.

``python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1``
runs one cell of ``BENCHMARK.json`` on the card and prints one JSON line.
Everything a cell is made of is found by name: its configuration in
``configs/<config>.json``, its traffic in ``traffic/<mix>.json`` and each
per-layer metric's reader in ``metrics/<metric>.py``.  ``plainref.py`` is
the plain reference that decides ``correct``.
"""
