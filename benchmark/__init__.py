"""The benchmark of ``diasss_tpu_torch``, the PyTorch and CUDA port.

``python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1``
runs one cell of ``BENCHMARK.json`` on the card and prints one JSON line.
Everything a cell is made of is found by name (:mod:`.registry`): its
configuration in ``configs/<config>.json``, its traffic in
``traffic/<mix>.json``, each per-layer metric's reader in
``metrics/<metric>.py``, and the plain reference that decides ``correct``
in the module that the configuration names (``plainref.py`` for
``anno20``).
"""
