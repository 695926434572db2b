"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything that belongs to one configuration, traffic mix,
per-layer metric or cell's limits is a file of its own, found by name:
``configs/<config>.json``, ``traffic/<mix>.json`` (whose ``driver`` names
``drivers/<driver>.py``), ``metrics/<metric>.py`` and
``limits/<cell>.json``.  The yardstick (the input makers, the operation
and byte counts, the peaks, the plain references and the comparisons) is
frozen here; from the program it takes only the system under test.
"""
