"""perfbench — the benchmark of ``repro_torch`` (the PyTorch + CUDA port).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on an NVIDIA card
and prints one JSON result line.  Everything here is found by name:
``configs/<config>.json``, ``traffic/<traffic>.json`` (which names its
entry, ``entries/<entry>.py``), ``metrics/<metric>.py`` and
``limits/<workload>.json``.  The plain references live in ``reference/``
and import nothing of the port.
"""
