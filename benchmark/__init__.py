"""The benchmark of ``dbcsr_tpu_torch`` on NVIDIA H100 cards.

``python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace 0|1``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. The
harness is driven by data: a configuration is ``configs/<name>.json``, a
traffic mix ``traffic/<name>.json``, a per-layer metric ``metrics/<name>.py``;
each is found by the name that ``BENCHMARK.json`` gives. The yardstick lives
here too: the pattern and data maker (``pattern.py``), the work count of the
roofline (``workcount.py``, ``peaks.json``), the trace reduction
(``trace.py``) and the plain reference that decides ``correct``
(``reference/``).
"""
