"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on one NVIDIA card and
prints one JSON line last.  Everything here that decides a number (the
generators, the query semantics, the codec, the comparison, the peaks and
the roofline's byte count) is this package's own: it imports nothing of
``repro_torch`` and takes from the program only the system under test, its
results, spans and counters, and the profiler's trace of the card.
"""
