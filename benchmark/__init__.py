"""The benchmark of ``circuits_halo2_tpu_torch``, the PyTorch and CUDA port.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once (``run.py``). Everything that belongs to
one configuration, traffic mix or per-layer metric is a file of its own,
found by the name ``BENCHMARK.json`` gives it: ``configs/<config>.json``,
``traffic/<mix>.json`` (whose ``entry`` names ``loops/<entry>.py``) and
``metrics/<metric>.py``. ``reference/`` is the plain reference the
judgement holds the program to; it imports nothing of the port.
"""
