"""The benchmark of ``mica_tpu_torch`` on an NVIDIA H100.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once and prints one JSON line.  A cell is
``workloads/<cell>.json`` (its configuration, its traffic and the limits of
its correctness check); the configuration is ``configs/<name>.json``, the
traffic mix ``traffic/<name>.json`` (read by the module its ``driver`` key
names, ``drivers/<driver>.py``), and each metric ``metrics/<name>.py``.
Nothing here imports ``jax`` or the JAX package; ``reference/`` imports
nothing of the port either.
"""
