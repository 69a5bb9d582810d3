"""The port's counterparts of the JAX package's kernel scripts
(``scripts/distill_ew_crash.py``, ``scripts/bench_in_apply.py``,
``scripts/probe_layout_boundary.py``), run as
``python -m mica_tpu_torch.scripts.<name>``."""
