"""The port's counterparts of the JAX package's scripts, run as
``python -m mica_tpu_torch.scripts.<name>``: the kernel scripts
(``scripts/distill_ew_crash.py``, ``scripts/bench_in_apply.py``,
``scripts/probe_layout_boundary.py``), the synthetic fixture trainer
(``scripts/train_synth_fixture.py``) and the synthetic demo
(``examples/synthetic_demo.py``)."""
