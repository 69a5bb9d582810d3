"""The plain reference the benchmark's correctness check holds the port
against: f32 PyTorch and NumPy, written for the benchmark, importing
nothing of the port and taking nothing the port made."""
