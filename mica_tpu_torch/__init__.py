"""MICA in PyTorch for NVIDIA Hopper: the port of ``mica_tpu``.

The map -> BB/CA/AA probability path (``infer.pipeline.predict_map``)
with hand-written CUDA and Triton kernels for the fused conv +
InstanceNorm and the depthwise conv.  Entry points run on the card unless
given ``device="cpu"``, where every kernel wrapper takes its plain
PyTorch version.  Kernels build on first use (``ops/_build.py``).
"""

__version__ = "0.1.0"
