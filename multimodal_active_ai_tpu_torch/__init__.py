"""Multimodal-Active-AI on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch counterpart of :mod:`multimodal_active_ai_tpu`, module for
module: the same subpackage names (``ops/ models/ objectives/ train/ data/
utils/``), the same public layouts (NHWC glimpses ``(B, 30, 30, 12)``, a
channel-major ``(B, 3L, P)`` sampler output, the same ``AugParams``
fields), so each module can be held against its JAX twin on equal inputs.

It imports ``torch`` and never JAX or the JAX package. The retina's glimpse
sampler is a hand-written CUDA kernel (``csrc/glimpse_sample.cu``), built
with ``nvcc`` at first use; everything else is plain PyTorch.

Entry points run on ``cuda`` unless the caller asks for ``cpu``; library
functions follow the device of their inputs.
"""

__version__ = "0.1.0"
