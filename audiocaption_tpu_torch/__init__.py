"""PyTorch / CUDA port of ``audiocaption_tpu`` for NVIDIA Hopper (H100).

The JAX package next to this one is the reference: every module here
mirrors its counterpart there (``ops/``, ``models/``, ``decoding/``,
``hf_api.py``, ``serving.py``) and is held against it by the
``tests/test_torch_*.py`` parity tests.  This package imports ``torch``
and ``numpy`` only, never ``jax``, ``flax`` or ``audiocaption_tpu``.

Entry points run on ``device="cuda"`` unless the caller asks for
``device="cpu"``; see :func:`audiocaption_tpu_torch.device.resolve_device`.
"""

__version__ = "0.1.0"
