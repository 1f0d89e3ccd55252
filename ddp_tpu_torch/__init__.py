"""ddp_tpu_torch — the PyTorch/CUDA port of ddp_tpu, for NVIDIA Hopper.

A package of its own beside the JAX package ``ddp_tpu``, which stays
the reference: module names mirror it (``models/lm``,
``models/generate``, ``ops/decode``, ``serve/engine`` ...), and every
TPU kernel on a ported path is a hand-written CUDA kernel under
``ops/csrc``. It imports ``torch`` and never ``jax`` or ``ddp_tpu``.

The first slice is serving: ``python -m ddp_tpu_torch.serve``. Entry
points run on the GPU unless the caller passes ``device="cpu"``.
"""

from ddp_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
