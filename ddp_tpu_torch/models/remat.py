"""Activation checkpointing of one block (``--remat``; the JAX models'
``nn.remat`` of each residual or encoder block,
``ddp_tpu/models/resnet.py:117``, ``vit.py:275``, ``moe.py:257-258``).

:func:`remat_block` runs ``block(*args)`` under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: the forward
keeps only the block's inputs, and the backward runs the block again to
rebuild its activations. The forward runs twice, so a module with state
that the forward updates must not update it on the second run: while
the block is recomputed, every submodule with a ``recomputing``
attribute (the ResNet's :class:`~ddp_tpu_torch.models.resnet.BatchNorm`,
whose running statistics advance once a step) sees it True.
"""

from __future__ import annotations

import contextlib

from torch.utils.checkpoint import checkpoint


def remat_block(block, *args):
    """``block(*args)``, its activations recomputed in the backward."""

    @contextlib.contextmanager
    def recomputing():
        marked = [m for m in block.modules() if hasattr(m, "recomputing")]
        for m in marked:
            m.recomputing = True
        try:
            yield
        finally:
            for m in marked:
                m.recomputing = False

    return checkpoint(block, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          recomputing()))
