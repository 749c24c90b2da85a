r"""
Activation rematerialisation: a module's forward is run again in the
backward instead of keeping its activations.

Counterpart of ``nn.remat`` in the JAX package (``MODEL.VISUAL.REMAT`` on
each residual block, ``MODEL.TEXTUAL.REMAT`` on each decoder layer). It is
a pure memory-for-operations trade: the recomputed forward is the first
one, bit for bit, and the step's results are those of a plain step.
``jax.checkpoint`` replays a pure function; ``torch.utils.checkpoint``
reruns a module that draws from generators and writes buffers, so
:func:`remat` makes the rerun pure in two ways:

- **dropout replay**: the recomputation starts the caller's
  ``torch.Generator`` (the one that draws the dropout masks and the
  attention kernel's seed) from its state before the first run, and gives
  the generator back afterwards in the state the backward found it in. So
  the recomputation draws the same masks and seed, and the generator ends
  the step where a plain step leaves it (``checkpoint``'s
  ``preserve_rng_state`` covers only torch's global generators);
- **state written once**: the module's buffers (BatchNorm's running
  statistics and ``num_batches_tracked``) are copied before the
  recomputation and written back after it, so they keep what the first run
  wrote;
- **the same groups**: the recomputation runs in autograd's thread, where
  the train step's published process groups (``ops/_mesh.py``) are not
  set, so they are published again there: the recomputed BatchNorm takes
  the global statistics the first run took, and a sharded decoder layer
  sums over its model group again.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from virtex_tpu_torch.ops._mesh import (
    active_group,
    active_model_group,
    kernel_group,
)


def remat(module: torch.nn.Module, *args,
          generator: Optional[torch.Generator] = None):
    """``module(*args, generator=generator)`` (``generator`` omitted when
    None), its activations recomputed in the backward when the module is
    training and gradients are on; a plain call otherwise."""
    kwargs = {} if generator is None else {"generator": generator}
    if not (module.training and torch.is_grad_enabled()):
        return module(*args, **kwargs)
    before = {}

    @contextlib.contextmanager
    def first_run():
        if generator is not None:
            before["state"] = generator.get_state()
        before["groups"] = active_group(), active_model_group()
        yield

    @contextlib.contextmanager
    def rerun():
        found = None
        if generator is not None:
            found = generator.get_state()
            generator.set_state(before["state"])
        buffers = [(b, b.clone()) for b in module.buffers()]
        try:
            with kernel_group(*before["groups"]):
                yield
        finally:
            with torch.no_grad():
                for b, kept in buffers:
                    b.copy_(kept)
            if found is not None:
                generator.set_state(found)

    return checkpoint(module, *args, use_reentrant=False,
                      context_fn=lambda: (first_run(), rerun()), **kwargs)
