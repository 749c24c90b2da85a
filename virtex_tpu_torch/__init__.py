r"""
virtex_tpu_torch: the PyTorch + CUDA port of virtex_tpu, for NVIDIA Hopper.

It mirrors ``virtex_tpu``'s layout: each module here is the counterpart of
the module at the same path there. The port imports torch and never jax or
``virtex_tpu``. Kernels written by hand for ``sm_90a`` live in ``csrc/``
and are built at first use (``ops/_build.py``).

This release covers the six pretext-task models of ``MODEL.NAME``
(``factories.py``): the train step with gradient accumulation and the
optimizer chain (``engine/trainer.py``, ``optim/``), the eval step
(``engine/evaluation.py``), captioning by beam search or nucleus sampling
(``engine/captioner.py``), and pretraining from a config file
(``scripts/pretrain_virtex.py``) over the yaml reader (``config.py``), the
COCO data pipeline (``data/``, ``native/``) and checkpoints
(``engine/checkpointing.py``).
"""

__version__ = "0.1.0"
