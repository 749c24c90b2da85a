"""The pretraining datasets; modules mirror virtex_tpu/data/datasets/."""
