"""See the package docstring; modules mirror virtex_tpu/optim/."""
