"""See the package docstring; modules mirror virtex_tpu/utils/."""
