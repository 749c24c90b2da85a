"""Data: the tokenizer, the COCO readers and datasets, the image pipelines
over the native data plane, and the loader; modules mirror
virtex_tpu/data/."""
