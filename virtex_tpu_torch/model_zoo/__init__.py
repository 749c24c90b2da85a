from virtex_tpu_torch.model_zoo.model_zoo import fetch, get

__all__ = ["fetch", "get"]
