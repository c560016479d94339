from ao_tpu_torch.serving.decode import generate
from ao_tpu_torch.serving.engine import Engine, Request, ServeConfig
from ao_tpu_torch.serving.kvcache import QuantKVCache, init_quant_kv_caches
from ao_tpu_torch.serving.paged import PageAllocator, PagedKVPool

__all__ = ["Engine", "PageAllocator", "PagedKVPool", "QuantKVCache", "Request", "ServeConfig",
           "generate", "init_quant_kv_caches"]
