from ao_tpu_torch.serving.decode import generate
from ao_tpu_torch.serving.kvcache import QuantKVCache, init_quant_kv_caches

__all__ = ["QuantKVCache", "generate", "init_quant_kv_caches"]
