"""Model registry: resolve a config instance to its functional model module.

PyTorch port of ``ao_tpu/models/__init__.py``. Generic infrastructure (the
decode loop, later the serving engine and eval) needs
``forward(params, tokens, cfg, positions=, kv_caches=, cache_index=)`` and
``init_kv_caches(cfg, batch, max_seq)``; the registry maps config types to
the modules that provide them. Llama is the only such family ported so far;
the vision models ``vit`` (ViT) and ``sam`` (SAM) have their own forwards
and are exported here beside it.
"""

from typing import Any, Dict, Type

_REGISTRY: Dict[Type, Any] = {}


def register_model(config_cls: type, module: Any) -> None:
    """Map a model-config dataclass to its functional module (must expose
    ``forward`` and ``init_kv_caches``)."""
    _REGISTRY[config_cls] = module


def resolve_model(cfg: Any):
    """The model module serving ``cfg``. Built-ins register lazily."""
    if not _REGISTRY:
        from ao_tpu_torch.models import llama

        register_model(llama.LlamaConfig, llama)
    for cls, mod in _REGISTRY.items():
        if isinstance(cfg, cls):
            return mod
    raise TypeError(
        f"no model registered for config {type(cfg).__name__}; call "
        "ao_tpu_torch.models.register_model(type(cfg), module)"
    )


from ao_tpu_torch.models import llama, sam, vit  # noqa: E402

__all__ = ["llama", "register_model", "resolve_model", "sam", "vit"]
