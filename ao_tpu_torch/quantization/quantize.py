"""`quantize_` — rewrite a params tree, swapping weights for QuantizedArrays.

PyTorch port of ``ao_tpu/quantization/quantize.py``. The model is a tree of
nested dicts and lists of tensors with the reference's keys, so the same
fully-qualified names (FQNs) reach the filter and ``FqnToConfig``.

The default filter targets 2-D (or stacked-expert 3-D) float leaves whose
path ends in a linear-kernel name.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch

from ao_tpu_torch.core.config import AOBaseConfig
from ao_tpu_torch.core.registry import get_quantize_handler
from ao_tpu_torch.quantization.configs import FqnToConfig
from ao_tpu_torch.quantization.qarrays.base import QuantizedArray

_LINEAR_KEY_NAMES = {"kernel", "weight", "w", "wq", "wk", "wv", "wo", "w1", "w2",
                     "w3", "gate", "up", "down", "qkv", "proj", "lm_head",
                     "w_gate", "w_up", "w_down"}


def path_to_fqn(path: Sequence[Any]) -> str:
    """Dict keys and list indices of a leaf's path, joined with dots."""
    return ".".join(str(p) for p in path)


def default_filter(fqn: str, leaf: Any) -> bool:
    if isinstance(leaf, QuantizedArray):
        # already quantized -> skip, except a calibration wrapper, whose
        # convert step must reach the handler (the reference's transitional
        # training wrappers come with the training slice)
        return type(leaf).__name__ == "ObservedArray"
    if not isinstance(leaf, torch.Tensor):
        return False
    if leaf.ndim not in (2, 3):
        return False
    if not leaf.is_floating_point():
        return False
    last = fqn.rsplit(".", 1)[-1] if fqn else ""
    return last in _LINEAR_KEY_NAMES


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


@torch.no_grad()
def quantize_(
    params: Any,
    config: AOBaseConfig,
    filter_fn: Optional[Callable[[str, Any], bool]] = None,
) -> Any:
    """Return a new params tree with selected weight leaves quantized.

    As in the reference, the input tree is left as it is and the caller
    rebinds the result; unselected leaves are shared, not copied.
    """
    filter_fn = filter_fn or default_filter

    def transform(path, leaf):
        fqn = path_to_fqn(path)
        if isinstance(config, FqnToConfig):
            cfg = config.lookup(fqn)
            if cfg is None:
                return leaf
            if not filter_fn(fqn, leaf) and fqn not in config.fqn_to_config:
                return leaf
            return get_quantize_handler(cfg)(leaf, cfg)
        if not filter_fn(fqn, leaf):
            return leaf
        return get_quantize_handler(config)(leaf, config)

    return _map_with_path(transform, params)


quantize_params = quantize_  # explicit functional alias
