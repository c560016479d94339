"""Measured tile tuning for K11 with a persistent on-disk cache.

The port of ``ao_tpu/ops/pallas/autotune.py``. Tuning is explicit
(``autotune_int4(...)``): it times every tile choice K11 takes at one shape
on the current card and stores the fastest in a JSON file keyed by kernel,
card and shape. K11's tile picker (``int4_matmul.pick_tiles_halves``)
consults the file first, and ignores an entry that is not one of
``int4_matmul.candidate_tiles_halves`` at that shape.

The file is the reference's: ``autotune.json`` in ``$AO_TPU_NATIVE_CACHE``,
by default ``~/.cache/ao_tpu``. The key holds the card's name
(``torch.cuda.get_device_name``, spaces as underscores) where the reference
holds the TPU's device kind, so the two packages' entries never meet.

Usage:
    from ao_tpu_torch.ops.hopper.autotune import autotune_int4
    best, us = autotune_int4(m=788, k=768, n=768, group_size=128)
    # later K11 launches at this shape on this card take ``best``
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional, Tuple

import torch

_LOCK = threading.Lock()
_CACHE: Optional[Dict[str, List[int]]] = None


def _cache_path() -> str:
    d = os.environ.get("AO_TPU_NATIVE_CACHE",
                       os.path.join(os.path.expanduser("~"), ".cache", "ao_tpu"))
    return os.path.join(d, "autotune.json")


_KINDS: Dict[int, str] = {}


def _device_kind() -> str:
    """The current card's name, or "cpu" without one (asked once a card:
    K11's picker keys every launch by it)."""
    if not torch.cuda.is_available():
        return "cpu"
    idx = torch.cuda.current_device()
    if idx not in _KINDS:
        _KINDS[idx] = torch.cuda.get_device_name(idx).replace(" ", "_")
    return _KINDS[idx]


def _key(kernel: str, m: int, k: int, n: int, g: int) -> str:
    return f"{kernel}:{_device_kind()}:m{m}:k{k}:n{n}:g{g}"


def _load() -> Dict[str, List[int]]:
    global _CACHE
    with _LOCK:
        if _CACHE is None:
            try:
                with open(_cache_path()) as f:
                    _CACHE = json.load(f)
            except (OSError, ValueError):
                _CACHE = {}
        return _CACHE


def _store(key: str, tiles: Tuple[int, ...]) -> None:
    cache = _load()
    with _LOCK:
        cache[key] = list(tiles)
        path = _cache_path()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(cache, f, indent=0, sort_keys=True)
        os.replace(tmp, path)


def lookup_tuned(kernel: str, m: int, k: int, n: int, g: int) -> Optional[List[int]]:
    """Tuned tiles for this exact shape on this card, or None."""
    return _load().get(_key(kernel, m, k, n, g))


def autotune_int4(m: int, k: int, n: int, group_size: int = 128, iters: int = 3,
                  max_candidates: int = 12,
                  verbose: bool = False) -> Tuple[Tuple[int, int, int], float]:
    """Time K11's tile choices (``candidate_tiles_halves``, the heuristic's
    first) at this shape on the current card, over random bf16 x, split-half
    bytes and bf16 tinygemm qparams (the main path's transport), store the
    fastest and return ((bm, bn, splits), its device microseconds). Later
    K11 launches at this shape take it."""
    from ao_tpu_torch.ops.hopper import int4_matmul as k1
    from ao_tpu_torch.utils.timing import cuda_time_ms

    g = group_size
    cands = k1.candidate_tiles_halves(m, k, n, g)
    if not cands:
        raise ValueError(f"K11 does not take (K, N, g) = {(k, n, g)}")
    dev = torch.device("cuda", torch.cuda.current_device())
    heur = k1.pick_tiles_halves(m, k, n, g, k1._sm_count(dev))
    cands = [heur] + [c for c in cands if c != heur]
    if len(cands) > max_candidates:
        # keep the heuristic and an even spread of the rest
        rest = cands[1:]
        step = max(1, len(rest) // (max_candidates - 1))
        cands = [cands[0]] + rest[::step][:max_candidates - 1]

    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    packed = torch.randint(0, 256, (k // 2, n), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.uint8)
    s = torch.rand((k // g, n), generator=gen, device=dev) * 0.019 + 0.001
    zp = (-8.0 * s).to(torch.bfloat16)
    s = s.to(torch.bfloat16)

    best, best_us = heur, float("inf")
    for tiles in cands:
        us = 1e3 * cuda_time_ms(lambda: k1._launch_halves(x, packed, s, zp, g, True, tiles),
                                iters=iters)
        if verbose:
            print(f"  tiles {tiles}: {us:.2f} us")
        if us < best_us:
            best, best_us = tiles, us
    _store(_key("int4_wo_matmul", m, k, n, g), best)
    return best, best_us
