"""The tile choices of K14 (``fp4_matmul.pick_tiles``) and K11
(``int4_matmul.pick_tiles_halves``) over every shape ``chip_smoke.py`` and
the card's tests give them, the PyTorch mirror of K14's integer decode
against the plain decode over every code and scale byte, and the ported
tile cache (``ops/hopper/autotune.py``). CPU only, a few seconds."""

import importlib.util
import json
from pathlib import Path

import pytest
import torch

from ao_tpu_torch.ops.hopper import autotune
from ao_tpu_torch.ops.hopper import fp4_matmul as k14
from ao_tpu_torch.ops.hopper import int4_matmul as k1
from ao_tpu_torch.quantization.qarrays.fp4 import _remap_fp4_magic, decode_fp4_e2m1
from ao_tpu_torch.quantization.qarrays.mx import e8m0_decode

ROOT = Path(__file__).resolve().parents[1]
SM = 132  # the H100's SMs


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_smoke = _load("_chip_smoke_shapes", ROOT / "chip_smoke.py")
_cuda = _load("_cuda_test_shapes", ROOT / "tests" / "test_torch_kernels_cuda.py")

K14_SHAPES = sorted(set(_smoke.WEIGHT_SHAPES) | set(_cuda.FP4_SHAPES)
                    | {(8, 256, 256), (256, 256, 256)})
K11_SHAPES = sorted({(m, k, n, _smoke.GROUP) for m, k, n in _smoke.K11_SHAPES}
                    | {case[:4] for case in _cuda.HALVES_CASES}
                    | set(_cuda.HALVES_TILE_CASES))


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """An empty tile cache in ``tmp_path``, keyed as on an H100."""
    monkeypatch.setenv("AO_TPU_NATIVE_CACHE", str(tmp_path))
    monkeypatch.setattr(autotune, "_CACHE", None)
    monkeypatch.setattr(autotune, "_device_kind", lambda: "NVIDIA_H100_80GB_HBM3")
    return tmp_path / "autotune.json"


def _covers(units, splits, per):
    return splits >= 1 and per >= 1 and (splits - 1) * per < units <= splits * per


@pytest.mark.parametrize("m,k,n", K14_SHAPES)
def test_k14_tiles_cover_k_and_fill_the_card(m, k, n):
    bm, bn, splits, per = k14.pick_tiles(m, k, n, SM)
    assert n % bn == 0
    if m <= k14.GEMV_MAX_M:  # the decode kernel: units of 256, blocks of 128 columns
        assert (bm, bn) == (k14.GEMV_MAX_M, k14.N_BLOCK)
        units = k // k14.K_UNIT
        assert _covers(units, splits, per)
        ctas = n // bn * splits
        # at least one block per SM, or every unit of K is a split of its own
        assert ctas >= SM or splits == units, (bm, bn, splits, per, ctas)
    else:
        assert (bm, bn) in ((256, 128), (128, 128), (64, 128))
        units = k // k14.K_STAGE
        assert _covers(units, splits, per)
        ctas = -(-m // bm) * (n // bn) * splits
        # three quarters of the card's CTA slots (one CTA an SM at BM = 256,
        # two below), or every stage of K is a split of its own
        slots = SM * k14.ctas_per_sm(bm)
        assert 4 * ctas >= 3 * slots or splits == units, (bm, bn, splits, per, ctas)


@pytest.mark.parametrize("m,k,n,g", K11_SHAPES)
def test_k11_tiles_cover_k_and_fill_the_card(cache, m, k, n, g):
    bm, bn, splits = k1.pick_tiles_halves(m, k, n, g, SM)
    cands = k1.candidate_tiles_halves(m, k, n, g)
    assert (bm, bn, splits) in cands and n % bn == 0
    stages = k1.halves_stages(k)
    per = -(-stages // splits)
    launched = k1.launched_splits(k, splits)
    assert _covers(stages, launched, per)
    ctas = -(-m // bm) * (n // bn) * launched
    # at least one CTA per two SMs (pick_tiles_halves says why not one per
    # SM), or (64, 128) tiles and the most splits K allows
    most = max(sp for _, _, sp in cands)
    assert 2 * ctas >= SM or ((bm, bn) == (64, 128) and splits == most), (bm, bn, splits, ctas)
    assert not cache.exists()


def test_vit_b_shapes_take_the_measured_tiles(cache):
    # ViT-B at batch 4 (M = 788): 78 CTAs of (64, 128) at N = 768, 168 of
    # (128, 128) at N = 3072, unsplit
    assert k1.pick_tiles_halves(788, 768, 768, 128, SM) == (64, 128, 1)
    assert k1.pick_tiles_halves(788, 768, 3072, 128, SM) == (128, 128, 1)


@pytest.mark.parametrize("kind", [k14.MX, k14.NV], ids=["mx", "nv"])
def test_fp4_decode_mirror_is_the_plain_decode(kind):
    """Every code (its stored form) times every scale byte, bit for bit;
    NaN where the plain decode is NaN."""
    codes = torch.arange(16, dtype=torch.uint8)[:, None]
    byte = torch.arange(256, dtype=torch.int32)[None, :]
    got = k14.fp4_decode_mirror(_remap_fp4_magic(codes), byte, kind)
    if kind == k14.MX:
        scale = e8m0_decode(byte.to(torch.uint8))
    else:
        scale = byte.to(torch.uint8).view(torch.float8_e4m3fn).to(torch.float32)
    want = (decode_fp4_e2m1(codes) * scale).to(torch.bfloat16)
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got.view(torch.int16)[~nan], want.view(torch.int16)[~nan])


def test_tile_cache_round_trip(cache):
    key = autotune._key("int4_wo_matmul", 788, 768, 768, 128)
    assert autotune.lookup_tuned("int4_wo_matmul", 788, 768, 768, 128) is None
    autotune._store(key, (64, 128, 2))
    assert json.loads(cache.read_text()) == {key: [64, 128, 2]}
    autotune._CACHE = None  # a new process reads the file
    assert autotune.lookup_tuned("int4_wo_matmul", 788, 768, 768, 128) == [64, 128, 2]
    assert k1.pick_tiles_halves(788, 768, 768, 128, SM) == (64, 128, 2)


def test_tile_cache_key_names_the_card(cache, monkeypatch):
    assert (autotune._key("int4_wo_matmul", 1, 2, 3, 4)
            == "int4_wo_matmul:NVIDIA_H100_80GB_HBM3:m1:k2:n3:g4")
    monkeypatch.undo()
    name = ("cpu" if not torch.cuda.is_available()
            else torch.cuda.get_device_name(torch.cuda.current_device()).replace(" ", "_"))
    assert autotune._device_kind() == name


@pytest.mark.parametrize("entry", [(128, 32, 1), (64, 64, 16), (64, 64)],
                         ids=["tile", "splits", "short"])
def test_tile_cache_ignores_what_k11_does_not_take(cache, entry):
    autotune._store(autotune._key("int4_wo_matmul", 788, 768, 768, 128), entry)
    assert k1.pick_tiles_halves(788, 768, 768, 128, SM) == (64, 128, 1)


def test_tile_cache_missing_or_broken_file(cache):
    assert autotune.lookup_tuned("int4_wo_matmul", 788, 768, 768, 128) is None
    assert k1.pick_tiles_halves(788, 768, 768, 128, SM) == (64, 128, 1)
    assert not cache.exists()
    cache.write_text("{not json")
    autotune._CACHE = None
    assert autotune.lookup_tuned("int4_wo_matmul", 788, 768, 768, 128) is None
