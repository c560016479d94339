"""The tile choices of K14 (``fp4_matmul.pick_tiles``), K11
(``int4_matmul.pick_tiles_halves``), K1 (``int4_matmul.launch_tiles``:
``pick_splits`` and ``pick_tiles``) and K15 (``lut4_matmul.launch_tiles``) over every shape
``chip_smoke.py`` and the card's tests give them, the PyTorch mirror of
K14's integer decode against the plain decode over every code and scale
byte, the PyTorch mirror of K1's and K15's stage K order and per-group fold
against their plain versions, and the ported tile cache
(``ops/hopper/autotune.py``). CPU only, a few seconds."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ao_tpu_torch.ops.hopper import autotune
from ao_tpu_torch.ops.hopper import fp4_matmul as k14
from ao_tpu_torch.ops.hopper import int4_matmul as k1
from ao_tpu_torch.ops.hopper import lut4_matmul as k15
from ao_tpu_torch.quantization.primitives import ZeroPointDomain
from ao_tpu_torch.quantization.qarrays.fp4 import _remap_fp4_magic, decode_fp4_e2m1
from ao_tpu_torch.quantization.qarrays.int4 import Int4Array, pack_int4_magic
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
K1_SHAPES = sorted({(m, k, n, _smoke.GROUP) for m, k, n in _smoke.K1_SHAPES}
                   | {case[:4] for case in _cuda.MAGIC_CASES} | {_cuda.MAGIC_TILE_CASE})
K15_SHAPES = sorted({(m, k, n, _smoke.NF4_GROUP) for m, k, n in _smoke.WEIGHT_SHAPES}
                    | set(_cuda.LUT4_CASES))


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


def _check_magic_tiles(m, k, n, g, bm, bn, splits):
    """A prefill tile of K1 or K15: one of the mainloop's, K cut in whole
    units (so on group boundaries), every unit in exactly one split, and
    three quarters of the card's CTA slots filled or every unit a split of
    its own."""
    assert (bm, bn, splits) in k1.candidate_tiles_magic(m, k, n)
    units = k1.magic_units(k)
    per = -(-units // splits)
    assert _covers(units, splits, per)
    assert (per * k1.MAGIC_UNIT_K) % (4 * g) == 0
    ctas = -(-m // bm) * -(-n // bn) * splits
    slots = SM * k1.magic_ctas_per_sm(bm, bn)
    assert 4 * ctas >= 3 * slots or splits == units, (bm, bn, splits, ctas)


@pytest.mark.parametrize("m,k,n,g", K1_SHAPES)
def test_k1_tiles_cover_k_and_fill_the_card(cache, m, k, n, g):
    bm, bn, splits, per, run = k1.launch_tiles(m, k, n, g, SM)
    if m > k1.GEMV_MAX_M:
        _check_magic_tiles(m, k, n, g, bm, bn, splits)
        assert (per, run) == (8 * -(-k1.magic_units(k) // splits), 0)
        assert not cache.exists()
        return
    assert (bm, bn) == (k1.GEMV_MAX_M, 128)
    runs = k // (4 * g) * (g // 2 // run)
    assert _covers(runs, splits, per)
    blocks = -(-n // 128)
    # runs finer than a super-group only where whole ones leave SMs idle
    whole, _ = k1._split_units(k // (4 * g), blocks, SM)
    finer = blocks * whole < SM and g // 2 > k1.GEMV_RUN_ROWS
    assert run == (k1.GEMV_RUN_ROWS if finer else g // 2)
    assert blocks * splits >= SM or splits == runs, (splits, per, run)


def test_k1_decode_splits_4096x1024_finer():
    # Llama-3-8B's wk / wv at decode: 8 super-groups give 64 blocks; runs of
    # 16 word rows give 32 splits, 256 blocks. 4096x4096 keeps whole ones.
    assert k1.pick_splits(8, 4096, 1024, 128, SM) == (32, 1, 16)
    assert k1.pick_splits(8, 4096, 4096, 128, SM) == (8, 1, 64)
    assert k1.pick_splits(8, 4096, 128256, 128, SM) == (1, 8, 64)


@pytest.mark.parametrize("m,k,n,g", K15_SHAPES)
def test_k15_tiles_cover_k_and_fill_the_card(m, k, n, g):
    bm, bn, splits, per = k15.launch_tiles(m, k, n, g, SM)
    if m > k1.GEMV_MAX_M:
        _check_magic_tiles(m, k, n, g, bm, bn, splits)
        assert per == 8 * -(-k1.magic_units(k) // splits)
    else:  # the decode kernel: whole super-groups a split
        assert (bm, bn) == (k1.GEMV_MAX_M, 128)
        assert _covers(k // (4 * g), splits, per)


@pytest.mark.parametrize("entry,taken", [((64, 128, 2), True), ((128, 128, 6), True),
                                         ((128, 64, 1), False), ((128, 128, 4), False),
                                         ((64, 128), False)],
                         ids=["tile", "split", "not-a-tile", "not-a-split", "short"])
def test_k1_takes_a_cached_entry_only_as_a_candidate(cache, entry, taken):
    m, k, n = 788, 3072, 768  # ViT-B/16's w2: six units of K
    autotune._store(autotune._key("int4_wo_magic", m, k, n, 0), entry)
    want = tuple(entry) if taken else k1.pick_tiles_magic(m, k, n, SM)
    assert k1.pick_tiles(m, k, n, 128, SM) == want


@pytest.mark.parametrize("g", [16, 32, 64, 128])
def test_magic_steps_read_every_word_row_and_plane_once(g):
    k = 4096 + 4 * g  # a ragged last unit below g = 128
    steps = [k1.magic_step(s, kk, g) for s in range(k // k1.MAGIC_STAGE_K) for kk in range(4)]
    cells = {(row + p, grp % 4) for grp, row in steps for p in range(8)}
    assert len(cells) == 8 * len(steps) == 4 * (k // 8)
    # step i's block: word rows r' of super-group t, plane j hold K rows
    # (4t + j) g + 2r' and + 1, so the step is K values 16 i .. 16 i + 15
    for i, (grp, row) in enumerate(steps):
        t = grp // 4
        assert (4 * t + grp % 4) * g + 2 * (row - t * g // 2) == 16 * i


# K1's and K15's prefill arithmetic in PyTorch (steps in K order, decode from
# the words' rows and planes, per-group f32 fold) against the plain versions:
# every product is exact in both, only the f32 sums' order differs
MIRROR_TOL = 1e-5  # of the output's largest magnitude


def _mirror_k(g):
    return 4 * g * (3 if g < 128 else 2)  # a ragged last unit below g = 128


@pytest.mark.parametrize("g", [16, 32, 64, 128])
@pytest.mark.parametrize("domain", ["minmax_int", "tinygemm", "raw_zp"])
def test_k1_stage_order_and_fold_mirror_the_plain_version(g, domain):
    rng = np.random.default_rng(g)
    k, n, m = _mirror_k(g), 32, 5
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32) * 0.05)
    zpd = ZeroPointDomain.INT if domain == "minmax_int" else ZeroPointDomain.FLOAT
    qa = Int4Array.from_hp(w.to(torch.bfloat16), group_size=g, zero_point_domain=zpd)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(torch.bfloat16)
    s, b2 = k1.transport_qparams(qa.scale, qa.zero_point, qa.zero_point_domain)
    ref = k1.int4_wo_magic_plain(x, qa.qdata, s, b2, g)
    if domain == "raw_zp":  # the kernel's own b2 from the bf16 tinygemm scale and zero point
        assert qa.scale.dtype == qa.zero_point.dtype == torch.bfloat16
        got = k1.int4_wo_magic_mirror(x, qa.qdata, qa.scale, qa.zero_point, g, raw_zp=True)
    else:
        got = k1.int4_wo_magic_mirror(x, qa.qdata, s, b2, g)
    torch.testing.assert_close(got, ref, rtol=0, atol=MIRROR_TOL * float(ref.abs().max()))


@pytest.mark.parametrize("g", [16, 32, 64, 128])
@pytest.mark.parametrize("n_luts", [0, 1, 4], ids=["shared", "one", "per-row-block"])
def test_k15_stage_order_and_fold_mirror_the_plain_version(g, n_luts):
    rng = np.random.default_rng(100 + g)
    k, n, m = _mirror_k(g), 32, 5
    codes = torch.from_numpy(rng.integers(0, 16, (k, n)).astype(np.uint8))
    word = pack_int4_magic(codes, g)
    scalers = torch.from_numpy(rng.random((k // g, n)).astype(np.float32) + 0.01)
    cb = torch.from_numpy(rng.standard_normal((n_luts, 16) if n_luts else (16,)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(torch.bfloat16)
    ref = k15.lut4_wo_magic_plain(x, word, scalers, cb, g)
    got = k15.lut4_wo_magic_mirror(x, word, scalers, cb, g)
    torch.testing.assert_close(got, ref, rtol=0, atol=MIRROR_TOL * float(ref.abs().max()))
