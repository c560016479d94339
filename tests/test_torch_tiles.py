"""The tile choices of K14 (``fp4_matmul.pick_tiles``), K11
(``int4_matmul.pick_tiles_halves``), K1 (``int4_matmul.launch_tiles``:
``pick_splits`` and ``pick_tiles``), K15 (``lut4_matmul.launch_tiles``),
K10 (``int8_matmul.pick_tiles``) and K17 (``fp8_matmul.pick_tiles``), and
the launch plans of K8 and K16 on the attention mainloop
(``flash_attention.launch_plan``), K13's row tiles and decode splits
(``grouped_matmul.tile_plan``, ``decode_plan``), K3's cluster split
(``int4_matmul.w4a8_plan``) and the decode mainloop's launch of K2 and K9
(``decode_attention.launch_plan``, ``paged_attention.launch_plan``, with a
numpy mirror of its walk and its warp- and rank-ordered merge), over
every shape ``chip_smoke.py`` and the card's tests give them, the PyTorch
mirrors of K14's and K10's integer decodes against the plain decode over
every code and scale byte, the PyTorch mirror of K1's and K15's stage K
order and per-group fold and of K17's stage order and promotion against
their plain versions, and the ported tile cache
(``ops/hopper/autotune.py``). CPU only, a few seconds."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ao_tpu_torch.ops.hopper import autotune
from ao_tpu_torch.ops.hopper import bsr_matmul as k18
from ao_tpu_torch.ops.hopper import decode_attention as k2
from ao_tpu_torch.ops.hopper import flash_attention as k8
from ao_tpu_torch.ops.hopper import fp4_matmul as k14
from ao_tpu_torch.ops.hopper import fp8_matmul as k17
from ao_tpu_torch.ops.hopper import grouped_matmul as k13
from ao_tpu_torch.ops.hopper import int4_matmul as k1
from ao_tpu_torch.ops.hopper import int8_matmul as k10
from ao_tpu_torch.ops.hopper import lut4_matmul as k15
from ao_tpu_torch.ops.hopper import paged_attention as k9
from ao_tpu_torch.ops.hopper import window_attention as k16
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
# K10 and K17: every shape of the smoke run and the card's tests, and ragged
# row tiles (M = 17, 100) at N = 384
RAGGED = {(m, 4096, 384) for m in (17, 100)}
K10_SHAPES = sorted(set(_smoke.WEIGHT_SHAPES) | set(_cuda.INT8_CASES) | RAGGED
                    | {_cuda.INT8_TILE_CASE})
K17_SHAPES = sorted(set(_smoke.WEIGHT_SHAPES) | set(_cuda.FP8_BLOCK_CASES) | RAGGED
                    | {_cuda.FP8_BLOCK_TILE_CASE})
LLAMA_PREFILL = [(1024, k, n) for k, n in _smoke.LLAMA_KN]  # generate's prefill, M = 8 x 128
# K8 (B, Sq, Sk, H, Hkv, causal) and K16 (G, side, nh)
K8_CASES = sorted({(b, sq, sk, _smoke.K2_SHAPE["h"], _smoke.K2_SHAPE["hkv"], True)
                   for b, sq, sk in _smoke.K8_SHAPES} | set(_cuda.FLASH_CASES))
K16_CASES = sorted({(g, side, 12) for g, side in _smoke.K16_SHAPES}
                   | {case[:3] for case in _cuda.WINDOW_CASES})


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


@pytest.mark.parametrize("m,k,n", K10_SHAPES)
def test_k10_tiles_cover_k_and_fill_the_card(m, k, n):
    bm, bn, splits, per = k10.pick_tiles(m, k, n, SM)
    assert n % bn == 0
    if m <= k10.GEMV_MAX_M:  # the decode kernel: K units of 128, blocks of 128 columns
        assert (bm, bn) == (k10.GEMV_MAX_M, k10.UNIT)
        assert _covers(k // k10.UNIT, splits, per)
        return
    assert (bm, bn, splits) in k10.candidate_tiles(m, k, n)
    stages = k // k10.K_STAGE
    assert _covers(stages, splits, per)
    ctas = -(-m // bm) * (n // bn) * splits
    # three quarters of the card's CTA slots (one CTA an SM at BM = 256, two
    # below), or every stage a split of its own; always at generate's prefill
    slots = SM * k14.ctas_per_sm(bm)
    assert 4 * ctas >= 3 * slots or splits == stages, (bm, bn, splits, per, ctas)
    if (m, k, n) in LLAMA_PREFILL:
        assert 4 * ctas >= 3 * slots


@pytest.mark.parametrize("m,k,n", K17_SHAPES)
def test_k17_tiles_cover_k_and_fill_the_card(m, k, n):
    bm, bn, splits, per = k17.pick_tiles(m, k, n, SM)
    assert n % bn == 0
    kbs = k // k17.BLK
    assert _covers(kbs, splits, per)
    if m <= k17.GEMV_MAX_M:  # the decode kernel, blocks of 128 columns
        assert (bm, bn) == (k17.GEMV_MAX_M, 128)
        return
    assert (bm, bn, splits) in k17.candidate_tiles(m, k, n)
    assert bm == k17.PREFILL_BM and 128 % bn == 0  # one sw value a CTA and k-block
    ctas = -(-m // bm) * (n // bn) * splits
    # one CTA an SM: three quarters of the SMs, or every k-block a split of
    # its own; at generate's prefill without a split
    assert 4 * ctas >= 3 * SM or splits == kbs, (bm, bn, splits, per, ctas)
    if (m, k, n) in LLAMA_PREFILL:
        assert 4 * ctas >= 3 * SM and splits == 1


@pytest.mark.parametrize("mod,tiles", [(k10, (32, 128, 1)), (k10, (256, 256, 1)),
                                       (k10, (64, 128, 17)), (k17, (64, 128, 1)),
                                       (k17, (128, 32, 1)), (k17, (128, 128, 9))],
                         ids=["k10-bm", "k10-bn", "k10-splits", "k17-bm", "k17-bn",
                              "k17-splits"])
def test_launch_tiles_refuse_what_no_kernel_is_built_for(mod, tiles):
    m, k, n = 200, 1024, 384  # 16 stages of 64 K, 8 k-blocks
    with pytest.raises(ValueError, match="tiles"):
        mod.launch_tiles(m, k, n, SM, tiles)


def test_k10_decode_mirror_is_the_plain_cast():
    """Every int8 value, bit for bit."""
    q = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    got = k10.int8_decode_mirror(q)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), q.to(torch.bfloat16).view(torch.int16))


# K17's prefill arithmetic in PyTorch (k-blocks in order, four k32 steps
# into a fresh f32 sum, the fold acc = fma(tmp, sx * sw, acc)) against the
# plain version's (part * sx) * sw: exact fp8 products in both, the f32
# sums' order and the scales' product rounded differently
FP8_MIRROR_TOL = 1e-6  # of the output's largest magnitude


@pytest.mark.parametrize("m,k,n", [(5, 384, 256), (17, 128, 128), (3, 512, 384)])
def test_k17_stage_order_and_promotion_mirror_the_plain_version(m, k, n):
    rng = np.random.default_rng(m + k + n)
    qx = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32) * 30).to(
        torch.float8_e4m3fn)
    qw = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32) * 30).to(
        torch.float8_e4m3fn)
    sx = torch.from_numpy(rng.random((m, k // 128)).astype(np.float32) + 0.01)
    sw = torch.from_numpy(rng.random((k // 128, n // 128)).astype(np.float32) + 0.01)
    ref = k17.fp8_blockwise_matmul_plain(qx, sx, qw, sw)
    got = k17.fp8_block_fold_mirror(qx, sx, qw, sw)
    torch.testing.assert_close(got, ref, rtol=0, atol=FP8_MIRROR_TOL * float(ref.abs().max()))


def _check_plan(plan, b, sq, h, causal):
    """Each (batch row, head)'s query rows in exactly one CTA, its query
    tiles heaviest first, the heads of a query tile adjacent, and each CTA
    loading the key tiles its last row needs."""
    bq = plan.block_q
    assert len(plan.ctas) == -(-sq // bq) * b * h
    starts = {}
    for i, (q0, bb, hh, tiles) in enumerate(plan.ctas):
        assert (bb, hh) == (i // h % b, i % h)
        starts.setdefault((bb, hh), []).append(q0)
        end = min(plan.kv_len, q0 + bq, sq) if causal else plan.kv_len
        assert tiles == -(-end // k8.BLOCK_K) >= 1
    for rows in starts.values():
        assert rows == list(range(0, sq, bq))[::-1]
    work = [tiles for *_, tiles in plan.ctas]
    assert work == sorted(work, reverse=True)


@pytest.mark.parametrize("b,sq,sk,h,hkv,causal", K8_CASES)
def test_k8_plan_covers_rows_once_heaviest_first(b, sq, sk, h, hkv, causal):
    plan = k8.launch_plan((b, sq, h, 128), (b, sk, hkv, 128), causal)
    # causally the maps stop at Sq: the cache rows a prefill has not written
    # are never read
    assert plan.kv_len == (min(sq, sk) if causal else sk)
    _check_plan(plan, b, sq, h, causal)


@pytest.mark.parametrize("g,side,nh", K16_CASES)
def test_k16_plan_covers_rows_once(g, side, nh):
    t = side * side
    plan = k8.launch_plan((g, t, nh, 64), (g, t, nh, 64), False, k16.BLOCK_Q)
    assert plan.kv_len == t
    _check_plan(plan, g, t, nh, False)


def test_attention_ctas_at_the_main_paths():
    # the engine's 128 bucket: 64 CTAs of 64 rows (128-row CTAs would be 32)
    plan = k8.launch_plan((1, 128, 32, 128), (1, 128, 8, 128), True)
    assert plan.block_q == 64 and len(plan.ctas) == 64
    # K16 at SAM-B's windows and global layers: at least two CTAs an SM
    for g, side in _smoke.K16_SHAPES:
        t = side * side
        plan = k8.launch_plan((g, t, 12, 64), (g, t, 12, 64), False, k16.BLOCK_Q)
        assert len(plan.ctas) >= 2 * SM


# K13's row tiles over routings with empty experts, every row in one
# expert, T not a multiple of a tile, and top-2 routings of Mixtral's
# prefill (T = 2048) and the engine's 512 bucket (T = 1024) over 8 experts


def _top2_sizes(tokens, e, seed):
    rng = np.random.default_rng(seed)
    idx = np.argsort(-rng.standard_normal((tokens, e)), axis=1)[:, :2].reshape(-1)
    return np.bincount(idx, minlength=e).tolist()


K13_ROUTINGS = {
    "empty experts": [0, 40, 0, 0, 88, 0, 0, 0],
    "one expert": [0, 0, 0, 2048, 0, 0, 0, 0],
    "ragged": [3, 64, 65, 127, 129, 0, 1, 300],
    "decode": _top2_sizes(8, 8, 0),
    "T = 1024 over 8": _top2_sizes(512, 8, 1),
    "T = 2048 over 8": _top2_sizes(1024, 8, 2),
}


@pytest.mark.parametrize("bm", k13.ROW_TILES)
@pytest.mark.parametrize("name", sorted(K13_ROUTINGS))
def test_k13_row_tiles_cover_each_row_once(name, bm):
    sizes = K13_ROUTINGS[name]
    t, ends = sum(sizes), np.cumsum(sizes)
    plan = k13.tile_plan(sizes, bm)
    live = [tile for tile in plan if tile is not None]
    # the grid's T // BM + E row tiles bound the tiles; the surplus CTAs
    # come last and exit
    assert len(plan) == t // bm + len(sizes) and plan[:len(live)] == live
    assert len(live) == sum(-(-n // bm) for n in sizes)
    seen = np.zeros(t, np.int64)
    for e, m0, hi in live:
        lo = int(ends[e]) - sizes[e]
        assert hi == int(ends[e]) and lo <= m0 < hi and (m0 - lo) % bm == 0
        seen[m0:min(m0 + bm, hi)] += 1
    assert (seen == 1).all()
    # an expert's tiles run next to each other, experts in order
    experts = [e for e, *_ in live]
    assert experts == sorted(experts)


def test_k13_row_tiles_at_the_main_paths():
    # 64-row tiles at the engine's 128 bucket, 128 at its 512 bucket and
    # at generate's prefill
    assert [k13.pick_bm(t, 8) for t in (256, 1024, 2048)] == [64, 128, 128]
    for _, t, k, n, _ in _smoke.K13_SHAPES:
        assert (t <= k13.DECODE_MAX_T) == (t == 16)


@pytest.mark.parametrize("k,n", sorted({(k, n) for _, _, k, n, _ in _smoke.K13_SHAPES}
                                       | {(512, 256), (2048, 128), (4096, 256)}))
def test_k13_decode_splits_cover_k(k, n):
    nsg = k // (4 * _smoke.GROUP)
    splits, per = k13.decode_plan(k, n, 8, _smoke.GROUP, SM)
    assert 1 <= splits <= k13.MAX_CLUSTER and _covers(nsg, splits, per)
    # w_down (N = 4096: 256 blocks at E = 8) is split, w_gate / w_up not
    if (k, n) in ((14336, 4096), (4096, 14336)):
        assert (splits > 1) == (n == 4096)


@pytest.mark.parametrize("m", [1, 8, 16, 40, 512])
@pytest.mark.parametrize("k,n", _smoke.LLAMA_KN)
def test_k3_plan_covers_every_group_pair_once(m, k, n):
    g = _smoke.GROUP
    pairs = k // (2 * g)
    wk, splits, per = k1.w4a8_plan(m, k, n, g, SM)
    assert wk in k1.W4A8_K_WARPS and (m <= 16 or wk == 1)
    assert 1 <= splits <= k1.W4A8_MAX_CLUSTER
    # warp slice z wk + w of the cluster's CTA z takes pairs [slice per, + per):
    # every pair once, and every CTA along K some (the kernel's own check)
    slices = [range(i * per, min((i + 1) * per, pairs)) for i in range(splits * wk)]
    assert sorted(t for r in slices for t in r) == list(range(pairs))
    assert (splits - 1) * wk * per < pairs <= splits * wk * per
    ctas = n // 32 * (1 if m <= 16 else -(-m // 32)) * splits
    assert ctas >= 128  # every SM busy, wk / wv (N = 1024) included


@pytest.mark.parametrize("m", [1, 9, 17])
@pytest.mark.parametrize("k,n", [(2816, 128), (7168, 32), (256, 4096), (14336, 96), (5632, 640)])
def test_k3_plan_is_one_the_kernel_takes(m, k, n):
    # odd pair counts, narrow N: the kernel's own rule (int4_w4a8.cu)
    pairs = k // 256
    wk, splits, per = k1.w4a8_plan(m, k, n, 128, SM)
    slices = splits * wk
    assert wk in k1.W4A8_K_WARPS and (m <= 16 or wk == 1) and 1 <= splits <= 8
    assert (slices - wk) * per < pairs <= slices * per


def test_k3_plans_at_decode():
    # about 16 warps an SM, up to 4 along K in a CTA (kernel_tiles.py time K3)
    want = {(4096, 4096): (4, 4, 1), (4096, 1024): (4, 4, 1), (4096, 14336): (4, 1, 4),
            (14336, 4096): (2, 7, 4), (4096, 128256): (1, 1, 16)}
    assert {kn: k1.w4a8_plan(8, *kn, _smoke.GROUP, SM) for kn in want} == want


@pytest.mark.parametrize("offset", [0.0, 8.0])
def test_k13_decode_offset_fold_is_the_plain_function(offset):
    """The decode kernel's arithmetic in PyTorch: per group, tmp' = x_G .
    (128 + u_G) and xsum = sum(x_G) in f32, then acc += s tmp' + xsum (b2 -
    136 s), against the plain version (s (x_G . q_G) + xsum b2, q = u - 8)
    at the 45 dB bound, also where the row sums are large (a mean of 8)."""
    from ao_tpu_torch.quantization.qarrays.int4 import unpack_int4_magic

    g, k, n, m = 128, 1024, 256, 8
    gen = torch.Generator().manual_seed(int(offset))
    w = (torch.randn((k, n), generator=gen) * 0.05).to(torch.bfloat16)
    qa = Int4Array.from_hp(w, group_size=g)
    s, b2 = k1.transport_qparams(qa.scale, qa.zero_point, qa.zero_point_domain)
    x = (torch.randn((m, k), generator=gen) + offset).to(torch.bfloat16)
    u = unpack_int4_magic(qa.qdata, g).to(torch.float32)
    xf, sf = x.float(), s.float()
    bias = b2.float() - 136.0 * sf
    acc = torch.zeros((m, n))
    for grp in range(k // g):
        xg = xf[:, grp * g:(grp + 1) * g]
        tmp = xg @ (128.0 + u[grp * g:(grp + 1) * g])
        acc = acc + sf[grp] * tmp + xg.sum(1, keepdim=True) * bias[grp]
    ref = k1.int4_wo_magic_plain(x, qa.qdata, s, b2, g)
    err = (acc - ref).pow(2).mean() / ref.pow(2).mean()
    assert float(-10 * torch.log10(err)) >= 45


# the decode mainloop (K2, K9): T of generate (256), the engine (1024) and
# the long rows (4096), and T not a multiple of either tile
DECODE_TS = sorted({_smoke.K2_SHAPE["t"], _smoke.ENGINE_CFG["max_seq"], _smoke.T_LONG,
                    _cuda.DECODE_T, 100, 1000})


def _walk(plan, t):
    """{(rank, warp): the slab starts it walks in order} of a stream of t
    positions, as ``csrc/decode_mainloop.cuh`` walks them (a length >= t)."""
    warps = plan.rows // k2.SLAB
    out = {}
    for r in range(plan.splits):
        stop = min((r + 1) * plan.tiles * plan.rows, t)
        for w in range(warps):
            first = r * plan.tiles * plan.rows + w * k2.SLAB
            out[(r, w)] = list(range(first, stop, plan.rows))
    return out


@pytest.mark.parametrize("stages", k2.STAGES)
@pytest.mark.parametrize("rows", k2.TILE_ROWS)
@pytest.mark.parametrize("splits", k2.SPLITS)
@pytest.mark.parametrize("t", DECODE_TS)
def test_decode_plan_covers_each_position_once(t, splits, rows, stages):
    pool = (65, t // 4 if t % 4 == 0 else t, 8, 128), 4 if t % 4 == 0 else 1
    kw = dict(splits=splits, rows=rows, stages=stages)
    plans = []
    for dtype, row_bytes in ((torch.bfloat16, 256), (torch.int8, 128), (torch.int32, 64)):
        if k2.smem_bytes(rows, stages, row_bytes) > k2.SMEM_MAX:
            # a ring the kernel does not build: 128-row tiles of bf16 rows at 4 stages
            assert (rows, stages, row_bytes) == (128, 4, 256)
            with pytest.raises(ValueError, match="not a plan"):
                k9.launch_plan((8, 32, 128), *pool, dtype, **kw)
            continue
        plans.append(k9.launch_plan((8, 32, 128), *pool, dtype, **kw))
        if dtype == torch.bfloat16:
            plans.append(k2.launch_plan((8, 32, 128), (8, t, 8, 128), **kw))
        if dtype == torch.int8:  # K2v's dense int8 / e5m2 rows: 128 bytes too
            plans.append(k2.launch_plan_vec8((8, 32, 128), (8, t, 8, 128), **kw))
    for plan in plans:
        assert (plan.splits, plan.rows, plan.stages) == (splits, rows, stages)
        seen = np.zeros(t, np.int64)
        for starts in _walk(plan, t).values():
            assert starts == sorted(starts)
            for s0 in starts:
                seen[s0:s0 + k2.SLAB] += 1
        assert (seen == 1).all()


def test_decode_plans_at_the_main_paths():
    b, h, hkv, d = (_smoke.K2_SHAPE[key] for key in ("b", "h", "hkv", "d"))
    for t in (_smoke.K2_SHAPE["t"], _smoke.ENGINE_CFG["max_seq"], _smoke.T_LONG):
        plan = k2.launch_plan((b, h, d), (b, t, hkv, d))
        pool = (b, h, d), (65, _smoke.PAGE, hkv, d), t // _smoke.PAGE
        assert plan == k9.launch_plan(*pool) == k2.plan_for(b * hkv, t)
        quant = [k9.launch_plan(*pool, dt) for dt in (torch.int8, torch.float8_e4m3fn, torch.int32)]
        assert quant == [k2.plan_for(b * hkv, t, row_bytes) for row_bytes in (128, 128, 64)]
        assert k2.launch_plan_vec8((b, h, d), (b, t, hkv, d)) == quant[0]  # K2v
        for p in [plan] + quant:
            # the chosen split leaves no CTA without a tile
            assert (p.splits - 1) * p.tiles * p.rows < t
    # kernel_tiles.py time K2 / K9 (PERF.md, PR 16): bf16 rows one CTA a
    # stream at generate's T = 256, two above; converted rows two, in
    # 128-row tiles above T = 256
    assert [tuple(k2.plan_for(64, t)) for t in (256, 1024, 4096)] == [
        (1, 64, 3, 4), (2, 64, 3, 8), (2, 64, 3, 32)]
    assert [tuple(k2.plan_for(64, t, 128)) for t in (256, 1024, 4096)] == [
        (2, 64, 4, 2), (2, 128, 4, 4), (2, 128, 4, 16)]
    with pytest.raises(ValueError, match="splits"):
        k2.plan_for(64, 256, splits=3)
    with pytest.raises(ValueError, match="not a plan"):
        k2.check_plan(k2.DecodePlan(2, 64, 3, 1), 256)


def _mainloop_mirror(q, k, v, length, plan, paged):
    """One stream through the mainloop's arithmetic in f64, no bf16: q (G,
    D), k / v (T, D). Each warp walks its slabs with an online softmax
    (masked scores: K2 _NEG past the length, -inf past T; K9 _NEG past the
    length), the CTA merges its warps in warp order and rank f sums the
    ranks' (m, l, acc) in rank order, a warp or rank that walked nothing
    weighing exactly 0. Returns (out (G, D), the ranks' m)."""
    t = k.shape[0]
    end = max(min(length, t), 0) if paged else (min(length, t) if length >= 1 else t)
    stop_all = end
    ranks = []
    warps = plan.rows // k2.SLAB
    for r in range(plan.splits):
        parts = []
        for w in range(warps):
            m, l, acc = np.full(q.shape[0], -np.inf), np.zeros(q.shape[0]), np.zeros(q.shape)
            first = r * plan.tiles * plan.rows + w * k2.SLAB
            stop = min((r + 1) * plan.tiles * plan.rows, stop_all)
            for s0 in range(first, stop, plan.rows):
                pos = np.arange(s0, s0 + k2.SLAB)
                read = pos < end
                kk = np.where(read[:, None], k[np.minimum(pos, t - 1)], 0.0)
                vv = np.where(read[:, None], v[np.minimum(pos, t - 1)], 0.0)
                sc = q @ kk.T * 128 ** -0.5
                masked = (pos >= min(length, t)) if paged else (pos >= length)
                sc = np.where(masked[None, :], k2._NEG, sc)
                if not paged:
                    sc = np.where((pos >= t)[None, :], -np.inf, sc)
                m_new = np.maximum(m, sc.max(axis=1))
                alpha = np.exp(m - m_new)
                p = np.exp(sc - m_new[:, None])
                l, acc, m = l * alpha + p.sum(axis=1), acc * alpha[:, None] + p @ vv, m_new
            parts.append((m, l, acc))
        mc = np.max([pm for pm, _, _ in parts], axis=0)
        wts = [np.where(pm == -np.inf, 0.0, np.exp(pm - mc)) for pm, _, _ in parts]
        ranks.append((mc, sum(wt * pl for wt, (_, pl, _) in zip(wts, parts)),
                      sum(wt[:, None] * pa for wt, (_, _, pa) in zip(wts, parts))))
    m = np.max([rm for rm, _, _ in ranks], axis=0)
    l, acc = np.zeros_like(m), np.zeros(q.shape)
    for rm, rl, ra in ranks:  # rank order
        wt = np.where(rm == -np.inf, 0.0, np.exp(rm - m))
        l, acc = l + wt * rl, acc + wt[:, None] * ra
    return acc / np.maximum(l, 1e-30)[:, None], [rm for rm, _, _ in ranks]


@pytest.mark.parametrize("paged", [False, True], ids=["K2", "K9"])
@pytest.mark.parametrize("length", [-3, 0, 1, 17, 63, 64, 65, 150, 199, 200, 500])
@pytest.mark.parametrize("splits,rows", [(1, 64), (2, 128), (4, 64), (8, 64), (8, 128)])
def test_decode_merge_mirror_is_the_softmax(splits, rows, length, paged):
    """The mainloop's walk and merge equal one softmax over the positions
    below the length; a rank that walks nothing weighs 0 (its m is -inf);
    lengths <= 0 give K2's mean of V over all T and K9's 0."""
    t, g, d = 200, 4, 128
    rng = np.random.default_rng(length % 97 + splits + rows)
    q, k, v = rng.standard_normal((g, d)), rng.standard_normal((t, d)), rng.standard_normal((t, d))
    plan = k2.plan_for(1, t, splits=splits, rows=rows)
    got, rank_m = _mainloop_mirror(q, k, v, length, plan, paged)
    assert np.isfinite(got).all()
    n = min(length, t)
    if n >= 1:
        s = q @ k[:n].T * 128 ** -0.5
        p = np.exp(s - s.max(axis=1, keepdims=True))
        want = p @ v[:n] / p.sum(axis=1, keepdims=True)
    elif paged:
        want = np.zeros((g, d))
    else:
        want = np.broadcast_to(v.mean(axis=0), (g, d))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    # the ranks whose range starts at or past the walk's end walked nothing
    end = max(n, 0) if paged else (n if length >= 1 else t)
    idle = [r for r in range(splits) if r * plan.tiles * plan.rows >= end]
    assert all((rank_m[r] == -np.inf).all() for r in idle)
    assert all(np.isfinite(rank_m[r]).all() for r in range(splits) if r not in idle)


# K18: chip_smoke.py's shapes (ViT-L's w1 / w2 at b = 64 and 128, the JAX
# suite's two, a dense weight) and random patterns where the items are fewer
# than the SMs (cluster splits) or ragged, as (M, K, N, b, keep)
K18_PLAN_CASES = [s[:5] for s in _smoke.K18_SHAPES] + [
    (1, 4096, 1024, 128, None), (64, 4096, 1024, 128, 0.3), (16, 2048, 4096, 64, 0.5),
    (13, 256, 384, 32, 0.4), (200, 1024, 4096, 64, None), (700, 512, 2048, 32, 0.05)]


def _bsr_pattern(k, n, b, keep, seed):
    """(row_indices, col_indices) of a random BSR pattern sorted by (col,
    row), every column present (an empty one padded with a block at row 0,
    as ``BlockSparseArray.from_hp`` does)."""
    rng = np.random.default_rng(seed)
    live = np.ones((k // b, n // b), bool) if keep is None else rng.random((k // b, n // b)) < keep
    rows, cols = np.nonzero(live)
    missing = np.setdiff1d(np.arange(n // b), cols)
    rows, cols = np.concatenate([rows, 0 * missing]), np.concatenate([cols, missing])
    order = np.lexsort((rows, cols))
    return rows[order], cols[order]


@pytest.mark.parametrize("m,k,n,b,keep", K18_PLAN_CASES)
def test_k18_plan_walks_every_item_and_block_once(m, k, n, b, keep):
    """``bsr_matmul.schedule``, the kernel's walk, at the plan ``launch_plan``
    picks and at every split: each (row tile, column) item is taken by one
    cluster, by each of its ranks once; the ranks' block ranges tile the
    column's run in rank order, so each block is summed once, in the
    column's order; every CTA the plan names takes an item."""
    rows, cols = _bsr_pattern(k, n, b, keep, seed=m + n + b)
    runs = k18.column_runs(torch.from_numpy(cols.astype(np.int32)), n // b).numpy()
    assert runs[0] == 0 and runs[-1] == len(cols) and (np.diff(runs) >= 1).all()
    for splits in [None] + [sp for sp in (1, 2, 4) if sp <= k18.MAX_SPLIT[b]]:
        plan = k18.launch_plan(m, n, b, len(cols), k18.SMS, splits=splits)
        assert plan.items == -(-m // k18.TILE_ROWS) * (n // b) == plan.m_tiles * (n // b)
        assert plan.ctas == (plan.items * plan.splits if plan.splits > 1
                             else min(plan.items, 2 * k18.SMS))
        walk = k18.schedule(plan, runs)
        assert {w[0] for w in walk} == set(range(plan.ctas))
        parts = {}
        for cta, rank, t, c, m0, a, e in walk:
            assert (c, m0) == (t // plan.m_tiles, t % plan.m_tiles * k18.TILE_ROWS) and m0 < m
            assert rank == cta % plan.splits
            assert cta // plan.splits == t % (plan.ctas // plan.splits)
            parts.setdefault(t, []).append((rank, a, e))
        assert sorted(parts) == list(range(plan.items))
        for t, ranks in parts.items():
            c = t // plan.m_tiles
            assert sorted(r for r, _, _ in ranks) == list(range(plan.splits))
            pos = runs[c]
            for _, a, e in sorted(ranks):
                assert a == pos <= e
                pos = e
            assert pos == runs[c + 1]
            blocks = slice(runs[c], runs[c + 1])
            assert (cols[blocks] == c).all() and (np.diff(rows[blocks]) > 0).all()


def test_k18_plans_at_the_main_paths():
    """The plans ``chip_smoke.py``'s shapes take (PERF.md): unsplit
    at ViT-L's shapes, two CTAs an SM or one an item; the JAX suite's runs
    of 2 blocks unsplit; runs of 8 or more split over 4 CTAs (2 at b = 64)."""
    picks = [tuple(k18.launch_plan(m, n, b, nnz)) for m, k, n, b, nnz in (
        (3152, 1024, 4096, 64, 117), (3152, 4096, 1024, 64, 102), (3152, 1024, 4096, 128, 128),
        (3152, 4096, 1024, 128, 128), (64, 1024, 1024, 128, 17), (1, 512, 640, 128, 10),
        (3152, 1024, 4096, 64, 1024), (64, 4096, 1024, 128, 256), (16, 2048, 4096, 64, 1024))]
    assert picks == [
        (1, 264, 25, 1600), (1, 264, 25, 400), (1, 264, 25, 800), (1, 200, 25, 200),
        (1, 8, 1, 8), (1, 5, 1, 5), (1, 264, 25, 1600), (4, 32, 1, 8), (2, 128, 1, 64)]
    with pytest.raises(ValueError, match="splits"):
        k18.launch_plan(64, 1024, 64, 256, splits=4)
    with pytest.raises(ValueError, match="splits"):
        k18.launch_plan(64, 1024, 128, 256, splits=3)
