"""The tile choices of K14 (``fp4_matmul.pick_tiles``), K11
(``int4_matmul.pick_tiles_halves``), K1 (``int4_matmul.launch_tiles``:
``pick_splits`` and ``pick_tiles``), K15 (``lut4_matmul.launch_tiles``),
K10 (``int8_matmul.pick_tiles``) and K17 (``fp8_matmul.pick_tiles``), and
the launch plans of K8 and K16 on the attention mainloop
(``flash_attention.launch_plan``), over
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
from ao_tpu_torch.ops.hopper import flash_attention as k8
from ao_tpu_torch.ops.hopper import fp4_matmul as k14
from ao_tpu_torch.ops.hopper import fp8_matmul as k17
from ao_tpu_torch.ops.hopper import int4_matmul as k1
from ao_tpu_torch.ops.hopper import int8_matmul as k10
from ao_tpu_torch.ops.hopper import lut4_matmul as k15
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
