"""The tile choices of K14 (``fp4_matmul.pick_tiles``, and its decode form's
``fp4_matmul.gemv_plan`` with a PyTorch mirror of its summation order), K11
(``int4_matmul.pick_tiles_halves``), K1 and K15 (the decode form's
``int4_matmul.gemv_plan`` with a PyTorch mirror of its summation order,
``int4_matmul.launch_tiles`` and ``lut4_matmul.launch_tiles`` above M = 16),
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
from ao_tpu_torch.ops.hopper import fused_act as k12
from ao_tpu_torch.ops.hopper import grouped_matmul as k13
from ao_tpu_torch.ops.hopper import int4_matmul as k1
from ao_tpu_torch.ops.hopper import int8_matmul as k10
from ao_tpu_torch.ops.hopper import lut4_matmul as k15
from ao_tpu_torch.ops.hopper import paged_attention as k9
from ao_tpu_torch.ops.hopper import window_attention as k16
from ao_tpu_torch.quantization.primitives import ZeroPointDomain, compute_error
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
    if m <= k14.GEMV_MAX_M:  # the decode form: slabs of 256 K, K1's plan at g = K/4
        plan = k14.gemv_plan(m, k, n, SM)
        for kind in (k14.MX, k14.NV):
            assert k14.checked_gemv_plan(m, k, n, kind, SM) == plan
        wn, wk, cluster, stages = plan
        slabs, per = k // k14.K_UNIT, k1.gemv_per(k, k // 4, cluster)
        assert _covers(slabs, cluster, per)
        ctas = n // (32 * wn) * cluster
        if n // (32 * wn) >= 2 * SM:  # the lm_head: K1's one CTA a tile
            assert plan == k1.gemv_plan(m, k, n, k // 4, SM)
        elif wn == 2 and cluster > 1 and per * cluster == slabs and per <= 8 and ctas <= SM:
            pass  # a CTA an SM, two warps wide, each with whole slabs
        else:  # K1's plan
            assert plan == k1.gemv_plan(m, k, n, k // 4, SM)
            # a CTA an SM, or every slab a CTA of its own, or a cluster of 8
            assert ctas >= SM or cluster in (slabs, k1.GEMV_MAX_CLUSTER), plan
        with pytest.raises(ValueError, match="decode form"):
            k14.pick_tiles(m, k, n, SM)
    else:
        bm, bn, splits, per = k14.pick_tiles(m, k, n, SM)
        assert n % bn == 0
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


@pytest.mark.parametrize("kind", [k14.MX, k14.NV], ids=["mx", "nv"])
def test_fp4_gemv_decode_mirror_is_the_plain_decode(kind):
    """The decode form's table decode (``fp4_planes``, ``mx_scale2_byte``):
    every code (its stored form) times every scale byte, bit for bit; NaN
    where the plain decode is NaN."""
    codes = torch.arange(16, dtype=torch.uint8)[:, None]
    byte = torch.arange(256, dtype=torch.int32)[None, :]
    got = k14.fp4_gemv_decode_mirror(_remap_fp4_magic(codes), byte, kind)
    if kind == k14.MX:
        scale = e8m0_decode(byte.to(torch.uint8))
    else:
        scale = byte.to(torch.uint8).view(torch.float8_e4m3fn).to(torch.float32)
    want = (decode_fp4_e2m1(codes) * scale).to(torch.bfloat16)
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got.view(torch.int16)[~nan], want.view(torch.int16)[~nan])
    # the zero codes' signs survive: -0 where the plain decode is -0
    assert torch.equal(torch.signbit(got[~nan]), torch.signbit(want[~nan]))


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


def _check_gemv_plan(m, k, n, g, plan, setup=0):
    """A decode plan the kernel takes, one launch of a cluster of at most 8
    CTAs along K, every slab in exactly one CTA; a CTA an SM at least where
    the column tiles and a cluster of 8 allow it."""
    wn, wk, cluster, stages = plan
    assert k1.gemv_plan_ok(m, k, n, g, plan, setup), plan
    assert 1 <= cluster <= k1.GEMV_MAX_CLUSTER
    slabs, per = k // (8 * k1.gemv_rows(g)), k1.gemv_per(k, g, cluster)
    assert _covers(slabs, cluster, per)
    ctas = n // (32 * wn) * cluster
    assert ctas >= SM or cluster in (slabs, k1.GEMV_MAX_CLUSTER), plan


@pytest.mark.parametrize("m,k,n,g", K1_SHAPES)
def test_k1_tiles_cover_k_and_fill_the_card(cache, m, k, n, g):
    if m <= k1.GEMV_MAX_M:
        _check_gemv_plan(m, k, n, g, k1.gemv_plan(m, k, n, g, SM))
        with pytest.raises(ValueError, match="decode form"):
            k1.launch_tiles(m, k, n, g, SM)
        return
    bm, bn, splits, per = k1.launch_tiles(m, k, n, g, SM)
    _check_magic_tiles(m, k, n, g, bm, bn, splits)
    assert per == 8 * -(-k1.magic_units(k) // splits)
    assert not cache.exists()


def test_k1_decode_splits_4096x1024_finer():
    # Llama-3-8B's linears at decode (M = 8, g = 128; NF4's g = 64 alike):
    # four warps of columns a CTA; wk / wv (N = 1024) with two warps along K
    # in a cluster of 8; w2's 56 slabs in a cluster of 7; the lm_head one CTA
    # a tile (kernel_tiles.py time K1 / K15 on the H100)
    want = {(4096, 4096): (4, 1, 6, 4), (4096, 1024): (4, 2, 8, 3),
            (4096, 14336): (4, 1, 2, 4), (14336, 4096): (4, 1, 7, 4),
            (4096, 128256): (4, 1, 1, 2)}
    for g in (128, 64):
        assert {kn: k1.gemv_plan(8, *kn, g, SM) for kn in want} == want


@pytest.mark.parametrize("m,k,n,g", K15_SHAPES)
def test_k15_tiles_cover_k_and_fill_the_card(m, k, n, g):
    if m <= k1.GEMV_MAX_M:  # K1's decode form, with the codebooks' shared memory
        setup = k15.gemv_tables(4)[1]
        _check_gemv_plan(m, k, n, g, k1.gemv_plan(m, k, n, g, SM), setup)
        return
    bm, bn, splits, per = k15.launch_tiles(m, k, n, g, SM)
    _check_magic_tiles(m, k, n, g, bm, bn, splits)
    assert per == 8 * -(-k1.magic_units(k) // splits)


def _gemv_walk(k, g, plan):
    """The (rank, warp along K) that takes each (word row, plane) of a
    decode launch, as the kernel walks it: rank r's slabs [r per, (r + 1)
    per), warp w's k16 steps w, w + wk, .. of each slab, a step 8 word rows
    of every plane."""
    _, wk, cluster, _ = plan
    rows = k1.gemv_rows(g)
    sps, per = g // 2 // rows, k1.gemv_per(k, g, cluster)
    owner = {}
    for r in range(cluster):
        for s in range(r * per, min((r + 1) * per, k // (8 * rows))):
            base = s // sps * (g // 2) + s % sps * rows
            for w in range(wk):
                for q in range(w, rows // 8, wk):
                    for row in range(base + 8 * q, base + 8 * q + 8):
                        for j in range(4):
                            assert (row, j) not in owner
                            owner[(row, j)] = (r, w)
    return owner


@pytest.mark.parametrize("g", [16, 32, 64, 128])
def test_gemv_plans_take_every_word_row_and_plane_once(g):
    k, n = 32 * g, 256
    plans = k1.gemv_candidates(8, k, n, g, stages=(3,))
    assert len(plans) >= 10
    for plan in plans:
        owner = _gemv_walk(k, g, plan)
        assert len(owner) == 4 * (k // 8)
        # the x values of (word row, plane j): K rows (4t + j) g + 2r' and + 1
        ks = sorted(2 * (row % (g // 2)) + (4 * (row // (g // 2)) + j) * g for row, j in owner)
        assert ks == list(range(0, k, 2))


def test_gemv_plan_refuses_what_the_kernel_does_not_build():
    ok = (2, 2, 4, 4)
    assert k1.gemv_plan_ok(8, 4096, 4096, 128, ok)
    for bad in [(3, 1, 4, 4), (2, 8, 4, 4), (4, 4, 4, 4), (2, 2, 9, 4), (2, 2, 4, 1),
                (2, 2, 4, 9), (2, 2, 16, 4), (2, 2, 0, 4)]:
        assert not k1.gemv_plan_ok(8, 4096, 4096, 128, bad), bad
    assert not k1.gemv_plan_ok(17, 4096, 4096, 128, ok)  # M > 16: the prefill's tiles
    assert not k1.gemv_plan_ok(8, 4096, 4096, 16, ok)  # g = 16: one step a slab, wk = 1
    assert not k1.gemv_plan_ok(8, 4096, 1056, 128, (4, 1, 4, 4))  # N % 128: a ragged CTA
    # eight stages of 16 rows of x beside 256 codebooks: past the shared memory
    assert k1.gemv_smem_bytes(16, 4, 2, 8, 128, 32 * 256) > k1.GEMV_MAX_SMEM
    assert k1.gemv_plan_ok(16, 4096, 4096, 128, (4, 2, 1, 8))
    assert not k1.gemv_plan_ok(16, 4096, 4096, 128, (4, 2, 1, 8), 32 * 256)
    assert [k1.gemv_rows(g) for g in (16, 32, 64, 128)] == [8, 16, 32, 32]


K14_DECODE = [shape for shape in K14_SHAPES if shape[0] <= k14.GEMV_MAX_M]


def test_k14_decode_plans_at_llama_widths():
    # Llama-3-8B's linears at decode (M = 1, 8, 16): wq / wo one CTA an SM
    # two warps wide in clusters of 2, wk / wv in clusters of 8, w1 / w3, w2
    # and the lm_head K1's plans (kernel_tiles.py time K14 on the H100)
    want = {(4096, 4096): (2, 2, 2, 4), (4096, 1024): (2, 2, 8, 3),
            (4096, 14336): (4, 1, 2, 4), (14336, 4096): (4, 1, 7, 4),
            (4096, 128256): (4, 1, 1, 2)}
    for m in (1, 8, 16):
        assert {kn: k14.gemv_plan(m, *kn, SM) for kn in want} == want


@pytest.mark.parametrize("m,k,n", K14_DECODE)
def test_k14_decode_plans_take_every_slab_and_plane_once(m, k, n):
    """Every plan K14's decode form takes at the shapes the smoke run and the
    card's tests give it (``gemv_candidates``, each checked by
    ``gemv_plan_ok`` for both kinds): each (word row, plane) in one (rank,
    warp along K), the planes' K rows every K row once."""
    plans = k14.gemv_candidates(m, k, n, k14.NV, stages=(3,))
    assert k14.gemv_plan(m, k, n, SM) in k14.gemv_candidates(m, k, n, k14.NV)
    assert plans
    for plan in plans[::max(1, len(plans) // 12)]:
        assert k14.gemv_plan_ok(m, k, n, k14.MX, plan) and k14.gemv_plan_ok(m, k, n, k14.NV, plan)
        _, wk, cluster, _ = plan
        per, owner = k1.gemv_per(k, k // 4, cluster), {}
        for r in range(cluster):
            for s in range(r * per, min((r + 1) * per, k // k14.K_UNIT)):
                for w in range(wk):
                    steps = k14.gemv_steps(wk, w)
                    # a warp's steps cover whole 32-row scale blocks where wk <= 2
                    assert wk == 4 or (steps.start % 2 == 0 and len(steps) % 2 == 0)
                    for q in steps:
                        for row in range(32 * s + 8 * q, 32 * s + 8 * q + 8):
                            for j in range(4):
                                assert (row, j) not in owner
                                owner[(row, j)] = (r, w)
        assert len(owner) == 4 * (k // 8)
        # (word row r, plane j): K rows j K/4 + 2r and + 1
        assert sorted(j * k // 4 + 2 * row for row, j in owner) == list(range(0, k, 2))


def test_k14_decode_plan_refuses_what_the_kernel_does_not_build():
    ok = (4, 1, 4, 4)
    for kind in (k14.MX, k14.NV):
        assert k14.gemv_plan_ok(8, 4096, 4096, kind, ok)
        for bad in [(3, 1, 4, 4), (4, 8, 4, 4), (4, 4, 4, 4), (4, 1, 9, 4), (4, 1, 4, 1),
                    (4, 1, 4, 9), (4, 1, 17, 4), (4, 1, 0, 4)]:
            assert not k14.gemv_plan_ok(8, 4096, 4096, kind, bad), bad
        assert not k14.gemv_plan_ok(17, 4096, 4096, kind, ok)  # M > 16: the prefill's tiles
        assert not k14.gemv_plan_ok(8, 4096 + 128, 4096, kind, ok)  # K % 256
        assert not k14.gemv_plan_ok(8, 4096, 4096 + 64, kind, (2, 1, 4, 4))  # N % 128
        assert not k14.gemv_plan_ok(8, 512, 4096, kind, (4, 1, 4, 4))  # two slabs, four CTAs
    # NV's stage holds four times MX's scale bytes: eight stages of 16 rows
    # of x at wn = 4 fit beside MX's scales, not beside NV's
    assert k14.gemv_plan_ok(16, 4096, 4096, k14.MX, (4, 1, 1, 8))
    assert not k14.gemv_plan_ok(16, 4096, 4096, k14.NV, (4, 1, 1, 8))
    assert (k1.gemv_smem_bytes(16, 4, 1, 8, 1024, qcol=k14.stage_q(k14.NV))
            > k1.GEMV_MAX_SMEM >= k1.gemv_smem_bytes(16, 4, 1, 8, 1024, qcol=k14.stage_q(k14.MX)))


@pytest.mark.parametrize("m", [1, 8, 16])
@pytest.mark.parametrize("kind,pts", [(k14.MX, None), (k14.NV, 0.375), (k14.NV, None)],
                         ids=["mx", "nv", "nv-no-pts"])
def test_k14_decode_mirror_is_the_plain_version(m, kind, pts):
    """K14's decode form's summation order (slab order, warps along K, the
    cluster's ranks, every step into one acc) in PyTorch against the plain
    version: the same exact bf16 weights, f32 sums in another order, then
    one bf16 rounding (NV with a per-tensor scale: two), so at most two
    bf16 ulps apart, and above the card's bounds (MX 60 dB, NV 35 dB)."""
    from ao_tpu_torch.quantization.qarrays.fp4 import pack_fp4_magic, pack_nvfp4_scale_pairs

    rng = np.random.default_rng(300 + 10 * m + kind + (pts is None))
    k, n = 1024, 128
    codes = torch.from_numpy(rng.integers(0, 16, (k, n)).astype(np.uint8))
    word = pack_fp4_magic(codes)
    if kind == k14.MX:
        scale = torch.from_numpy(rng.integers(118, 131, (k // 32, n)).astype(np.uint8))
        ref_fn = lambda x: k14.mxfp4_wo_matmul_plain(x, word, scale)  # noqa: E731
    else:
        e4m3 = torch.from_numpy(rng.random((k // 16, n)).astype(np.float32) * 4 + 0.01)
        scale = pack_nvfp4_scale_pairs(e4m3.to(torch.float8_e4m3fn))
        pts = None if pts is None else torch.tensor(pts, dtype=torch.float32)
        ref_fn = lambda x: k14.nvfp4_wo_matmul_plain(x, word, scale, pts)  # noqa: E731
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(torch.bfloat16)
    ref = ref_fn(x)
    plans = [k14.gemv_plan(m, k, n, SM)] + [
        p for p in [(1, 2, 3, 3), (2, 4, 1, 2), (4, 1, 4, 4), (1, 1, 2, 3)]
        if k14.gemv_plan_ok(m, k, n, kind, p)]
    assert len(plans) >= 4
    for plan in plans:
        got = k14.fp4_wo_gemv_mirror(x, word, scale, pts, kind, plan)
        assert got.dtype == torch.bfloat16 and got.shape == (m, n)
        assert float(compute_error(ref, got)) > (60 if kind == k14.MX else 35), plan
        torch.testing.assert_close(got.float(), ref.float(), rtol=2 ** -7,
                                   atol=MIRROR_TOL * float(ref.float().abs().max()))


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


def _gemv_plans(m, k, n, g):
    """The picked decode plan, and plans with warps along K and clusters
    that cut a super-group."""
    plans = [k1.gemv_plan(m, k, n, g, SM)] + [
        p for p in [(1, 2, 5, 3), (2, 1, 7, 2), (1, 4, 2, 4), (1, 1, 2, 3), (2, 1, 1, 2)]
        if k1.gemv_plan_ok(m, k, n, g, p)]
    assert len(plans) >= 3
    return plans


@pytest.mark.parametrize("m", [1, 8, 16])
@pytest.mark.parametrize("g,domain", [(16, "tinygemm"), (32, "minmax_int"), (64, "raw_zp"),
                                      (128, "tinygemm"), (128, "raw_zp")])
def test_k1_decode_mirror_is_the_plain_version(m, g, domain):
    """K1's decode form's summation order (per-group fold, slab order, warps
    along K, the cluster's ranks) in PyTorch against the plain version: the
    same exact products, f32 sums in another order (45 dB, the card's
    bound, and the prefill mirror's tolerance)."""
    rng = np.random.default_rng(10 * g + m)
    k, n = 12 * g, 64
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32) * 0.05)
    zpd = ZeroPointDomain.INT if domain == "minmax_int" else ZeroPointDomain.FLOAT
    qa = Int4Array.from_hp(w.to(torch.bfloat16), group_size=g, zero_point_domain=zpd)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(torch.bfloat16)
    s, b2 = k1.transport_qparams(qa.scale, qa.zero_point, qa.zero_point_domain)
    ref = k1.int4_wo_magic_plain(x, qa.qdata, s, b2, g)
    for plan in _gemv_plans(m, k, n, g):
        if domain == "raw_zp":
            got = k1.int4_wo_magic_gemv_mirror(x, qa.qdata, qa.scale, qa.zero_point, g, plan,
                                               raw_zp=True)
        else:
            got = k1.int4_wo_magic_gemv_mirror(x, qa.qdata, s, b2, g, plan)
        assert float(compute_error(ref, got)) >= 45, plan
        torch.testing.assert_close(got, ref, rtol=0, atol=MIRROR_TOL * float(ref.abs().max()))


@pytest.mark.parametrize("n_luts,want", [(0, (True, 16384)), (1, (True, 16384)),
                                         (4, (False, 128)), (256, (False, 8192))])
def test_k15_pair_tables_take_one_codebook_only(n_luts, want):
    # one codebook (NF4's) as 16 copies of its 256-pair table; (L, 16)
    # codebooks each as its 16 entries
    assert k15.gemv_tables(n_luts) == want


@pytest.mark.parametrize("m", [1, 8, 16])
@pytest.mark.parametrize("g,n_luts", [(32, 0), (64, 0), (64, 3), (128, 2)])
def test_k15_decode_mirror_is_the_plain_version(m, g, n_luts):
    rng = np.random.default_rng(200 + g + m + n_luts)
    k, n = 12 * g, 64
    codes = torch.from_numpy(rng.integers(0, 16, (k, n)).astype(np.uint8))
    word = pack_int4_magic(codes, g)
    scalers = torch.from_numpy(rng.random((k // g, n)).astype(np.float32) + 0.01)
    cb = torch.from_numpy(rng.standard_normal((n_luts, 16) if n_luts else (16,)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(torch.bfloat16)
    ref = k15.lut4_wo_magic_plain(x, word, scalers, cb, g)
    for plan in _gemv_plans(m, k, n, g):
        got = k15.lut4_wo_magic_gemv_mirror(x, word, scalers, cb, g, plan)
        assert float(compute_error(ref, got)) > 40, plan
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
    # K5's int8, K6's e4m3 and K7's ch4 rows, straight into fragments: a
    # ring of three stages, the one the kernel builds
    for kind in k2.DIRECT_KINDS:
        cache = (8, t, 8, 16 if kind == "i4" else 128)
        assert k2.smem_bytes(rows, stages, k2.DIRECT_KINDS[kind], direct=True) <= k2.SMEM_MAX
        if stages not in k2.DIRECT_STAGES:
            with pytest.raises(ValueError, match="not a plan"):
                k2.launch_plan_quant(kind, (8, 32, 128), cache, **kw)
            continue
        plans.append(k2.launch_plan_quant(kind, (8, 32, 128), cache, **kw))
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
        direct = [k2.launch_plan_quant(kind, (b, h, d),
                                       (b, t, hkv, d // (8 if kind == "i4" else 1)))
                  for kind in ("i8", "f8", "i4")]  # K5, K6, K7
        assert direct == [k2.plan_for(b * hkv, t, row_bytes, direct=True)
                          for row_bytes in (128, 128, 64)]
        for p in [plan] + quant + direct:
            # the chosen split leaves no CTA without a tile
            assert (p.splits - 1) * p.tiles * p.rows < t
    # kernel_tiles.py time K2 / K9 (PERF.md, PR 16): bf16 rows one CTA a
    # stream at generate's T = 256, two above; converted rows two, in
    # 128-row tiles above T = 256
    assert [tuple(k2.plan_for(64, t)) for t in (256, 1024, 4096)] == [
        (1, 64, 3, 4), (2, 64, 3, 8), (2, 64, 3, 32)]
    assert [tuple(k2.plan_for(64, t, 128)) for t in (256, 1024, 4096)] == [
        (2, 64, 4, 2), (2, 128, 4, 4), (2, 128, 4, 16)]
    # K5, K6 and K7 (kernel_tiles.py time K5 / K6 / K7, PERF.md): 128-row
    # tiles, one CTA a stream at T = 256, two above, three stages
    for row_bytes in (128, 64):
        assert [tuple(k2.plan_for(64, t, row_bytes, direct=True))
                for t in (256, 1024, 4096)] == [(1, 128, 3, 2), (2, 128, 3, 4), (2, 128, 3, 16)]
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


# K5, K6 and K7: the lanes' direct fragment maps, mirrored from
# ao_tpu_torch/csrc/decode_mainloop.cuh (direct_raw_off, direct_q_frag,
# direct_q_int8, direct_k_frag, direct_v_frag, direct_scores, direct_load_v
# and the partial store). A 32-bit register is mirrored as its 8 nibbles,
# each labelled with where it came from: (row, nibble index in the row) for
# a raw K or V row, where a ch4 row's nibble index is its channel and an
# int8 or e4m3 row's byte index (the nibble index // 2) is; ("q", channel)
# for q; None for a zero.


def _direct_raw_offset(row_bytes: int, r: int, c: int) -> int:
    """Byte offset of 16-byte chunk c of row r in a direct Op's raw K or V
    block (``direct_raw_off``): a 128-byte line (one e4m3 row, two ch4 rows)
    keeps its chunk i at i ^ (line & 7) (e4m3) or i ^ 2 (line & 3) (ch4)."""
    if row_bytes == 128:
        return r * 128 + ((c ^ (r & 7)) << 4)
    line = r >> 1
    return line * 128 + (((4 * (r & 1) + c) ^ (2 * (line & 3))) << 4)


def _raw_word(row: int, byte: int):
    return [(row, 2 * byte + i) for i in range(8)]


def _q_word(w: int):
    return [("q", 2 * w)] * 4 + [("q", 2 * w + 1)] * 4


def _byte_perm(a, b, sel: int):
    src = a + b  # bytes 0-3 of a, then of b, two nibbles each
    out = []
    for i in range(4):
        k = (sel >> (4 * i)) & 7
        out += src[2 * k:2 * k + 2]
    return out


def _bytes(x):
    """The (row, channel) of the four bytes of x, in order."""
    out = []
    for i in range(4):
        (row, n), hi = x[2 * i], x[2 * i + 1]
        assert n % 2 == 0 and hi == (row, n + 1), "a byte split across nibbles"
        out.append((row, n // 2))
    return out


def _e4m3x2(x):
    """The (row, channel) of the two bf16 halves of ``e4m3x2(x)`` (and of
    ``int8x2(x)``): bytes 0 and 2 of x."""
    out = []
    for lo in (0, 4):
        (row, n), hi = x[lo], x[lo + 1]
        assert n % 2 == 0 and hi == (row, n + 1), "a byte split across nibbles"
        out.append((row, n // 2))
    return out


def _ch4_pair(x, j: int):
    """The (row, channel) of the two bf16 halves of ``ch4_pair(x, j)``."""
    return [x[j], x[j + 4]]


def _q_half(x, lo: int):
    assert len(set(x[lo:lo + 4])) == 1, "a bf16 split across registers"
    return x[lo][1]


def _direct_q_channels(kind: str, t: int, kk: int, h: int):
    """The q channels of the two bf16 halves of q's A fragment word h (k
    slots 2t + 8h and 2t + 8h + 1) of k16 step kk, for the lanes with lane %
    4 == t, which hold words [16 t, 16 t + 16) of their head row
    (``direct_q_frag``); for K5 ("i8") of the four int8 of word h (k slots
    4t + 16h + [0, 4)) of k32 step kk (``direct_q_int8``: the bf16 words
    unpacked in order, v[2 i], v[2 i + 1] from word i, then byte i of int8
    word w from v[4 w + i], word w into qa[w // 2][w % 2])."""
    qw = [_q_word(16 * t + i) for i in range(16)]
    if kind == "i8":
        v = [ch for x in qw for ch in (_q_half(x, 0), _q_half(x, 4))]
        qa = [[v[4 * w + i] for i in range(4)] for w in range(8)]
        return qa[2 * kk + h]
    if kind == "f8":
        x = qw[2 * kk + h]
    else:
        w = 4 * (kk >> 1) + (kk & 1)
        x = _byte_perm(qw[w], qw[w + 2], 0x7632 if h else 0x5410)
    return [_q_half(x, 0), _q_half(x, 4)]


def _direct_k_fragments(kind: str, lane: int):
    """Lane's raw K loads and its q . K^T B fragments (``direct_scores``):
    (loads [(row, chunk)] in load order, {(n8 tile j, k16 step kk, word h):
    [(row, channel) of the bf16 of k slot 2t + 8h, of slot 2t + 8h + 1]}),
    t = lane % 4; for K5 ("i8") {(j, k32 step kk, word h): [(row, channel)
    of the int8 of k slots 4t + 16h + [0, 4)]}, the raw words 2 kk + h as
    they are; the fragment's column is position 8 j + lane // 4."""
    g, t = lane >> 2, lane & 3
    kkc = 2 * k2.DIRECT_KINDS[kind] // k2.HEAD_DIM
    loads, frags = [], {}
    for j in range(2):
        row, words = 8 * j + g, []
        for h in range(kkc):
            c = kkc * t + h
            loads.append((row, c))
            words += [_raw_word(row, 16 * c + 4 * i) for i in range(4)]
        zero = [None] * 8
        if kind == "i8":
            for kk in range(k2.HEAD_DIM // 32):
                for h in (0, 1):
                    frags[(j, kk, h)] = _bytes(words[2 * kk + h])
            continue
        for kk in range(k2.HEAD_DIM // 16):
            if kind == "f8":
                pair = [_e4m3x2(_byte_perm(words[kk], zero, sel)) for sel in (0x4140, 0x4342)]
            else:
                pair = [_ch4_pair(words[kk >> 1], 2 * (kk & 1) + h) for h in (0, 1)]
            frags[(j, kk, 0)], frags[(j, kk, 1)] = pair
    return loads, frags


def _direct_v_fragments(kind: str, lane: int):
    """Lane's raw V loads and its p . V B fragments (``direct_load_v``,
    ``direct_v_frag``): (loads [(row, byte offset in the row, bytes)],
    {(n8 tile nn, word h): [(row, channel) of the bf16 of k slot (position)
    2t + 8h, of 2t + 8h + 1]}); the fragment's column is n = lane // 4."""
    g, t = lane >> 2, lane & 3
    row_bytes = k2.DIRECT_KINDS[kind]
    nbytes = 16 * row_bytes // k2.HEAD_DIM  # 16 channels
    loads, words = [], []
    for o in range(4):
        row = 2 * t + (o & 1) + 8 * (o >> 1)
        loads.append((row, nbytes * g, nbytes))
        words.append([_raw_word(row, nbytes * g + 4 * i) for i in range(nbytes // 4)])
    frags = {}
    for nn in range(k2.HEAD_DIM // 8):
        for h in (0, 1):
            a, b = words[2 * h], words[2 * h + 1]
            if kind != "i4":  # int8x2 and e4m3x2 read bytes 0 and 2
                k = nn & 3
                frags[(nn, h)] = _e4m3x2(_byte_perm(a[nn >> 2], b[nn >> 2], ((4 + k) << 8) | k))
            else:
                sel = 0x7632 if nn & 4 else 0x5410
                frags[(nn, h)] = _ch4_pair(_byte_perm(a[nn >> 3], b[nn >> 3], sel), nn & 3)
    return loads, frags


def _direct_out_channel(nn: int, n: int) -> int:
    """The channel a warp's partial stores column n of p . V's n8 tile nn
    at (direct V)."""
    return 16 * n + nn


def _direct_part_col(g: int, d: int) -> int:
    """The column of a warp's partial that keeps channel d of head row g
    (direct V, ``direct_part_col``): rotated by 8 (d / 32) + g within its
    block of 32."""
    return (d & ~31) | ((d + 8 * (d >> 5) + g) & 31)


DIRECT_KINDS = sorted(k2.DIRECT_KINDS)


def _lane_loads(kind):
    """[(byte address in the raw K or V block, bytes)] a lane of each load
    instruction, lanes in order: K's then V's."""
    rb = k2.DIRECT_KINDS[kind]
    k_loads = [_direct_k_fragments(kind, lane)[0] for lane in range(32)]
    v_loads = [_direct_v_fragments(kind, lane)[0] for lane in range(32)]
    out = []
    for i in range(len(k_loads[0])):
        out.append([(_direct_raw_offset(rb, *k_loads[lane][i]), 16) for lane in range(32)])
    for i in range(len(v_loads[0])):
        out.append([(_direct_raw_offset(rb, row, byte // 16) + byte % 16, n)
                    for row, byte, n in (v_loads[lane][i] for lane in range(32))])
    return out


@pytest.mark.parametrize("kind", DIRECT_KINDS)
def test_direct_fragments_read_each_position_and_channel_once(kind):
    """Every (position, channel) of a 16-row slab is in exactly one lane's
    B fragments, once, for K and for V; K's fragment of n8 tile j is position
    8 j + lane // 4, V's k slot 2t + 8h + i is position 2t + 8h + i; and the
    raw loads read each byte of the K and V blocks once."""
    want = {(r, c): 1 for r in range(k2.SLAB) for c in range(k2.HEAD_DIM)}
    seen_k, seen_v = {}, {}
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for (j, _, _), pair in _direct_k_fragments(kind, lane)[1].items():
            for row, ch in pair:
                assert row == 8 * j + g
                seen_k[(row, ch)] = seen_k.get((row, ch), 0) + 1
        for (_, h), pair in _direct_v_fragments(kind, lane)[1].items():
            for i, (row, ch) in enumerate(pair):
                assert row == 2 * t + 8 * h + i
                seen_v[(row, ch)] = seen_v.get((row, ch), 0) + 1
    assert seen_k == want and seen_v == want
    rb = k2.DIRECT_KINDS[kind]
    for block in (_lane_loads(kind)[:-4], _lane_loads(kind)[-4:]):  # K's loads, V's four
        read = np.zeros(k2.SLAB * rb, np.int64)
        for instr in block:
            for addr, n in instr:
                read[addr:addr + n] += 1
        assert (read == 1).all()


@pytest.mark.parametrize("kind", DIRECT_KINDS)
def test_direct_loads_are_free_of_bank_conflicts(kind):
    """The ring's cp.async writes put each 16-byte chunk of a 16-row block in
    a slot of its own, and each phase of every fragment load (8 lanes of 16
    bytes, 16 lanes of 8) touches each of the 32 banks once."""
    rb = k2.DIRECT_KINDS[kind]
    slots = sorted(_direct_raw_offset(rb, r, c) for r in range(k2.SLAB) for c in range(rb // 16))
    assert slots == list(range(0, k2.SLAB * rb, 16))
    for instr in _lane_loads(kind):
        width = instr[0][1]
        per = 128 // width  # lanes a phase
        for ph in range(32 // per):
            banks = [(addr // 4 + w) % 32 for addr, n in instr[ph * per:(ph + 1) * per]
                     for w in range(n // 4)]
            assert sorted(banks) == list(range(32)), (kind, width, ph)
    # direct V's partials: a warp's store of acc[nn][e] (lane g, t: channel
    # 16 (2t + e) + nn of head row g) and the merge's read of channel d of
    # row g by thread d each hit 32 banks; each row's columns a permutation
    for nn in range(k2.HEAD_DIM // 8):
        for e in (0, 1):
            cols = [g * k2.HEAD_DIM + _direct_part_col(g, _direct_out_channel(nn, 2 * t + e))
                    for g in range(8) for t in range(4)]
            assert sorted(c % 32 for c in cols) == list(range(32))
    for g in range(8):
        cols = [_direct_part_col(g, d) for d in range(k2.HEAD_DIM)]
        assert sorted(cols) == list(range(k2.HEAD_DIM))
        for d0 in range(0, k2.HEAD_DIM, 32):
            assert sorted(c % 32 for c in cols[d0:d0 + 32]) == list(range(32))


@pytest.mark.parametrize("kind", DIRECT_KINDS)
def test_direct_permuted_products_are_the_plain_ones(kind):
    """q . K^T through the lanes' permuted k slots (q's A fragments by
    ``_direct_q_channels``, K's B fragments by ``_direct_k_fragments``) and p .
    V through ``_direct_v_fragments``, its columns stored at
    ``_direct_out_channel``, in f64: the plain products, columns in channel
    order; K5's ("i8") integer q . K^T equal to numpy's int dot exactly."""
    rng = np.random.default_rng(18 + len(kind))
    q, k = rng.standard_normal((8, k2.HEAD_DIM)), rng.standard_normal((k2.SLAB, k2.HEAD_DIM))
    if kind == "i8":
        q, k = (rng.integers(-127, 128, (n, k2.HEAD_DIM)) for n in (8, k2.SLAB))
    p, v = rng.standard_normal((8, k2.SLAB)), rng.standard_normal((k2.SLAB, k2.HEAD_DIM))
    s = np.zeros((8, k2.SLAB), q.dtype)
    out = np.zeros((8, k2.HEAD_DIM))
    for lane in range(32):
        n, t = lane >> 2, lane & 3  # the B operand's column, the lane's k slots
        for (j, kk, h), pair in _direct_k_fragments(kind, lane)[1].items():
            qch = _direct_q_channels(kind, t, kk, h)  # A's rows hold the same k slots
            for i, (row, ch) in enumerate(pair):
                s[:, row] += q[:, qch[i]] * k[row, ch]
        for (nn, h), pair in _direct_v_fragments(kind, lane)[1].items():
            col = _direct_out_channel(nn, n)
            for row, ch in pair:
                assert ch == col
                out[:, col] += p[:, row] * v[row, ch]
    if kind == "i8":
        assert s.dtype == np.int64 and np.array_equal(s, q @ k.T)
    else:
        np.testing.assert_allclose(s, q @ k.T, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(out, p @ v, rtol=1e-12, atol=1e-12)
    # the q channels of a lane's k slots over the 8 k16 (K5: 4 k32) steps:
    # each once
    steps = k2.HEAD_DIM // (32 if kind == "i8" else 16)
    for t in range(4):
        chans = [c for kk in range(steps) for h in (0, 1)
                 for c in _direct_q_channels(kind, t, kk, h)]
        assert sorted(chans) == list(range(32 * t, 32 * t + 32))


def _quant_bytes(v, s):
    """numpy f32 mirror of ``csrc/quant_round.cuh``'s quant_byte: the codes
    clip(rint(v / s), +-127) from y = v * (1 / s), the IEEE quotient v / s
    where y lies within 2^-20 |y| of a half-integer, then clip(y) + 1.5 *
    2^23 (its low byte). Returns (codes int8, how many took the quotient)."""
    v, s = np.asarray(v, np.float32), np.float32(s)
    magic = np.float32(12582912)
    y = v * (np.float32(1) / s)
    near = np.abs(np.abs(y - ((y + magic) - magic)) - np.float32(0.5)) <= np.abs(y) * np.float32(
        2.0 ** -20)
    y = np.where(near, v / s, y)
    code = (np.clip(y, np.float32(-127), np.float32(127)) + magic).view(np.uint32) & 0xFF
    return code.astype(np.uint8).view(np.int8), int(near.sum())


def test_quant_byte_is_the_rounded_ieee_quotient():
    """quant_byte's codes equal clip(rint(v / s), +-127) with v / s an IEEE
    f32 division, bit for bit: at random values, and at every half-integer
    multiple of random scales and its f32 neighbours, where the reciprocal's
    product alone would round the other way (the quotient is taken there)."""
    rng = np.random.default_rng(19)
    for s in np.float32(rng.uniform(1e-4, 10, 40)) / np.float32(127):
        s = np.float32(s)
        half = (np.arange(-128, 128, dtype=np.float32) + np.float32(0.5)) * s
        v = np.concatenate([half, np.nextafter(half, np.float32(np.inf)),
                            np.nextafter(half, np.float32(-np.inf)),
                            np.float32(rng.standard_normal(512)) * s * np.float32(40),
                            np.zeros(4, np.float32)]).astype(np.float32)
        got, slow = _quant_bytes(v, s)
        want = np.clip(np.rint(v / s), -127, 127).astype(np.int8)
        assert np.array_equal(got, want)
        assert slow >= 256  # every exact half-integer multiple takes the quotient


def _quant_bytes_in_row(v, s):
    """numpy f32 mirror of ``quant_byte_in_row``: y = v * (1 / s), t = y +
    1.5 * 2^23 (no clip), the IEEE quotient's t where y lies within 2^-13
    of a half-integer; the low byte of t. Returns (codes int8, how many
    took the quotient)."""
    v, s = np.asarray(v, np.float32), np.float32(s)
    magic = np.float32(12582912)
    y = v * (np.float32(1) / s)
    t = y + magic
    near = np.abs(np.abs(y - (t - magic)) - np.float32(0.5)) <= np.float32(2.0 ** -13)
    t = np.where(near, v / s + magic, t)
    return (t.view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8), int(near.sum())


def test_quant_byte_in_row_needs_no_clip():
    """quant_byte_in_row's codes, with no clip, equal clip(rint(v / s), +-127)
    with v / s an IEEE f32 division for every v of a row whose scale is s =
    max(amax, 1e-8) / 127: at +-amax, at every half-integer multiple of s
    in the row's range and its f32 neighbours, at random values, and in rows
    below the 1e-8 floor."""
    rng = np.random.default_rng(20)
    for amax in np.concatenate([np.float32(rng.uniform(1e-4, 1e4, 40)),
                                np.float32([1e-9, 3e-12, 127, 1])]):
        amax = np.float32(amax)
        s = np.maximum(amax, np.float32(1e-8)) / np.float32(127)
        half = (np.arange(-127, 127, dtype=np.float32) + np.float32(0.5)) * s
        half = half[np.abs(half) <= amax]
        v = np.concatenate([half, np.nextafter(half, np.float32(np.inf)),
                            np.nextafter(half, np.float32(-np.inf)), [amax, -amax],
                            np.float32(rng.uniform(-1, 1, 512)) * amax]).astype(np.float32)
        v = v[np.abs(v) <= amax]
        got, _ = _quant_bytes_in_row(v, s)
        assert np.array_equal(got, np.clip(np.rint(v / s), -127, 127).astype(np.int8))


def _warp_q_int8(qf: np.ndarray):
    """numpy mirror of ``direct_q_int8`` for one (batch row, kv head) group:
    qf (G, D) f32 (bf16 values) on lanes (g, t) of a warp, lane 4 g + t
    holding channels [32 t, 32 t + 32) of head row g, rows g >= G zeros; the
    lane's max of |q|, the xor-shuffle tree over the 32 lanes (every lane
    ends with the same value), qs = max(amax, 1e-8) / 127 in an f32 IEEE
    division and qi by ``_quant_bytes``. Returns (qi (G, D), qs f32)."""
    g = qf.shape[0]
    lanes = np.zeros((8, 4, 32), np.float32)
    lanes[:g] = qf.reshape(g, 4, 32)
    amax = np.abs(lanes).max(axis=2).reshape(32)
    for o in (16, 8, 4, 2, 1):
        amax = np.maximum(amax, amax[np.arange(32) ^ o])
    assert (amax == amax[0]).all()
    qs = np.maximum(amax[0], np.float32(1e-8)) / np.float32(127)
    assert qs.dtype == np.float32
    qi, _ = _quant_bytes(lanes[:g].reshape(g, k2.HEAD_DIM), qs)
    return qi, qs


@pytest.mark.parametrize("g", [1, 4, 8])
def test_k5_warp_q_quantize_is_the_plain_ones(g):
    """Each warp's q quantize (``_warp_q_int8``) gives
    ``quantize_q_plain``'s qi and qs bit for bit: groups of random bf16
    heads, of heads with a zero row, with a row far larger than the rest,
    and of zero heads only (qs from the 1e-8 floor), at G = 1, 4 and 8."""
    rng = np.random.default_rng(19 + g)
    groups = rng.standard_normal((6, g, k2.HEAD_DIM)) * np.array([1, 1, 3, 0.01, 1, 0])[:, None,
                                                                                         None]
    groups[1, -1] = 0.0  # a zero head row (G = 1: a zero group)
    groups[4, 0] *= 1000.0
    qf = torch.from_numpy(groups).to(torch.bfloat16).to(torch.float32)  # (6, G, D)
    qi, qs = k2.quantize_q_plain(qf[None])  # (1, 6, G, D), (1, 6)
    for n in range(groups.shape[0]):
        mqi, mqs = _warp_q_int8(qf[n].numpy())
        assert np.float32(mqs).view(np.int32) == qs[0, n].numpy().view(np.int32), n
        assert np.array_equal(mqi, qi[0, n].numpy()), n
    assert float(qs[0, 5]) == np.float32(1e-8) / np.float32(127)


@pytest.mark.parametrize("kind", DIRECT_KINDS)
def test_k6_k7_launch_asks_the_mainloop_plan(kind, monkeypatch):
    """K5's, K6's and K7's launch takes the decode mainloop's plan over
    their stored rows (``plan_for``, direct) and checks a given plan before
    it touches a device: a plan the kernel does not build (their ring is
    built at three stages) raises ValueError on the CPU as on the card."""
    b, h, hkv, t, d = 2, 8, 2, 100, k2.HEAD_DIM
    dtype, row = {"i8": (torch.int8, d), "f8": (torch.float8_e4m3fn, d),
                  "i4": (torch.int32, d // 8)}[kind]
    q = torch.zeros((b, h, d), dtype=torch.bfloat16)
    kc = torch.zeros((b, t, hkv, row), dtype=torch.float32).to(dtype)
    sc = torch.ones((b, hkv, t))
    args = (q, kc, sc, kc, sc, torch.tensor([5, 100], dtype=torch.int32), d ** -0.5)
    asked = []

    class Asked(Exception):
        pass

    def spy(*a, **kw):
        asked.append((a, kw))
        raise Asked

    with monkeypatch.context() as m:
        m.setattr(k2, "plan_for", spy)
        with pytest.raises(Asked):
            k2._launch_quant(kind, *args)
    rb = k2.DIRECT_KINDS[kind]
    assert asked == [((b * hkv, t, rb), {"direct": True})]
    bad = [k2.DecodePlan(1, 64, 5, 2), k2.DecodePlan(3, 64, 3, 1), k2.DecodePlan(1, 64, 3, 1),
           k2.DecodePlan(2, 64, 4, 1), k2.DecodePlan(1, 128, 8, 1)]
    for plan in bad:
        with pytest.raises(ValueError, match="not a plan"):
            k2._launch_quant(kind, *args, plan)


@pytest.mark.parametrize("kind", ["i8", "f8", "i4", "v8"])
def test_quant_wrappers_hand_the_kernel_an_aligned_q(kind):
    """The quantized kinds' kernels read q in 16-byte loads: a contiguous q
    view that starts off a 16-byte boundary is handed on as an aligned copy
    of the same values, and the output is the aligned q's."""
    b, h, hkv, t, d = 2, 8, 2, 40, k2.HEAD_DIM
    dtype, row = {"i8": (torch.int8, d), "f8": (torch.float8_e4m3fn, d),
                  "i4": (torch.int32, d // 8), "v8": (torch.float8_e5m2, d)}[kind]
    gen = torch.Generator().manual_seed(len(kind))
    buf = torch.randn((1 + b * h * d,), generator=gen).to(torch.bfloat16)
    q = buf[1:].view(b, h, d)
    assert q.is_contiguous() and q.data_ptr() % 16
    kc, vc = (torch.randint(-100, 100, (b, t, hkv, row), generator=gen, dtype=torch.int32)
              .to(torch.float32).to(dtype) if dtype != torch.int32
              else torch.randint(-2 ** 31, 2 ** 31 - 1, (b, t, hkv, row), generator=gen,
                                 dtype=torch.int32) for _ in range(2))
    ks, vs = (torch.rand((b, hkv, t), generator=gen) / 64 for _ in range(2))
    lens = torch.tensor([7, t], dtype=torch.int32)
    qa, _ = k2._check_quant(kind, q, kc, ks, vc, vs, lens)
    assert qa.data_ptr() % 16 == 0 and torch.equal(qa, q)
    wrapper = k2._QUANT_WRAPPERS[kind]
    torch.testing.assert_close(wrapper(q, kc, ks, vc, vs, lens),
                               wrapper(q.clone(), kc, ks, vc, vs, lens), rtol=0, atol=0)


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


# K12n: the one-warp-a-row kernel of ao_tpu_torch/csrc/fused_act.cu
# (norm_modulate_quant_warp_kernel), mirrored in numpy f32


def _lane_tree(x, op):
    """The xor-shuffle tree over the 32 lanes of axis 1: every lane ends
    with the same value."""
    for o in (16, 8, 4, 2, 1):
        x = op(x, x[:, np.arange(32) ^ o])
    assert (x == x[:, :1]).all()
    return x[:, 0]


def _k12n_warp_mirror(h, shift, smod, eps):
    """K12n one warp a row: h (R, D) f32 (bf16 values), shift / smod (D,);
    lane l holds chunks l + 32 c (c < C) of 8 values, the last predicated
    where D / 8 is not a multiple of 32; each of the three reductions is the
    lane's f32 sum (or max) in chunk order, then the xor tree; every step
    one f32 rounding (the fma d * d + sq through f64, exact before its one
    rounding but for a double rounding no data here reaches); the codes by
    ``_quant_bytes``. Returns (q int8 (R, D), scale f32 (R,))."""
    r, d = h.shape
    n = d // 8
    c_max = -(-n // 32)
    idx = np.arange(32)[:, None] + 32 * np.arange(c_max)[None, :]  # (lane, c) chunk
    valid = idx < n
    lanes = np.zeros((r, 32, c_max, 8), np.float32)
    lanes[:, valid] = h.reshape(r, n, 8)[:, idx[valid]]
    f32 = np.float32

    def lane_sum(step):
        acc = np.zeros((r, 32), np.float32)
        for c in range(c_max):
            for i in range(8):
                acc = np.where(valid[None, :, c], step(acc, lanes[:, :, c, i]), acc)
        return _lane_tree(acc, np.add)

    mu = lane_sum(lambda acc, x: acc + x) / f32(d)
    sq = lane_sum(lambda acc, x: ((x - mu[:, None]).astype(np.float64) ** 2
                                  + acc).astype(np.float32))
    rs = f32(1) / np.sqrt(sq / f32(d) + f32(eps))
    yn = (lanes - mu[:, None, None, None]) * rs[:, None, None, None]
    mod = lambda m: m.reshape(n, 8)[np.minimum(idx, n - 1)]  # noqa: E731  (lane, c, 8)
    y = yn * (f32(1) + mod(smod)) + mod(shift)
    y = np.where(valid[None, :, :, None], y, f32(0))
    amax = _lane_tree(np.abs(y).max(axis=(2, 3)), np.maximum)
    sc = np.maximum(amax, f32(1e-8)) / f32(127)
    q = np.stack([_quant_bytes(y[i], sc[i])[0] for i in range(r)])
    out = np.zeros((r, n, 8), np.int8)
    out[:, idx[valid]] = q[:, valid]
    return out.reshape(r, d), sc


@pytest.mark.parametrize("d", [768, 1024, 1152, 2048])
def test_k12n_warp_reduction_order_keeps_the_plain_codes(d):
    """K12n's one-warp-a-row order of sums (lane partials in chunk order,
    then the xor tree) against ``norm_modulate_quant_plain`` on bf16 rows
    from a seed: codes at most 1 LSB off on under ``LSB_FRACTION`` of
    values, scales within ``K12N_SCALE_RTOL`` (chip_smoke.py's checks)."""
    rng = np.random.default_rng(d)
    rows = 256
    to_bf16 = lambda x: torch.from_numpy(x).to(torch.bfloat16)  # noqa: E731
    h = to_bf16(rng.standard_normal((1, rows, d)) * 2 + 0.5)
    shift, smod = (to_bf16(rng.standard_normal((1, d)) * 0.1) for _ in range(2))
    qr, sr = k12.norm_modulate_quant_plain(h, shift, smod, 1e-6)
    q, sc = _k12n_warp_mirror(h[0].float().numpy(), shift[0].float().numpy(),
                              smod[0].float().numpy(), 1e-6)
    diff = np.abs(q.astype(np.int32) - qr[0].numpy().astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < _smoke.LSB_FRACTION
    rel = np.abs(sc - sr[0, :, 0].numpy()) / sr[0, :, 0].numpy()
    assert rel.max() <= _smoke.K12N_SCALE_RTOL


def test_k12n_takes_the_warp_kernel_up_to_2048():
    """The wrapper's choice of K12n's kernel by D alone: one warp a row up
    to 2048 values (SAM-B 768, SAM-L 1024, DiT-XL 1152, SAM-H 1280), one
    block a row above; the launch asks it before it touches a device, and a
    warp launch above 2048 or an unknown form raises ValueError on the CPU
    as on the card."""
    assert [k12.norm_form(d) for d in (128, 768, 1024, 1152, 1280, 2048)] == ["warp"] * 6
    assert [k12.norm_form(d) for d in (2176, 3072, 5120)] == ["block"] * 3
    for d in (768, 3072):
        h = torch.zeros((2, 3, d), dtype=torch.bfloat16)
        mod = torch.zeros((2, d), dtype=torch.bfloat16)
        asked = []

        class Asked(Exception):
            pass

        def spy(width):
            asked.append(width)
            raise Asked

        with pytest.MonkeyPatch.context() as m:
            m.setattr(k12, "norm_form", spy)
            with pytest.raises(Asked):
                k12._launch_norm(h, mod, mod, 1e-6)
        assert asked == [d]
    with pytest.raises(ValueError, match="no 'warp' kernel"):
        k12._launch_norm(h, mod, mod, 1e-6, form="warp")
    with pytest.raises(ValueError, match="no 'rows' kernel"):
        k12._launch_norm(h, mod, mod, 1e-6, form="rows")


# K4: the table-and-permute decode of ao_tpu_torch/csrc/int4_w4a8.cu
# (code_table, decode_word) and its items, one a CTA, mirrored in numpy


def _prmt(a, b, sel):
    """prmt.b32 in its default mode over uint32 arrays: byte n of the result
    is byte sel[4n+2:4n] of {b, a}, or its sign bit over all eight bits
    where sel[4n+3] is set."""
    a, b, sel = np.broadcast_arrays(*(np.asarray(x, np.uint32) for x in (a, b, sel)))
    src = np.stack([(v >> np.uint32(8 * i)) & np.uint32(0xFF) for v in (a, b) for i in range(4)])
    out = np.zeros(a.shape, np.uint32)
    for n in range(4):
        nib = (sel >> np.uint32(4 * n)) & np.uint32(0xF)
        byte = np.take_along_axis(src, (nib & np.uint32(7)).astype(np.int64)[None], 0)[0]
        byte = np.where(nib & np.uint32(8), np.where(byte & np.uint32(0x80), 0xFF, 0), byte)
        out |= byte.astype(np.uint32) << np.uint32(8 * n)
    return out


def _k4_tables(a, b):
    """code_table: a, b f32 (...) -> (..., 4) uint32, code u in byte u % 4 of
    word u / 4: clip(u * a + b, +-127) + 1.5 * 2^23, each step one f32
    rounding, its low byte."""
    u = np.arange(16, dtype=np.float32)
    v = u * np.asarray(a, np.float32)[..., None] + np.asarray(b, np.float32)[..., None]
    code = (np.clip(v, np.float32(-127), np.float32(127)) + np.float32(12582912)).view(np.uint32)
    code = (code & np.uint32(0xFF)).reshape(code.shape[:-1] + (4, 4))
    return (code << (np.uint32(8) * np.arange(4, dtype=np.uint32))).sum(-1, dtype=np.uint32)


def _k4_decode_words(w, ta, tb):
    """decode_word over uint32 words w (...) with their tables (..., 4):
    (plane A's four codes, plane B's) as uint32 words."""
    w = np.asarray(w, np.uint32)
    ws = _prmt(w, 0, 0x3120)
    xa, xb = ws & np.uint32(0x07070707), (ws >> np.uint32(4)) & np.uint32(0x07070707)
    sa, sb = xa | (xa >> np.uint32(12)), xb | (xb >> np.uint32(12))
    ma, mb = _prmt(w << np.uint32(4), 0, 0xBA98), _prmt(w, 0, 0xBA98)
    qa = (_prmt(ta[..., 2], ta[..., 3], sa) & ma) | (_prmt(ta[..., 0], ta[..., 1], sa) & ~ma)
    qb = (_prmt(tb[..., 2], tb[..., 3], sb) & mb) | (_prmt(tb[..., 0], tb[..., 1], sb) & ~mb)
    return qa, qb


def _k4_mirror(word, a, b, g):
    """K4's launch, one item of 256 K rows x 64 columns a CTA: each
    thread's 8 word rows by 4 columns decoded into the shared tile (16-byte
    chunks at c ^ ((column / 4) & 7)), the tile copied out, 16 threads a
    column. Every 16-byte chunk of the (N, K) output is written once.
    Returns the (K, N) int8 view."""
    kw, n = word.shape
    k = 8 * kw
    slabs, cols = k // 256, k1.REQUANT_COLS
    w32 = word.view(np.uint32)
    out = np.zeros((n, k), np.uint8)
    written = np.zeros((n, k // 16), np.int64)
    for it in range(k1.requant_plan(k, n)):
        s, n_tile = it % slabs, it // slabs * cols
        tile = np.zeros((cols, 16, 16), np.uint8)
        for tid in range(cols):
            cg, ch = tid % (cols // 4), tid // (cols // 4)
            n0 = n_tile + 4 * cg
            r0 = 32 * s + 8 * ch
            t = r0 // (g // 4)
            ta = _k4_tables(a[2 * t, n0:n0 + 4], b[2 * t, n0:n0 + 4])
            tb = _k4_tables(a[2 * t + 1, n0:n0 + 4], b[2 * t + 1, n0:n0 + 4])
            qa, qb = _k4_decode_words(w32[r0:r0 + 8, n0:n0 + 4], ta[None], tb[None])
            ca = (2 * t * g + 4 * (r0 % (g // 4)) - 256 * s) // 16
            for ci in range(4):
                for c, q in ((ca, qa[:4]), (ca + 1, qa[4:]), (ca + g // 16, qb[:4]),
                             (ca + g // 16 + 1, qb[4:])):
                    tile[4 * cg + ci, c ^ (cg & 7)] = q[:, ci].astype("<u4").view(np.uint8)
        for tid in range(cols):
            c = tid % 16
            for j in range(16):
                nl = tid // 16 + j * (cols // 16)
                out[n_tile + nl, 256 * s + 16 * c:256 * s + 16 * c + 16] = tile[
                    nl, c ^ ((nl >> 2) & 7)]
                written[n_tile + nl, 16 * s + c] += 1
    assert (written == 1).all()
    return out.view(np.int8).T


@pytest.mark.parametrize("g", [32, 64, 128])
@pytest.mark.parametrize("k,n", [(512, 192), (768, 320)])
def test_k4_table_decode_is_the_plain_version(g, k, n):
    """K4's tables, its permuted lookups and its items give
    ``int4_magic8_requant_int8_plain``'s int8 bit for bit: random words
    (every nibble, 0 and 15 included), a and b that put u * a + b on
    half-integers (ties) and past +-127 (clips), and a group of arbitrary
    f32 products."""
    rng = np.random.default_rng(g + k + n)
    word = rng.integers(-2 ** 31, 2 ** 31, (k // 8, n)).astype(np.int32)
    ng = k // g
    a = (rng.integers(-40, 41, (ng, n)) * 0.5).astype(np.float32)
    b = (rng.integers(-300, 301, (ng, n)) * 0.5).astype(np.float32)
    a[1] = (rng.standard_normal(n) * 20).astype(np.float32)
    b[1] = (rng.standard_normal(n) * 50).astype(np.float32)
    u = k1.unpack_int4_magic8(torch.from_numpy(word), g).numpy()
    v = u * np.repeat(a, g, 0) + np.repeat(b, g, 0)
    assert {0, 15} <= set(np.unique(u)) and (v > 127.5).any() and (v < -127.5).any()
    assert (v - np.floor(v) == 0.5).any()
    want = k1.int4_magic8_requant_int8_plain(torch.from_numpy(word), torch.from_numpy(a),
                                             torch.from_numpy(b), g).numpy()
    assert np.array_equal(_k4_mirror(word, a, b, g), want)


def test_k4_plan_is_one_item_a_cta():
    """requant_plan at the W4A8 prefill's five (K, N) and at small ones:
    one item of 256 K rows x 64 columns a CTA, the items covering K and N
    in whole tiles; a width K4 has no whole tiles for raises ValueError
    before any launch."""
    for k, n in _smoke.LLAMA_KN + [(1024, 448), (256, 64), (768, 320)]:
        assert k1.requant_plan(k, n) * 256 * 64 == k * n
    assert [k1.requant_plan(k, n) for k, n in _smoke.LLAMA_KN] == [1024, 256, 3584, 3584, 32064]
    for kw, n in ((32, 96), (32, 4100), (24, 64)):
        with pytest.raises(ValueError, match="must be a multiple of 64"):
            k1.check_shapes_requant(torch.zeros((kw, n), dtype=torch.int32), 128)


# K12g: the four-warps-a-row kernel of ao_tpu_torch/csrc/fused_act.cu
# (gelu_quant_warps_kernel) and the block kernel above 3072, mirrored in numpy


def _gelu_f32(x):
    """gate<1>'s tanh-GELU in f32: the cubic's add an FMA (through f64, exact
    before its one rounding but for a double rounding no data here reaches),
    every other step one f32 rounding; numpy's f32 tanh."""
    f32 = np.float32
    x3 = x * x * x
    s = (np.float64(f32(0.044715)) * x3.astype(np.float64) + x.astype(np.float64)).astype(f32)
    return x * (f32(0.5) * (f32(1) + np.tanh(f32(0.7978845608028654) * s)))


def _k12g_mirror(x):
    """K12g on rows x (R, D) f32 (bf16 values) in ``gelu_form(D)``'s form:
    in the warps kernel lane l of warp w of a row's 4 holds chunks 32 (4 c
    + w) + l (the last predicated), each lane's max of |GELU|, the xor tree,
    then the 4 warps' maxima; codes by ``_quant_bytes_in_row``; the block
    kernel's codes by the IEEE division. Returns (q int8 (R, D), scale f32
    (R,))."""
    r, d = x.shape
    y = _gelu_f32(x)
    warps = k12.gelu_form(d) == "warps"
    if warps:
        n, w = d // 8, 4  # kGeluRowWarps
        c_max = -(-n // (32 * w))
        assert c_max <= 3
        idx = (32 * (w * np.arange(c_max)[None, None, :] + np.arange(w)[:, None, None])
               + np.arange(32)[None, :, None])  # (warp, lane, c) chunk
        chunks = np.zeros((r, w, 32, c_max, 8), np.float32)
        chunks[:, idx < n] = y.reshape(r, n, 8)[:, idx[idx < n]]
        assert sorted(idx[idx < n].tolist()) == list(range(n))
        lane_max = np.abs(chunks).max(axis=(3, 4))  # (r, warp, lane)
        amax = np.stack([_lane_tree(lane_max[:, i], np.maximum) for i in range(w)], 1).max(1)
    else:
        amax = np.abs(y).max(axis=1)
    sc = np.maximum(amax, np.float32(1e-8)) / np.float32(127)
    if warps:
        q = np.stack([_quant_bytes_in_row(y[i], sc[i])[0] for i in range(r)])
    else:
        q = np.clip(np.rint(y / sc[:, None]), -127, 127).astype(np.int8)
    return q, sc


@pytest.mark.parametrize("d", [128, 768, 1536, 3072, 5120])
def test_k12g_reduction_order_and_codes_keep_the_plain_ones(d):
    """K12g's form at D (4 warps a row up to 3072: lane maxima, the xor
    tree, the warps' maxima, codes from the reciprocal; one block a row
    above) against
    ``gelu_quant_plain`` on bf16 rows from a seed: codes at most 1 LSB off
    on under ``LSB_FRACTION`` of values, scales within ``K12_SCALE_RTOL``
    (chip_smoke.py's checks)."""
    rng = np.random.default_rng(d + 20)
    y = torch.from_numpy(rng.standard_normal((1, 96, d)) * 2 + 0.5).to(torch.bfloat16)
    qr, sr = k12.gelu_quant_plain(y)
    q, sc = _k12g_mirror(y[0].float().numpy())
    diff = np.abs(q.astype(np.int32) - qr[0].numpy().astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < _smoke.LSB_FRACTION
    rel = np.abs(sc - sr[0, :, 0].numpy()) / sr[0, :, 0].numpy()
    assert rel.max() <= _smoke.K12_SCALE_RTOL


def test_k12g_takes_the_warps_kernel_up_to_3072():
    """The wrapper's choice of K12g's kernel by D alone: 4 warps a row up
    to 3072 values (SAM-B's MLP), one block a row above (SAM-L's 4096,
    SAM-H's 5120); the launch asks it before it touches a device, and a
    warps launch above 3072 or an unknown form raise ValueError on the CPU
    as on the card."""
    assert [k12.gelu_form(d) for d in (128, 768, 1024, 2944, 3072)] == ["warps"] * 5
    assert [k12.gelu_form(d) for d in (3200, 4096, 5120)] == ["block"] * 3
    for d in (768, 5120):
        y = torch.zeros((2, 3, d), dtype=torch.bfloat16)
        asked = []

        class Asked(Exception):
            pass

        def spy(width):
            asked.append(width)
            raise Asked

        with pytest.MonkeyPatch.context() as m:
            m.setattr(k12, "gelu_form", spy)
            with pytest.raises(Asked):
                k12._launch_gelu(y)
        assert asked == [d]
    with pytest.raises(ValueError, match="no 'warps' kernel"):
        k12._launch_gelu(y, form="warps")
    with pytest.raises(ValueError, match="no 'rows' kernel"):
        k12._launch_gelu(y, form="rows")
    for shape, dtype in (((2, 3, 3200), torch.float32), ((2, 3, 4096), torch.bfloat16)):
        with pytest.raises(ValueError, match="no 'warps' kernel at D="):
            k12._launch_gelu(torch.zeros(shape, dtype=dtype), form="warps")
