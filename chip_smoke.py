"""Smoke run of the PyTorch/CUDA port (``ao_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

From the repo root, on a machine with a CUDA device and ``nvcc``:

1. prints the card (``torch.cuda.get_device_name`` and ``nvidia-smi``'s name
   and power limit);
2. builds every hand-written kernel from ``ao_tpu_torch/csrc`` (one ``nvcc``
   per source, all started together) into ``ao_tpu_torch/_build/``;
3. holds each kernel against its plain PyTorch version on the card at the
   shapes the main paths give it, and times kernel, plain version, a library
   yardstick where one PyTorch call computes the same function, and the
   least time the card could take (the bound); K1 (int4-WO) at M = 8, 128,
   512 and 1024 over every Llama-3-8B width and at ViT-B/16's w2 (M = 788,
   3072x768), with each launch's tiles and K split;
   The decode attention kernels over the quantized caches (K5 int8, K6 fp8,
   K7 int4, K2v int8 and e5m2 on K2's decode mainloop) are also timed, with
   K2 and the paged K9 in
   its three modes (bf16; "vec8" over int8 and fp8 pools; int4), at T =
   4096, where the cache bytes set the bound, K5-K7 at the slot engine's
   decode shape, and the flash prefill K8 at S = 2048; the int8 weight-only
   K10, the fp8 blockwise K17, the fp4 K14 (MXFP4 and NVFP4) and the NF4
   LUT kernel K15 at M = 8 and 1024 over every Llama-3-8B width (K10's and
   K17's launches with their tiles and K split, K17 beside cuBLAS's fp8
   product with rowwise scales on the same operands); the vision
   slice's kernels at its paths' shapes: the int4 split-half matmul K11 at
   ViT-B's M = 788 rows (with ``autotune_int4``'s winners at both shapes,
   tuned into a temporary tile cache, beside the heuristic's tiles and
   times), the LayerNorm-modulate and GELU producer quantize
   K12n and K12g at SAM-B's windowed and global rows, and the windowed
   attention with the decomposed rel-pos bias K16 at SAM-B's windows (side
   14) and global layers (side 64); the MoE grouped int4 kernel K13 (magic
   and W4A8) at Mixtral's shapes. Then two
   tiny models whose attention shapes no attention kernel
   takes (head_dim 256; 16 query heads per kv head) decode through
   generate, a flash-route prefill and a paged step against the "torch"
   backend, with the kernels launched only where their ``takes`` allows;
4. drives the main paths on Llama-3-8B widths with random weights from a
   seed, each with greedy ``generate`` at batch 8, a 128-token prompt, 64
   steps and max_seq 256: int4 weight-only
   (``quantize_(params, Int4WeightOnlyConfig(group_size=128))``), W4A8
   (``quantize_(params, Int8DynamicActivationInt4WeightConfig(group_size=128))``)
   and int4 weight-only over each quantized KV cache (``kv_quant`` "int8",
   "float8_e4m3fn", "int4", "float8_e5m2"), int4 weight-only with the
   flash-attention prefill (``use_flash=True``), and, one quantized model
   on the card at a time, int8 weight-only (``Int8WeightOnlyConfig()``:
   K10), W8A8 (``Int8DynamicActivationInt8WeightConfig()``: torch._int_mm,
   K12s at prefill), fp8 rowwise
   (``Float8DynamicActivationFloat8WeightConfig()``: torch._scaled_mm) and
   fp8 blockwise (``granularity=PerBlock((128, 128))``: K17), MXFP4
   (``MXWeightOnlyConfig(elem_dtype="float4_e2m1fn")``: K14), NVFP4
   (``NVFP4WeightOnlyConfig()`` and, with dynamic fp4 activations,
   ``NVFP4DynamicActivationNVFP4WeightConfig()``: K14) and NF4
   (``NF4WeightOnlyConfig()``: K15), each timed over its launch-count
   call; the four quantized-KV paths and these eight weight paths run the
   first 8 of the 32 layers (``CUT_LAYERS``), beside int4-WO and bf16 at
   the same depth. For each it sets every launch counter to 0 just before the call
   and checks the counts just after (every kernel of the path, exactly as
   the model predicts), checks that the tokens are well
   formed, and that a two-layer cut of the same model gives the plain
   route's logits; then times the tok/s of every path and of bf16 on the
   same loop, in turns, and profiles the prefill and a few decode steps of
   each (host wall time, device busy time, the kernels that take it);
5. serves the int4 weight-only model with ``Engine`` in both KV layouts
   (slots, and pages of 128), over a bf16 KV and over each quantized KV
   (``kv_quant`` "int8", "float8_e4m3fn", "int4"), eight runs on the same
   16 requests, submitted at once to 8 slots: prompts of 32-900 tokens
   (bucketed prefills of 128 and 512, chunked past 512), 16-64 new tokens,
   two of them sampled. Each run's launch counts are checked exactly
   against the engine's own schedule (K8 per bucketed prefill, K1 per
   forward, and per decode step and layer K2 / K5 / K6 / K7 over the slots
   or K9 in the pool's mode), every request must finish with its tokens,
   and the run prints requests/s, output tok/s, the mean time to first
   token and the profile of one engine step. Two-layer logits of the flash
   prefill, a per-slot decode step and a paged decode step are held to the
   plain route's, over bf16 and over each quantized KV;
6. drives the vision models at full width with random weights from the
   seed: SAM-B (12 layers, 4 images of 1024^2, 2 point prompts each, the
   rel-pos tables filled) through ``sam.forward`` under
   ``Int8DynamicActivationInt8WeightConfig()`` (K16, K12n, K12g,
   torch._int_mm) and in bf16 (K16), and ViT-B/16 (12 layers, batch 4 at
   224^2) through ``vit.forward`` under
   ``Int4WeightOnlyConfig(group_size=128)`` (K11, K1) and in bf16; launch
   counts exact, masks, IoU and logits held to the "torch" backend's, and
   images/s with a profile of one forward each;
7. drives the MoE FFN at Mixtral-8x7B's published widths (8 experts, top-2;
   random weights from the seed, built and quantized one layer at a time):
   greedy ``generate`` under int4-WO at 32 layers (K13 magic for every
   expert stack at decode and at the 2048-row prefill: its row tiles),
   W4A8 (K13 w4a8 at decode, the ragged fallback at the prefill) and bf16
   at 8, with exact launch counts, two-layer logits against
   the plain route with the router's decisions pinned to the plain route's,
   K13 alone against its plain version in the same route, a decode-shape MoE
   FFN under CUDA's sync debug mode, tok/s and profiles, then one slot
   ``Engine`` run over the 32-layer int4-WO model (K13 at decode and in
   every bucketed or chunked prefill). K13 itself is held to its plain
   version in both forms at Mixtral's decode rows (16) over both expert
   widths, in the magic form also at the engine buckets' 256 and 1024 rows
   and generate's 2048 over both widths (w4a8 at 256 rows of 4096x14336
   too, which no path launches), with one routing of every row onto one
   expert;
8. drives the sparsity slice at ViT-L/16's full width (24 layers, batch 16
   at 224^2: 3152 rows per linear; random weights from the seed) through
   ``vit.forward``: block-sparse MLPs
   (``sparsify_(params, BlockSparseWeightConfig(blocksize=64,
   keep_fraction=0.1), <the 48 mlp.w1 / mlp.w2>)``: K18, 48 launches), 2:4
   (``SemiSparseWeightConfig()``), 2:4 with int4 values
   (``Sparse24Int4WeightConfig(group_size=128)``) and bf16, with exact
   launch counts, BSR logits against the "torch" backend, 2:4 logits against
   the dense forward on the dequantized weights, images/s of the four timed
   in turns and a profile each. K18 itself is held to its plain version at
   ViT-L's w1 / w2 at b = 64, keep 0.1 and b = 128, keep 0.5, at the JAX
   suite's two shapes and on a fully dense BSR weight, and timed beside
   cuBLAS on the dequantized weight and ``torch.sparse``'s BSR product, with
   each launch's plan and the host cost of one linear call through each
   route at ViT-L's shapes.

Each phase prints its seconds. Prints the kernel table as one JSON line and, as the last line,
``{"ok": true, "device": {...}}``. Any failed check makes it exit non-zero
without that line; so does a machine without a CUDA device.

    python3 chip_smoke.py --kernels K1,K2,K2v,K3,K8,K9,K10,K11,K13,K14,K15,K16,K17,K18

builds, then runs only the named kernels' phases (K1, K2, K2v, K3, K8, K9,
K10, K11, K13, K14, K15, K16, K17, K18) and prints their rows as JSON, with no
result line (``--sam`` the SAM-B paths alone, with images/s; ``--vitl`` the
ViT-L/16 sparse paths alone, with images/s and profiles; ``--mixtral``
the Mixtral paths alone, with tok/s, the prefill's device time and the
engine's TTFT); the K1, K10, K15 and K17 rows name each launch's tiles and
K split, the K3 rows their CTA width and K split and the device kernels a
call, the K2, K2v and K9 rows (K2 at generate's, the slot engine's and the
long shape; K2v over its e5m2 and int8 caches at generate's and the long
shape; K9 in each mode at the paged engine's and the long shape) their
decode-mainloop plan and the device kernels a call (one, checked), the K13
rows the magic form's K split or row tile, the K8 and K16
rows its query rows a CTA, the K18 rows each launch's plan (cluster split,
CTAs, items) and the device kernels a call (one, checked). A copy of this
script run in another checkout times that checkout's kernels, so two trees'
kernels can be set side by side on one card in one run (a checkout whose
own script predates a kernel's name here takes a copy of this one: the
phases call only the wrappers' ``_launch*``, plain versions and ``traffic*``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import random
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s; dense bf16, int8 and fp8
# tensor-core rates; f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
FP8_FLOPS_PER_S = 1979e12
F32_FLOPS_PER_S = 67e12

K1_SQNR_DB = 45.0  # the JAX suite's bound for the int4 kernel (tests/test_pallas_interpret.py)
K2_SQNR_DB = 40.0  # decode attention: f32 scores and softmax in both versions
K3_SQNR_DB = 45.0  # the JAX suite's bound for the W4A8 kernel (tests/test_pallas_interpret.py)
LSB_FRACTION = 0.01  # K4, K12: at most 1 LSB off on under 1 % of values (the JAX suite's bound)
K12_SCALE_RTOL = 1e-6
K10_SQNR_DB = 45.0  # the JAX suite's bound for the int8 kernel (tests/test_pallas_interpret.py)
K17_SQNR_DB = 30.0  # the JAX suite's bound for the fp8 blockwise kernel, strictly above
# K14 and K15 against their plain versions, strictly above: the JAX suite's
# bounds for its MXFP4, NVFP4 and NF4 kernels (tests/test_pallas_interpret.py)
K14_SQNR_DB = {"mx": 60.0, "nv": 35.0}
K15_SQNR_DB = 40.0
NF4_GROUP = 64  # NF4WeightOnlyConfig's block size
PATH_SQNR_DB = 30.0  # two-layer logits, kernel route against the plain route (see check_logits)
# W4A8 and quantized caches: within 3 dB of the plain route's own nudge floor
# where that is below PATH_SQNR_DB + 3 (see check_logits), and never below
# PATH_MIN_DB
FLOOR_MARGIN_DB = 3.0
PATH_MIN_DB = 20.0

DEV = "cuda"
SEED = 0  # random weights and inputs are made from it
GROUP = 128
BATCH, PROMPT, MAX_SEQ, STEPS = 8, 128, 256, 64  # bench.py's generate
# every (M, K, N) the main paths give K1: wq/wo, wk/wv, w1/w3, w2 and the
# lm_head, at decode (M = B), at generate's prefill (M = B * prompt) and at
# the engine's prefills (M = 128 and 512: its buckets and its chunks); and
# ViT-B/16's w2 at batch 4 (M = 4 x 197; its 3072-wide input has 24 groups:
# the magic layout)
K1_SHAPES = [(m, k, n) for m in (BATCH, 128, 512, BATCH * PROMPT)
             for k, n in ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
                          (4096, 128256))] + [(4 * 197, 3072, 768)]
K1_REPORTED = (8, 4096, 14336)  # the decode shape that moves the most weight bytes per layer
K1_PREFILL = (BATCH * PROMPT, 4096, 4096)  # generate's prefill, wq / wo
K1_VIT = (4 * 197, 3072, 768)  # ViT-B/16's w2
# every (K, N) of Llama-3-8B's linears: wq/wo, wk/wv, w1/w3, w2, lm_head; the
# W4A8 path gives them to K3 at decode (M = B) and to K4 once per prefill
LLAMA_KN = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256)]
W4A8_KN = LLAMA_KN
KN_REPORTED = (4096, 14336)
# K10 (int8-WO) and K17 (fp8 blockwise) at decode (M = B) and at generate's
# prefill (M = B * prompt) over every Llama width
WEIGHT_SHAPES = [(m, k, n) for m in (BATCH, BATCH * PROMPT) for k, n in LLAMA_KN]
WEIGHT_REPORTED = ((BATCH, 4096, 14336), (BATCH * PROMPT, 4096, 4096))
# the int8, fp8, 4-bit float and NF4 weight paths of generate, all over a
# bf16 KV (K2); their configs in weight_config
WEIGHT_PATHS = ("int8-WO", "W8A8", "fp8-row", "fp8-block",
                "MXFP4-WO", "NVFP4-WO", "NVFP4-dyn", "NF4-WO")
# F1: two tiny models whose attention shapes no attention kernel takes
F1_CONFIGS = {"head_dim256": dict(n_heads=4, n_kv_heads=2, qk_head_dim=256),
              "group16": dict(n_heads=16, n_kv_heads=1, qk_head_dim=128)}
K12_SHAPE = (BATCH, PROMPT, 14336)  # the prefill SwiGLU gate
K2_SHAPE = dict(b=8, h=32, hkv=8, d=128, t=256)
K2_LENGTHS = [1, 256, 17, 64, 65, 128, 200, 255]  # ragged, with 1 and T
T_LONG = 4096  # every position valid: the cache bytes, not latency, set the bound
KV_QUANT = ("int8", "float8_e4m3fn", "int4")  # slots and pages
KV_ALL = KV_QUANT + ("float8_e5m2",)  # generate and slots
# the decode attention kernel of each quantized slot cache: (wrapper, kind,
# K number); K2v's int8 form serves an int8 cache without mode="i8", which
# no main path asks for
KV_KERNELS = {"int8": ("decode_attention_int8", "i8", "K5"),
              "float8_e4m3fn": ("decode_attention_fp8", "f8", "K6"),
              "int4": ("decode_attention_int4", "i4", "K7"),
              "float8_e5m2": ("decode_attention_vec8", "v8", "K2v")}
K2V_INT8 = ("decode_attention_vec8", "v8", "K2v")
SHORT = {"int8": "int8", "float8_e4m3fn": "fp8", "int4": "int4", "float8_e5m2": "e5m2"}
KV_TAG = {kv: f"int4-WO+{SHORT[kv]}KV" for kv in KV_ALL}
# K9's wrapper for each pool dtype
POOL_KERNELS = {None: "paged_decode_attention", "int8": "paged_decode_attention_vec8",
                "float8_e4m3fn": "paged_decode_attention_vec8",
                "int4": "paged_decode_attention_int4"}
K8_SQNR_DB = 40.0  # flash prefill: f32 scores and sums, bf16 p and out in both versions
# (B, Sq, Sk) of K8: the engine's 128 and 512 buckets, a long prefill where
# the operations set the bound, and generate(use_flash=True)
K8_SHAPES = [(1, 128, 128), (1, 512, 512), (1, 2048, 2048), (BATCH, PROMPT, MAX_SEQ)]
# the quantized-KV and the int8 / fp8 / 4-bit float / NF4 weight paths of
# generate run this many layers of Llama-3-8B (full widths); int4-WO, W4A8,
# bf16, int4-WO + flash and the engine runs keep all 32
CUT_LAYERS = 8
# the vision slice: SAM-B (4 images of 1024^2, 2 point prompts each) under
# W8A8 and in bf16, ViT-B/16 (batch 4 at 224^2) under int4-WO and in bf16
SAM_BATCH, SAM_POINTS, VIT_BATCH = 4, 2, 4
VISION_PATHS = ("SAM-B W8A8", "SAM-B bf16", "ViT-B/16 int4-WO", "ViT-B/16 bf16")
REL_POS_SCALE = 0.3  # the rel-pos terms come out about this large (the JAX suite's scale)
# the JAX suite's bounds for the split-half kernel (tests/test_pallas_interpret.py)
# and for the windowed attention kernel (tests/test_pallas_tpu.py)
K11_SQNR_DB = 45.0
K16_SQNR_DB = 35.0
# K12n's moments are summed in another order than the plain version's: its
# scales move by a few ulps of f32 (K12g's and K12s's by none)
K12N_SCALE_RTOL = 1e-5
# K11 at ViT-B's M = 4 x 197 over its 768-wide inputs; K12n / K12g at SAM-B's
# windowed (100 windows of 196) and global (4 x 4096) rows; K16 at its
# windowed (G = 100, side 14) and global (G = 4, side 64) layers
K11_SHAPES = [(VIT_BATCH * 197, 768, 768), (VIT_BATCH * 197, 768, 3072)]
K12N_SHAPES = [(100, 196, 768), (SAM_BATCH, 4096, 768)]
K12G_SHAPES = [(100, 196, 3072), (SAM_BATCH, 4096, 3072)]
K16_SHAPES = [(100, 14), (SAM_BATCH, 64)]
# the serving engine: Llama-3-8B int4-WO, 8 slots, max_seq 1024, pages of 128
ENGINE_CFG = dict(max_batch=8, max_seq=1024, prefill_buckets=(128, 512), eos_id=-1)
PAGE = 128
N_REQUESTS = 16
# K2 over the engine's slots and K9 over its pages: ragged lengths with 1
# and a full last page
ENGINE_LENGTHS = [1, 1024, 128, 129, 700, 64, 65, 1000]
# the MoE slice: Mixtral-8x7B's published widths (mistralai/Mixtral-8x7B-v0.1,
# config.json), random weights from SEED; built one layer at a time (its 32
# bf16 layers, 93 GB, do not fit the card)
MIXTRAL = dict(vocab_size=32000, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
               ffn_dim=14336, norm_eps=1e-5, rope_theta=1e6, tie_embeddings=False,
               n_experts=8, top_k_experts=2)
# W4A8 and bf16 Mixtral run the first MOE_CUT layers of the same model, beside
# int4-WO at 32 layers and at MOE_CUT
MOE_CUT = 8
# K13 (E = 8) where the main paths launch it: (form, T rows, K, N, path). A
# decode step puts 8 tokens x top-2 = 16 rows through w_gate / w_up (4096 x
# 14336) and w_down (14336 x 4096) in both forms; the slot engine's 128- and
# 512-token buckets put 256 and 1024 rows, and generate's prefill (8 x 128
# tokens) 2048 rows, through the same widths in the magic form (its row
# tiles). The w4a8 form is also held at 256 rows, where no path launches it
# (path None: no W4A8 engine runs)
K13_SHAPES = [(form, t, k, n, path)
              for form, t, path in (("magic", 16, "Mixtral int4-WO"),
                                    ("magic", 256, "Mixtral engine-slots"),
                                    ("magic", 1024, "Mixtral engine-slots"),
                                    ("magic", 2 * BATCH * PROMPT, "Mixtral int4-WO"),
                                    ("w4a8", 16, f"Mixtral W4A8/{MOE_CUT}L"))
              for k, n in ((4096, 14336), (14336, 4096))] + [("w4a8", 256, 4096, 14336, None)]
K13_SQNR_DB = 45.0  # the JAX suite's bound for its grouped kernels (tests/test_pallas_interpret.py)
# the sparsity slice: ViT-L/16 at batch 16 (M = 16 x 197 = 3152 rows per
# linear) with block-sparse MLPs (K18), 2:4, 2:4 with int4 values, and bf16
VITL_BATCH = 16
VITL_ROUNDS = 6  # timed forwards of each path, in turns
M_VITL = VITL_BATCH * 197
SPARSE_PATHS = ("ViT-L/16 BSR", "ViT-L/16 2:4", "ViT-L/16 2:4-int4", "ViT-L/16 bf16")
BSR_BLOCK, BSR_KEEP = 64, 0.1  # BlockSparseWeightConfig's default block, 10 % of the blocks
K18_SQNR_DB = 45.0  # K1's bound: both versions sum in f32 and round once
SPARSE_EXACT_DB = 60.0  # 2:4 against the dense forward on the dequantized weights
# K18 (M, K, N, b, keep, path): ViT-L's w1 / w2 as the BSR path gives them,
# the same at b = 128 and half the blocks, the JAX suite's two shapes
# (tests/test_pallas_tpu.py:212-236) and a fully dense BSR weight (keep
# None on a dense weight: every block), the worst case
K18_SHAPES = [(M_VITL, 1024, 4096, BSR_BLOCK, BSR_KEEP, "ViT-L/16 BSR"),
              (M_VITL, 4096, 1024, BSR_BLOCK, BSR_KEEP, "ViT-L/16 BSR"),
              (M_VITL, 1024, 4096, 128, 0.5, None), (M_VITL, 4096, 1024, 128, 0.5, None),
              (64, 1024, 1024, 128, 0.25, None), (1, 512, 640, 128, 0.5, None),
              (M_VITL, 1024, 4096, 64, None, None)]
K13_FORMS = {"magic": ("int4_grouped_magic", "grouped_matmul.py:149"),
             "w4a8": ("int4_grouped_w4a8", "grouped_matmul.py:294")}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def phase(name: str):
    """Print the seconds a phase of the run took (host clock)."""
    t0 = time.perf_counter()
    yield
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)


def bound(nbytes: int, ops: int, ops_per_s: float = BF16_FLOPS_PER_S):
    """(least ms for the work, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Failures(list):
    def check(self, ok: bool, what: str) -> bool:
        if not ok:
            self.append(what)
            print(f"FAIL: {what}", flush=True)
        return ok


def kernel_row(name, shape, got, ref, check, ms, plain_ms, library_ms, nbytes, ops,
               ops_per_s=BF16_FLOPS_PER_S, tiles=None):
    """One kernel's row; ``tiles`` (its launch's tiles and splits) is
    printed beside its time and kept in the row."""
    bound_ms, bound_by = bound(nbytes, ops, ops_per_s)
    err = float((got.float() - ref.float()).abs().max())
    lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
    launch = "" if tiles is None else f" ({tiles})"
    print(f"{name} {shape}: {check}, max|err| {err:.3g}; "
          f"kernel {ms:.4f} ms{launch}, plain {plain_ms:.4f} ms, library {lib}, "
          f"bound {bound_ms * 1e3:.2f} us ({bound_by}) = {bound_ms / ms:.1%} of kernel time",
          flush=True)
    row = dict(shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bound_ms, bound_by=bound_by)
    if tiles is not None:
        row["tiles"] = tiles
    return row


def magic_tiles(torch, m, k, n, g, kernel):
    """What a K1 (``kernel`` "K1") or K15 launch at (M, K, N, g) runs: the
    decode kernel's K split, or the mainloop's tiles and K split (None from
    a checkout whose wrappers predate ``launch_tiles``)."""
    from ao_tpu_torch.ops.hopper import int4_matmul as k1
    from ao_tpu_torch.ops.hopper import lut4_matmul as k15

    launch_tiles = getattr(k1 if kernel == "K1" else k15, "launch_tiles", None)
    if launch_tiles is None:
        return None
    bm, bn, splits, per, *run = launch_tiles(
        m, k, n, g, k1._sm_count(torch.device(DEV, torch.cuda.current_device())))
    if bm == k1.GEMV_MAX_M:
        unit = f"runs of {run[0]} word rows" if run else "super-groups"
        return f"decode kernel, {splits} splits of {per} {unit}"
    return f"tiles ({bm}, {bn}), {splits} splits of {per} stages"


def launch_desc(torch, mod, m, k, n, stage):
    """What a K10 (``mod`` int8_matmul) or K17 (fp8_matmul) launch at (M, K,
    N) runs: the decode kernel's K split, or the prefill tiles and K split
    in ``stage``s (None from a checkout whose wrapper predates
    ``launch_tiles``)."""
    launch_tiles = getattr(mod, "launch_tiles", None)
    if launch_tiles is None:
        return None
    from ao_tpu_torch.ops.hopper import int4_matmul as k1

    bm, bn, splits, per = launch_tiles(
        m, k, n, k1._sm_count(torch.device(DEV, torch.cuda.current_device())))
    if bm == mod.GEMV_MAX_M:
        return f"decode kernel, {splits} splits of {per} K units of 128"
    return f"tiles ({bm}, {bn}), {splits} splits of {per} {stage}"


def scaled_mm_rowwise(torch, qx, qw):
    """cuBLAS's fp8 tensor cores at this shape: (ms, what) of one
    ``torch._scaled_mm`` over the same e4m3 operands with rowwise scales
    (ones), a note beside K17's row and not its library column: rowwise
    scales are not K17's function."""
    from ao_tpu_torch.utils.timing import cuda_time_ms

    a = torch.ones((qx.shape[0], 1), dtype=torch.float32, device=DEV)
    b = torch.ones((1, qw.shape[1]), dtype=torch.float32, device=DEV)

    def run():
        return torch._scaled_mm(qx, qw, scale_a=a, scale_b=b, out_dtype=torch.bfloat16)

    try:
        run()
        torch.cuda.synchronize()
    except (RuntimeError, ValueError, TypeError) as e:
        return None, f"torch._scaled_mm rowwise refused: {str(e).splitlines()[0][:160]}"
    return cuda_time_ms(run, iters=10), "torch._scaled_mm rowwise (cuBLAS fp8)"


def lsb_check(got, ref):
    """(values more than 1 LSB off, share of values off at all)."""
    d = (got.int() - ref.int()).abs()
    return int((d > 1).sum()), float((d > 0).float().mean())


def k1_phase(torch, fails, seed):
    from ao_tpu_torch.ops.hopper import int4_matmul as k1
    from ao_tpu_torch.quantization.primitives import compute_error
    from ao_tpu_torch.quantization.qarrays.int4 import Int4Array
    from ao_tpu_torch.utils.timing import cuda_time_ms

    rows = {}
    gen = torch.Generator(device=DEV).manual_seed(seed)
    for m, k, n in K1_SHAPES:
        w = (torch.randn((k, n), generator=gen, device=DEV) * k ** -0.5).to(torch.bfloat16)
        qa = Int4Array.from_hp(w, group_size=GROUP)
        del w
        x = torch.randn((m, k), generator=gen, device=DEV).to(torch.bfloat16)
        s, b2 = k1.transport_qparams(qa.scale, qa.zero_point, qa.zero_point_domain)
        got = k1.int4_wo_magic(x, qa.qdata, qa.scale, qa.zero_point, GROUP, qa.zero_point_domain)
        ref = k1.int4_wo_magic_plain(x, qa.qdata, s, b2, GROUP)
        torch.cuda.synchronize()
        sqnr = float(compute_error(ref, got))
        fails.check(bool(torch.isfinite(got).all()) and sqnr >= K1_SQNR_DB,
                    f"K1 int4_wo_magic {(m, k, n)}: sqnr {sqnr:.2f} dB < {K1_SQNR_DB}")
        # the launch as the main path makes it: bf16 tinygemm qparams as they are
        ms = cuda_time_ms(lambda: k1._launch(x, qa.qdata, qa.scale, qa.zero_point, GROUP,
                                             raw_zp=True), iters=20)
        plain_ms = cuda_time_ms(lambda: k1.int4_wo_magic_plain(x, qa.qdata, s, b2, GROUP),
                                iters=3, warmup=1)
        w_dq = qa.dequantize(torch.bfloat16)
        library_ms = cuda_time_ms(lambda: torch.matmul(x, w_dq), iters=10)
        del w_dq
        nbytes, flops = k1.traffic(m, k, n, GROUP)
        rows[(m, k, n)] = kernel_row("K1 int4_wo_magic", f"M={m} K={k} N={n}", got, ref,
                                     f"sqnr {sqnr:.2f} dB (>= {K1_SQNR_DB})", ms, plain_ms,
                                     library_ms, nbytes, flops,
                                     tiles=magic_tiles(torch, m, k, n, GROUP, "K1"))
        del qa, x, s, b2, got, ref
        torch.cuda.empty_cache()
    return rows


def sdpa_ms(torch, q, kc, vc, lengths, sm):
    """The library yardstick of the decode attention kernels: one SDPA call
    with GQA over bf16 (B, T, Hkv, D) caches (heads-major views) and the
    length mask."""
    import torch.nn.functional as F

    from ao_tpu_torch.utils.timing import cuda_time_ms

    qs = q[:, :, None, :]
    ks, vs = kc.transpose(1, 2), vc.transpose(1, 2)
    t = kc.shape[1]
    mask = (torch.arange(t, device=DEV)[None, :] < lengths[:, None])[:, None, None, :]
    return cuda_time_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, scale=sm, enable_gqa=True), iters=50)


def k2_phase(torch, fails, seed, t=None, lengths=None):
    """K2 at the path's shape, or at ``t`` with ``lengths``."""
    from ao_tpu_torch.ops.hopper import decode_attention as k2
    from ao_tpu_torch.quantization.primitives import compute_error
    from ao_tpu_torch.utils.timing import cuda_time_ms

    b, h, hkv, d = (K2_SHAPE[key] for key in ("b", "h", "hkv", "d"))
    t, lengths = t or K2_SHAPE["t"], lengths or K2_LENGTHS
    gen = torch.Generator(device=DEV).manual_seed(seed + 1)
    q = torch.randn((b, h, d), generator=gen, device=DEV).to(torch.bfloat16)
    kc = torch.randn((b, t, hkv, d), generator=gen, device=DEV).to(torch.bfloat16)
    vc = torch.randn((b, t, hkv, d), generator=gen, device=DEV).to(torch.bfloat16)
    lens = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    sm = d ** -0.5
    got = k2.decode_attention(q, kc, vc, lens, sm_scale=sm)
    ref = k2.decode_attention_plain(q, kc, vc, lens, sm)
    torch.cuda.synchronize()
    sqnr = float(compute_error(ref, got))
    fails.check(bool(torch.isfinite(got).all()) and sqnr >= K2_SQNR_DB,
                f"K2 decode_attention T={t}: sqnr {sqnr:.2f} dB < {K2_SQNR_DB}")
    launch = lambda: k2._launch(q, kc, vc, lens, sm)  # noqa: E731
    ms = cuda_time_ms(launch, iters=50)
    plain_ms = cuda_time_ms(lambda: k2.decode_attention_plain(q, kc, vc, lens, sm), iters=10)
    nbytes, flops = k2.traffic((b, h, d), (b, t, hkv, d), lengths)
    plan = getattr(k2, "launch_plan", None)  # None in a checkout that predates it
    desc = one_launch(torch, fails, f"K2 decode_attention T={t}", launch,
                      plan and plan((b, h, d), (b, t, hkv, d)))
    return kernel_row("K2 decode_attention", f"B={b} H={h} Hkv={hkv} D={d} T={t}", got, ref,
                      f"sqnr {sqnr:.2f} dB (>= {K2_SQNR_DB})", ms, plain_ms,
                      sdpa_ms(torch, q, kc, vc, lens, sm), nbytes, flops, tiles=desc)


def one_launch(torch, fails, what, launch, plan):
    """The device kernels one call of a decode attention kernel runs, with
    its plan (None for a kernel that has none): the decode mainloop's K2
    and K9 must run one."""
    n = device_kernels(torch, launch)
    if plan is None:
        return f"{n} device kernel(s) a call"
    fails.check(n == 1, f"{what}: {n} device kernels a call, not 1")
    return (f"{n} device kernel(s) a call, plan (splits, rows, stages, tiles) "
            f"{tuple(plan)}")


def k2_rows(torch, fails, seed):
    """K2's rows at generate's T (ragged lengths), the slot engine's decode
    shape and T_LONG (every position valid)."""
    return {"generate": k2_phase(torch, fails, seed),
            "engine-slots": k2_phase(torch, fails, seed, t=ENGINE_CFG["max_seq"],
                                     lengths=ENGINE_LENGTHS),
            "long": k2_phase(torch, fails, seed, t=T_LONG, lengths=[T_LONG] * K2_SHAPE["b"])}


def k2v_rows(torch, fails, seed):
    """K2v's rows over its e5m2 cache (generate's e5m2-KV path) and its int8
    one (no main path) at generate's T (ragged lengths) and at T_LONG (every
    position valid), each with its plan and the device kernels a call."""
    long = [T_LONG] * K2_SHAPE["b"]
    return {(kv, t): kv_phase(torch, fails, seed, kv, t=t, lengths=lengths,
                              kernel=K2V_INT8 if kv == "int8" else None)
            for kv in ("float8_e5m2", "int8")
            for t, lengths in ((K2_SHAPE["t"], K2_LENGTHS), (T_LONG, long))}


def kv_phase(torch, fails, seed, dtype_name, t=None, lengths=None, kernel=None):
    """K5, K6, K7 or K2v (``kernel``, by default the cache's on the main
    path) at the path's shape (or at ``t`` with ``lengths``) over caches
    written by ``QuantKVCache.update`` from random bf16 K and V; the library
    yardstick runs SDPA over the same caches dequantized to bf16."""
    from ao_tpu_torch.ops.hopper import decode_attention as da
    from ao_tpu_torch.quantization.primitives import compute_error
    from ao_tpu_torch.serving.kvcache import QuantKVCache
    from ao_tpu_torch.utils.timing import cuda_time_ms

    name, kind, knum = kernel or KV_KERNELS[dtype_name]
    wrapper = getattr(da, name)
    b, h, hkv, d = (K2_SHAPE[key] for key in ("b", "h", "hkv", "d"))
    t, lengths = t or K2_SHAPE["t"], lengths or K2_LENGTHS
    gen = torch.Generator(device=DEV).manual_seed(seed + 6)
    q = torch.randn((b, h, d), generator=gen, device=DEV).to(torch.bfloat16)
    ck, cv = (QuantKVCache.create(b, t, hkv, d, dtype_name, device=DEV).update(
        torch.randn((b, t, hkv, d), generator=gen, device=DEV).to(torch.bfloat16), 0)
        for _ in range(2))
    args = (q, ck.qdata, ck.scale, cv.qdata, cv.scale,
            torch.tensor(lengths, dtype=torch.int32, device=DEV))
    sm = d ** -0.5
    got = wrapper(*args, sm_scale=sm)
    ref = da.decode_attention_quant_plain(kind, *args, sm)
    torch.cuda.synchronize()
    sqnr = float(compute_error(ref, got))
    fails.check(bool(torch.isfinite(got).all()) and sqnr >= K2_SQNR_DB,
                f"{knum} {name} T={t}: sqnr {sqnr:.2f} dB < {K2_SQNR_DB}")
    launch = lambda: da._launch_quant(kind, *args, sm)  # noqa: E731
    ms = cuda_time_ms(launch, iters=50)
    plain_ms = cuda_time_ms(lambda: da.decode_attention_quant_plain(kind, *args, sm), iters=10)
    library_ms = sdpa_ms(torch, q, ck.dequantize(torch.bfloat16), cv.dequantize(torch.bfloat16),
                         args[-1], sm)
    nbytes, ops = da.traffic_quant(kind, (b, h, d), tuple(ck.qdata.shape), lengths)
    # K2v runs on the decode mainloop: its plan, and one device kernel
    plan = getattr(da, "launch_plan_vec8", None)  # None in a checkout that predates it
    desc = None if kind != "v8" else one_launch(
        torch, fails, f"{knum} {name} T={t}", launch,
        plan and plan((b, h, d), tuple(ck.qdata.shape)))
    return kernel_row(f"{knum} {name}", f"B={b} H={h} Hkv={hkv} D={d} T={t} {dtype_name} cache",
                      got, ref, f"sqnr {sqnr:.2f} dB (>= {K2_SQNR_DB})", ms, plain_ms, library_ms,
                      nbytes, ops, tiles=desc)


def w4a8_weight(torch, gen, k, n):
    from ao_tpu_torch.quantization.configs import Int8DynamicActivationInt4WeightConfig
    from ao_tpu_torch.quantization.quantize import quantize_

    w = (torch.randn((k, n), generator=gen, device=DEV) * k ** -0.5).to(torch.bfloat16)
    return quantize_({"w1": w}, Int8DynamicActivationInt4WeightConfig(group_size=GROUP))["w1"]


def k3_phase(torch, fails, seed):
    """K3 at the decode shapes (M = B): the activation quantized per token as
    the linear does it, the weight's bf16 tinygemm qparams as they are."""
    from ao_tpu_torch.ops.act_quant import quantize_activation
    from ao_tpu_torch.ops.hopper import int4_matmul as k34
    from ao_tpu_torch.quantization.primitives import compute_error
    from ao_tpu_torch.utils.timing import cuda_time_ms

    rows = {}
    gen = torch.Generator(device=DEV).manual_seed(seed + 3)
    for k, n in W4A8_KN:
        qa = w4a8_weight(torch, gen, k, n)
        x = torch.randn((BATCH, k), generator=gen, device=DEV).to(torch.bfloat16)
        xq, sx, _ = quantize_activation(x, qa.act_quant)
        got = k34.int4_w4a8_matmul(xq, sx, qa.qdata, qa.scale, qa.zero_point, GROUP,
                                   qa.zero_point_domain)
        s, b = k34.w4a8_qparams(qa.scale, qa.zero_point, qa.zero_point_domain)
        ref = k34.int4_w4a8_matmul_plain(xq, sx, qa.qdata, s, b, GROUP)
        torch.cuda.synchronize()
        sqnr = float(compute_error(ref, got))
        fails.check(bool(torch.isfinite(got).all()) and sqnr >= K3_SQNR_DB,
                    f"K3 int4_w4a8_matmul {(BATCH, k, n)}: sqnr {sqnr:.2f} dB < {K3_SQNR_DB}")
        launch = lambda: k34._launch_w4a8(xq, sx, qa.qdata, qa.scale, qa.zero_point,  # noqa: E731
                                          GROUP)
        ms = cuda_time_ms(launch, iters=20)
        plain_ms = cuda_time_ms(lambda: k34.int4_w4a8_matmul_plain(xq, sx, qa.qdata, s, b, GROUP),
                                iters=3, warmup=1)
        w_dq = qa.dequantize(torch.bfloat16)
        library_ms = cuda_time_ms(lambda: torch.matmul(x, w_dq), iters=10)
        del w_dq
        nbytes, ops = k34.traffic_w4a8(BATCH, k, n, GROUP)
        plan = getattr(k34, "w4a8_plan", None)  # None in a checkout that predates it
        dev = torch.device(DEV, torch.cuda.current_device())
        desc = (f"{device_kernels(torch, launch)} device kernel(s) a call" + (
            "" if plan is None else ", (warps along K, splits, pairs a warp) "
            f"{plan(BATCH, k, n, GROUP, k34._sm_count(dev))}"))
        rows[(k, n)] = kernel_row("K3 int4_w4a8_matmul", f"M={BATCH} K={k} N={n}", got, ref,
                                  f"sqnr {sqnr:.2f} dB (>= {K3_SQNR_DB})", ms, plain_ms,
                                  library_ms, nbytes, ops, INT8_OPS_PER_S, tiles=desc)
        del qa, x, xq, sx, s, b, got, ref
        torch.cuda.empty_cache()
    return rows


def device_kernels(torch, fn) -> int:
    """The device kernels one call of ``fn`` runs, after a warm call, as
    torch.profiler counts them, a profile that came back without device
    records taken again, up to three times (seen on the H100,
    ``utils/timing.py``); then ``utils/timing.device_kernels`` counts the
    nodes of a CUDA graph captured from one call (not in a checkout that
    predates it)."""
    from ao_tpu_torch.utils import timing

    if hasattr(timing, "device_kernels"):
        return timing.device_kernels(fn)
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    n = 0
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
        if n:
            break
    return n


def k4_phase(torch, fails, seed):
    """K4 at every (K, N) of the prefill, with the analytic per-channel
    scale the linear computes; equal to its plain version, every difference
    counted."""
    from ao_tpu_torch.ops.hopper import int4_matmul as k34
    from ao_tpu_torch.ops.linear import _requant_scale
    from ao_tpu_torch.utils.timing import cuda_time_ms

    rows = {}
    gen = torch.Generator(device=DEV).manual_seed(seed + 4)
    for k, n in W4A8_KN:
        qa = w4a8_weight(torch, gen, k, n)
        sg, bg, s8 = _requant_scale(qa)
        got = k34.int4_magic8_requant_int8(qa.qdata, sg, bg, s8, GROUP)
        a, b = k34.requant_rows(sg, bg, s8)
        ref = k34.int4_magic8_requant_int8_plain(qa.qdata, a, b, GROUP)
        torch.cuda.synchronize()
        over, frac = lsb_check(got, ref)
        fails.check(over == 0 and frac < LSB_FRACTION,
                    f"K4 int4_magic8_requant_int8 {(k, n)}: {over} values > 1 LSB off, "
                    f"{frac:.4%} off")
        ms = cuda_time_ms(lambda: k34._launch_requant(qa.qdata, a, b, GROUP), iters=20)
        plain_ms = cuda_time_ms(lambda: k34.int4_magic8_requant_int8_plain(qa.qdata, a, b, GROUP),
                                iters=3, warmup=1)
        nbytes, ops = k34.traffic_requant(k, n, GROUP)
        rows[(k, n)] = kernel_row(
            "K4 int4_magic8_requant_int8", f"K={k} N={n}", got, ref,
            f"{frac:.6%} of values differ from the plain version ({over} by more than 1 LSB)",
            ms, plain_ms, None, nbytes, ops, F32_FLOPS_PER_S)
        del qa, sg, bg, s8, a, b, got, ref
        torch.cuda.empty_cache()
    return rows


def k12_phase(torch, fails, seed):
    """K12 at the prefill SwiGLU gate: bf16 gate and up projections."""
    from ao_tpu_torch.ops.hopper import fused_act as k12
    from ao_tpu_torch.utils.timing import cuda_time_ms

    gen = torch.Generator(device=DEV).manual_seed(seed + 5)
    a = torch.randn(K12_SHAPE, generator=gen, device=DEV).to(torch.bfloat16)
    b = torch.randn(K12_SHAPE, generator=gen, device=DEV).to(torch.bfloat16)
    q, sc = k12.silu_mul_quant(a, b)
    qr, sr = k12.silu_mul_quant_plain(a, b)
    torch.cuda.synchronize()
    over, frac = lsb_check(q, qr)
    rel = float(((sc - sr).abs() / sr).max())
    fails.check(over == 0 and frac < LSB_FRACTION and rel <= K12_SCALE_RTOL,
                f"K12 silu_mul_quant {K12_SHAPE}: {over} values > 1 LSB off, {frac:.4%} off, "
                f"scales within rtol {rel:.3g}")
    ms = cuda_time_ms(lambda: k12._launch(a, b, "silu"), iters=20)
    plain_ms = cuda_time_ms(lambda: k12.silu_mul_quant_plain(a, b), iters=5)
    nbytes, ops = k12.traffic(K12_SHAPE)
    return kernel_row("K12s silu_mul_quant", "B={} T={} D={}".format(*K12_SHAPE), q, qr,
                      f"q: {frac:.6%} of values 1 LSB off ({over} more); scales rtol {rel:.3g}",
                      ms, plain_ms, None, nbytes, ops, F32_FLOPS_PER_S)


def k10_phase(torch, fails, seed):
    """K10 at every (M, K, N) of the int8-WO path: a random bf16 weight
    quantized per output column, as Int8WeightOnlyConfig does."""
    from ao_tpu_torch.ops.hopper import int8_matmul as k10
    from ao_tpu_torch.quantization.primitives import compute_error
    from ao_tpu_torch.quantization.qarrays.int8 import Int8Array
    from ao_tpu_torch.utils.timing import cuda_time_ms

    rows = {}
    gen = torch.Generator(device=DEV).manual_seed(seed + 12)
    for m, k, n in WEIGHT_SHAPES:
        w = (torch.randn((k, n), generator=gen, device=DEV) * k ** -0.5).to(torch.bfloat16)
        qa = Int8Array.from_hp(w, (k, 1))
        del w
        x = torch.randn((m, k), generator=gen, device=DEV).to(torch.bfloat16)
        got = k10.int8_wo_matmul(x, qa.qdata, qa.scale)
        ref = k10.int8_wo_matmul_plain(x, qa.qdata, qa.scale)
        torch.cuda.synchronize()
        sqnr = float(compute_error(ref, got))
        fails.check(bool(torch.isfinite(got).all()) and sqnr >= K10_SQNR_DB,
                    f"K10 int8_wo_matmul {(m, k, n)}: sqnr {sqnr:.2f} dB < {K10_SQNR_DB}")
        ms = cuda_time_ms(lambda: k10._launch(x, qa.qdata, qa.scale), iters=20)
        plain_ms = cuda_time_ms(lambda: k10.int8_wo_matmul_plain(x, qa.qdata, qa.scale),
                                iters=3, warmup=1)
        w_dq = qa.dequantize(torch.bfloat16)
        library_ms = cuda_time_ms(lambda: torch.matmul(x, w_dq), iters=10)
        del w_dq
        nbytes, flops = k10.traffic(m, k, n)
        rows[(m, k, n)] = kernel_row("K10 int8_wo_matmul", f"M={m} K={k} N={n}", got, ref,
                                     f"sqnr {sqnr:.2f} dB (>= {K10_SQNR_DB})", ms, plain_ms,
                                     library_ms, nbytes, flops,
                                     tiles=launch_desc(torch, k10, m, k, n, "stages of 64 K"))
        del qa, x, got, ref
        torch.cuda.empty_cache()
    return rows


def scaled_mm_blockwise(torch, qx, sx, qw, sw, ref):
    """The library yardstick of K17: (callable, what it is). One
    ``torch._scaled_mm`` with 1 x 128 and 128 x 128 f32 block scales where
    the installed PyTorch takes them (scales as given, or K-block-major) and
    its result agrees with the plain version at the kernel's bound; else
    bf16 ``torch.matmul`` on the dequantized operands."""
    from ao_tpu_torch.quantization.primitives import compute_error

    for a, b, how in ((sx, sw, "scales row-major"),
                      (sx.t().contiguous().t(), sw.t().contiguous().t(), "scales K-block-major")):
        try:
            y = torch._scaled_mm(qx, qw, scale_a=a, scale_b=b, out_dtype=torch.bfloat16)
            torch.cuda.synchronize()
        except (RuntimeError, ValueError, TypeError) as e:
            print(f"  torch._scaled_mm blockwise ({how}) refused: {str(e).splitlines()[0][:160]}",
                  flush=True)
            continue
        sqnr = float(compute_error(ref, y))
        if sqnr > K17_SQNR_DB:
            return (lambda: torch._scaled_mm(qx, qw, scale_a=a, scale_b=b,
                                             out_dtype=torch.bfloat16),
                    f"torch._scaled_mm blockwise ({how}; {sqnr:.1f} dB vs the plain version)")
        print(f"  torch._scaled_mm blockwise ({how}) disagrees: {sqnr:.2f} dB", flush=True)
    x_dq = (qx.to(torch.float32) * sx.repeat_interleave(128, dim=1)).to(torch.bfloat16)
    w_dq = (qw.to(torch.float32) * sw.repeat_interleave(128, dim=0).repeat_interleave(
        128, dim=1)).to(torch.bfloat16)
    return (lambda: torch.matmul(x_dq, w_dq),
            "bf16 torch.matmul on the dequantized operands")


def k17_phase(torch, fails, seed):
    """K17 at every (M, K, N) of the fp8-block path: a random bf16 weight in
    128 x 128 blocks and an activation quantized per 1 x 128 block, as
    Float8DynamicActivationFloat8WeightConfig(PerBlock((128, 128))) does."""
    from ao_tpu_torch.ops.act_quant import quantize_activation
    from ao_tpu_torch.ops.hopper import fp8_matmul as k17
    from ao_tpu_torch.quantization.primitives import compute_error
    from ao_tpu_torch.quantization.qarrays.common import ActQuantSpec
    from ao_tpu_torch.quantization.qarrays.float8 import Float8Array
    from ao_tpu_torch.utils.timing import cuda_time_ms

    rows = {}
    spec = ActQuantSpec(dtype="float8_e4m3fn", granularity="per_group:128")
    gen = torch.Generator(device=DEV).manual_seed(seed + 13)
    for m, k, n in WEIGHT_SHAPES:
        w = (torch.randn((k, n), generator=gen, device=DEV) * k ** -0.5).to(torch.bfloat16)
        qa = Float8Array.from_hp(w, (128, 128))
        del w
        x = torch.randn((m, k), generator=gen, device=DEV).to(torch.bfloat16)
        qx, sx, _ = quantize_activation(x, spec)
        got = k17.fp8_blockwise_matmul(qx, sx, qa.qdata, qa.scale)
        ref = k17.fp8_blockwise_matmul_plain(qx, sx, qa.qdata, qa.scale)
        torch.cuda.synchronize()
        sqnr = float(compute_error(ref, got))
        fails.check(bool(torch.isfinite(got).all()) and sqnr > K17_SQNR_DB,
                    f"K17 fp8_blockwise_matmul {(m, k, n)}: sqnr {sqnr:.2f} dB <= {K17_SQNR_DB}")
        ms = cuda_time_ms(lambda: k17._launch(qx, sx, qa.qdata, qa.scale), iters=20)
        plain_ms = cuda_time_ms(lambda: k17.fp8_blockwise_matmul_plain(qx, sx, qa.qdata,
                                                                       qa.scale),
                                iters=2, warmup=1)
        lib_fn, lib_what = scaled_mm_blockwise(torch, qx, sx, qa.qdata, qa.scale, ref)
        library_ms = cuda_time_ms(lib_fn, iters=10)
        print(f"  K17 {(m, k, n)} library yardstick: {lib_what}", flush=True)
        row_ms, row_what = scaled_mm_rowwise(torch, qx, qa.qdata)
        note = row_what if row_ms is None else f"{row_what}: {row_ms:.4f} ms"
        print(f"  K17 {(m, k, n)} beside it, not the same function: {note}", flush=True)
        nbytes, flops = k17.traffic(m, k, n)
        rows[(m, k, n)] = kernel_row("K17 fp8_blockwise_matmul", f"M={m} K={k} N={n}", got, ref,
                                     f"sqnr {sqnr:.2f} dB (> {K17_SQNR_DB})", ms, plain_ms,
                                     library_ms, nbytes, flops, FP8_FLOPS_PER_S,
                                     tiles=launch_desc(torch, k17, m, k, n, "k-blocks"))
        rows[(m, k, n)]["scaled_mm_rowwise_ms"] = row_ms
        del qa, x, qx, sx, got, ref, lib_fn
        torch.cuda.empty_cache()
    return rows


def k14_phase(torch, fails, seed, kind):
    """K14 at every (M, K, N) of the MXFP4 ("mx") or NVFP4 ("nv") path: a
    random bf16 weight quantized as MXWeightOnlyConfig(float4_e2m1fn) or
    NVFP4WeightOnlyConfig do; the library yardstick is bf16 torch.matmul on
    the dequantized weight."""
    from ao_tpu_torch.ops.hopper import fp4_matmul as k14
    from ao_tpu_torch.quantization.primitives import compute_error
    from ao_tpu_torch.quantization.qarrays.mx import MXArray
    from ao_tpu_torch.quantization.qarrays.nvfp4 import NVFP4Array
    from ao_tpu_torch.utils.timing import cuda_time_ms

    rows = {}
    name = "mxfp4_wo_matmul" if kind == "mx" else "nvfp4_wo_matmul"
    need = K14_SQNR_DB[kind]
    gen = torch.Generator(device=DEV).manual_seed(seed + (15 if kind == "mx" else 16))
    for m, k, n in WEIGHT_SHAPES:
        w = (torch.randn((k, n), generator=gen, device=DEV) * k ** -0.5).to(torch.bfloat16)
        qa = (MXArray.from_hp(w, elem_dtype="float4_e2m1fn") if kind == "mx"
              else NVFP4Array.from_hp(w))
        del w
        x = torch.randn((m, k), generator=gen, device=DEV).to(torch.bfloat16)
        if kind == "mx":
            args = (qa.qdata, qa.scale)
            launch = (k14.MX, x, qa.qdata, qa.scale, None, name)
            got = k14.mxfp4_wo_matmul(x, *args)
            plain = lambda: k14.mxfp4_wo_matmul_plain(x, *args)  # noqa: E731
        else:
            args = (qa.qdata, qa.scale, qa.per_tensor_scale)
            launch = (k14.NV, x, qa.qdata, qa.scale, qa.per_tensor_scale, name)
            got = k14.nvfp4_wo_matmul(x, *args)
            plain = lambda: k14.nvfp4_wo_matmul_plain(x, *args)  # noqa: E731
        ref = plain()
        torch.cuda.synchronize()
        sqnr = float(compute_error(ref, got))
        fails.check(bool(torch.isfinite(got).all()) and sqnr > need,
                    f"K14 {name} {(m, k, n)}: sqnr {sqnr:.2f} dB <= {need}")
        ms = cuda_time_ms(lambda: k14._launch(*launch), iters=20)
        plain_ms = cuda_time_ms(plain, iters=2, warmup=1)
        w_dq = qa.dequantize(torch.bfloat16)
        library_ms = cuda_time_ms(lambda: torch.matmul(x, w_dq), iters=10)
        del w_dq
        nbytes, flops = k14.traffic(m, k, n, k14.MX if kind == "mx" else k14.NV)
        rows[(m, k, n)] = kernel_row(f"K14 {name}", f"M={m} K={k} N={n}", got, ref,
                                     f"sqnr {sqnr:.2f} dB (> {need})", ms, plain_ms,
                                     library_ms, nbytes, flops)
        del qa, x, got, ref, args, launch
        torch.cuda.empty_cache()
    return rows


def k15_phase(torch, fails, seed):
    """K15 at every (M, K, N) of the NF4 path: a random bf16 weight quantized
    as NF4WeightOnlyConfig does (block 64, scaler block 256), its scalers
    dequantized from int8 as the linear does, the NF4 codebook shared; the
    library yardstick is bf16 torch.matmul on the dequantized weight."""
    from ao_tpu_torch.ops.hopper import lut4_matmul as k15
    from ao_tpu_torch.quantization.primitives import compute_error
    from ao_tpu_torch.quantization.qarrays.nf4 import NF4_CODEBOOK, NF4Array
    from ao_tpu_torch.utils.timing import cuda_time_ms

    rows = {}
    lut = NF4_CODEBOOK.to(DEV).to(torch.bfloat16)
    gen = torch.Generator(device=DEV).manual_seed(seed + 17)
    for m, k, n in WEIGHT_SHAPES:
        w = (torch.randn((k, n), generator=gen, device=DEV) * k ** -0.5).to(torch.bfloat16)
        qa = NF4Array.from_hp(w, NF4_GROUP)
        del w
        x = torch.randn((m, k), generator=gen, device=DEV).to(torch.bfloat16)
        sc = qa._scalers()
        got = k15.lut4_wo_magic(x, qa.qdata, sc, lut, NF4_GROUP)
        ref = k15.lut4_wo_magic_plain(x, qa.qdata, sc, lut, NF4_GROUP)
        torch.cuda.synchronize()
        sqnr = float(compute_error(ref, got))
        fails.check(bool(torch.isfinite(got).all()) and sqnr > K15_SQNR_DB,
                    f"K15 lut4_wo_magic {(m, k, n)}: sqnr {sqnr:.2f} dB <= {K15_SQNR_DB}")
        ms = cuda_time_ms(lambda: k15._launch(x, qa.qdata, sc, lut, NF4_GROUP), iters=20)
        plain_ms = cuda_time_ms(lambda: k15.lut4_wo_magic_plain(x, qa.qdata, sc, lut, NF4_GROUP),
                                iters=2, warmup=1)
        w_dq = qa.dequantize(torch.bfloat16)
        library_ms = cuda_time_ms(lambda: torch.matmul(x, w_dq), iters=10)
        del w_dq
        nbytes, flops = k15.traffic(m, k, n, NF4_GROUP)
        rows[(m, k, n)] = kernel_row("K15 lut4_wo_magic", f"M={m} K={k} N={n}", got, ref,
                                     f"sqnr {sqnr:.2f} dB (> {K15_SQNR_DB})", ms, plain_ms,
                                     library_ms, nbytes, flops,
                                     tiles=magic_tiles(torch, m, k, n, NF4_GROUP, "K15"))
        del qa, x, sc, got, ref
        torch.cuda.empty_cache()
    return rows


def k11_phase(torch, fails, seed):
    """K11 at ViT-B's (M, K, N): a random bf16 weight quantized as
    Int4WeightOnlyConfig(group_size=128) does, which at K = 768 (6 groups)
    packs the split-half layout; the library yardstick is bf16 torch.matmul
    on the dequantized weight."""
    from ao_tpu_torch.ops.hopper import int4_matmul as k1
    from ao_tpu_torch.quantization.primitives import compute_error
    from ao_tpu_torch.quantization.qarrays.int4 import Int4Array
    from ao_tpu_torch.utils.timing import cuda_time_ms

    rows = {}
    gen = torch.Generator(device=DEV).manual_seed(seed + 21)
    for m, k, n in K11_SHAPES:
        w = (torch.randn((k, n), generator=gen, device=DEV) * k ** -0.5).to(torch.bfloat16)
        qa = Int4Array.from_hp(w, group_size=GROUP)
        fails.check(qa.layout == "halves", f"K11 {(k, n)}: layout {qa.layout}, not split-half")
        x = torch.randn((m, k), generator=gen, device=DEV).to(torch.bfloat16)
        s, b = k1.affine_qparams(qa.scale, qa.zero_point, qa.zero_point_domain)
        got = k1.int4_wo_matmul(x, qa.qdata, qa.scale, qa.zero_point, GROUP, qa.zero_point_domain)
        ref = k1.int4_wo_matmul_plain(x, qa.qdata, s, b, GROUP)
        torch.cuda.synchronize()
        sqnr = float(compute_error(ref, got))
        fails.check(bool(torch.isfinite(got).all()) and sqnr >= K11_SQNR_DB,
                    f"K11 int4_wo_matmul {(m, k, n)}: sqnr {sqnr:.2f} dB < {K11_SQNR_DB}")
        # the launch as the main path makes it: bf16 tinygemm qparams as they are
        ms = cuda_time_ms(lambda: k1._launch_halves(x, qa.qdata, qa.scale, qa.zero_point, GROUP,
                                                    raw=True), iters=20)
        plain_ms = cuda_time_ms(lambda: k1.int4_wo_matmul_plain(x, qa.qdata, s, b, GROUP),
                                iters=5, warmup=1)
        w_dq = qa.dequantize(torch.bfloat16)
        library_ms = cuda_time_ms(lambda: torch.matmul(x, w_dq), iters=20)
        nbytes, flops = k1.traffic_halves(m, k, n, GROUP)
        rows[(m, k, n)] = kernel_row("K11 int4_wo_matmul", f"M={m} K={k} N={n}", got, ref,
                                     f"sqnr {sqnr:.2f} dB (>= {K11_SQNR_DB})", ms, plain_ms,
                                     library_ms, nbytes, flops)
    return rows


def k12v_phase(torch, fails, seed, kind, shape):
    """K12n ("norm") or K12g ("gelu") at SAM-B's rows: bf16 inputs; K12n's
    modulation is SAM's LayerNorm affine, one row (smod = scale - 1, shift =
    bias) broadcast over the windows. Codes at most 1 LSB off on under 1 %;
    no single library call computes either function."""
    from ao_tpu_torch.ops.hopper import fused_act as k12
    from ao_tpu_torch.utils.timing import cuda_time_ms

    b, t, d = shape
    gen = torch.Generator(device=DEV).manual_seed(seed + 22 + t)
    x = (torch.randn(shape, generator=gen, device=DEV) * 2 + 0.5).to(torch.bfloat16)
    if kind == "norm":
        shift = (torch.randn((1, d), generator=gen, device=DEV) * 0.1).to(torch.bfloat16)
        smod = (torch.randn((1, d), generator=gen, device=DEV) * 0.1).to(torch.bfloat16)
        args = (x, shift.expand(b, d), smod.expand(b, d), 1e-6)
        name, wrapper, plain, launch = ("K12n norm_modulate_quant", k12.norm_modulate_quant,
                                        k12.norm_modulate_quant_plain, k12._launch_norm)
        nbytes, ops = k12.traffic_norm(shape, 1)
        rtol = K12N_SCALE_RTOL
    else:
        args = (x,)
        name, wrapper, plain, launch = ("K12g gelu_quant", k12.gelu_quant, k12.gelu_quant_plain,
                                        k12._launch_gelu)
        nbytes, ops = k12.traffic_gelu(shape)
        rtol = K12_SCALE_RTOL
    q, sc = wrapper(*args)
    qr, sr = plain(*args)
    torch.cuda.synchronize()
    over, frac = lsb_check(q, qr)
    rel = float(((sc - sr).abs() / sr).max())
    fails.check(over == 0 and frac < LSB_FRACTION and rel <= rtol,
                f"{name} {shape}: {over} values > 1 LSB off, {frac:.4%} off, scales within "
                f"rtol {rel:.3g} (<= {rtol})")
    ms = cuda_time_ms(lambda: launch(*args), iters=20)
    plain_ms = cuda_time_ms(lambda: plain(*args), iters=5, warmup=1)
    return kernel_row(name, "B={} T={} D={}".format(*shape), q, qr,
                      f"q: {frac:.6%} of values 1 LSB off ({over} more); scales rtol {rel:.3g}",
                      ms, plain_ms, None, nbytes, ops, F32_FLOPS_PER_S)


def k16_phase(torch, fails, seed, g, side):
    """K16 at SAM-B's windowed (G = 100, side 14) or global (G = 4, side 64)
    attention: 12 heads of 64, bf16 q, k, v and rel terms about REL_POS_SCALE
    large (a kernel that dropped them would fail). The library yardstick is
    segment-anything-fast's form: SDPA with the bias materialized as a bf16
    float attn_mask (G, nh, T, T), built outside the timing."""
    import torch.nn.functional as F

    from ao_tpu_torch.ops.hopper import window_attention as k16
    from ao_tpu_torch.quantization.primitives import compute_error
    from ao_tpu_torch.utils.timing import cuda_time_ms

    nh, hd, t = 12, 64, side * side
    gen = torch.Generator(device=DEV).manual_seed(seed + 23 + side)
    q, k, v = (torch.randn((g, t, nh, hd), generator=gen, device=DEV).to(torch.bfloat16)
               for _ in range(3))
    rh, rw = ((torch.randn((g, nh, t, side), generator=gen, device=DEV) * REL_POS_SCALE)
              .to(torch.bfloat16) for _ in range(2))
    sm = hd ** -0.5
    got = k16.window_bias_attention(q, k, v, rh, rw, side=side, scale=sm)
    ref = k16.window_bias_attention_plain(q, k, v, rh, rw, side, sm)
    torch.cuda.synchronize()
    sqnr = float(compute_error(ref.float(), got.float()))
    nobias = float(compute_error(k16.window_bias_attention_plain(q, k, v, 0 * rh, 0 * rw, side,
                                                                 sm).float(), got.float()))
    fails.check(bool(torch.isfinite(got).all()) and sqnr >= K16_SQNR_DB and nobias < 30,
                f"K16 window_bias_attention G={g} side={side}: sqnr {sqnr:.2f} dB "
                f"(>= {K16_SQNR_DB}); without the bias {nobias:.2f} dB (< 30)")
    ms = cuda_time_ms(lambda: k16._launch(q, k, v, rh, rw, side, sm), iters=10)
    plain_ms = cuda_time_ms(lambda: k16.window_bias_attention_plain(q, k, v, rh, rw, side, sm),
                            iters=2, warmup=1)
    cols = torch.arange(t, device=DEV)
    bias = (rh.float()[..., cols // side] + rw.float()[..., cols % side]).to(torch.bfloat16)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias, scale=sm)
    lib_db = float(compute_error(ref.float(), lib.transpose(1, 2).reshape(g, t, nh * hd).float()))
    print(f"K16 G={g} side={side}: SDPA with the bias as a float mask against the plain version: "
          f"{lib_db:.2f} dB", flush=True)
    library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias,
                                                                     scale=sm), iters=10)
    del bias, lib
    nbytes, flops = k16.traffic(g, t, nh, hd, side)
    tiles = None
    if hasattr(k16, "BLOCK_Q"):  # a checkout whose wrapper predates it has no plan
        from ao_tpu_torch.ops.hopper import flash_attention as k8

        plan = k8.launch_plan(tuple(q.shape), tuple(q.shape), False, k16.BLOCK_Q)
        tiles = f"block_q {plan.block_q}, {len(plan.ctas)} CTAs, key tiles {plan.ctas[0][3]}"
    row = kernel_row("K16 window_bias_attention", f"G={g} T={t} side={side} nh={nh} hd={hd}",
                     got, ref, f"sqnr {sqnr:.2f} dB (>= {K16_SQNR_DB}); without the bias "
                     f"{nobias:.2f} dB", ms, plain_ms, library_ms, nbytes, flops, tiles=tiles)
    torch.cuda.empty_cache()
    return row


def k13_phase(torch, fails, seed, n_experts=8):
    """K13 against its plain version at each (form, T, K, N) of K13_SHAPES,
    over a seeded top-2 routing of random tokens through the MoE layer's
    ``dispatch``, and (a check only, at the first shape) every row on one
    expert with the others empty. Times the kernel as the main path launches
    it (bf16 tinygemm qparams as they are), the plain version, and one
    ``torch._grouped_mm`` over the dequantized bf16 stack with the same
    offsets; the bound counts the experts that own a row. The row of each
    shape is the top-2 routing's."""
    from ao_tpu_torch.moe.layer import dispatch
    from ao_tpu_torch.ops.act_quant import quantize_activation
    from ao_tpu_torch.ops.hopper import grouped_matmul as k13
    from ao_tpu_torch.ops.hopper import int4_matmul as k1
    from ao_tpu_torch.quantization.primitives import compute_error
    from ao_tpu_torch.quantization.qarrays.common import ActQuantSpec
    from ao_tpu_torch.quantization.qarrays.int4 import Int4Array
    from ao_tpu_torch.utils.timing import cuda_time_ms

    spec = ActQuantSpec(dtype="int8", granularity="per_token", symmetric=True)
    rows = {}
    gen = torch.Generator(device=DEV).manual_seed(seed + 13)
    shapes = list(dict.fromkeys((t, k, n) for _, t, k, n, _ in K13_SHAPES))
    for i, (t, k, n) in enumerate(shapes):
        forms = {form: path for form, *shape, path in K13_SHAPES if tuple(shape) == (t, k, n)}
        w = torch.randn((n_experts, k, n), generator=gen, device=DEV,
                        dtype=torch.bfloat16) * k ** -0.5
        stacks = {form: Int4Array.from_hp(w, group_size=GROUP,
                                          **({"act_quant": spec} if form == "w4a8" else {}))
                  for form in forms}
        tokens = torch.randn((t // 2, k), generator=gen, device=DEV).to(torch.bfloat16)
        logits = torch.randn((t // 2, n_experts), generator=gen, device=DEV)
        x, _, gs = dispatch(tokens, torch.topk(logits, 2, dim=-1).indices, n_experts)
        one = torch.zeros(n_experts, dtype=torch.int32, device=DEV)
        one[n_experts // 2] = t
        routings = [("top-2", gs)] + ([("one expert", one)] if i == 0 else [])
        active = int((gs > 0).sum())
        xq, sx, _ = quantize_activation(x, spec)
        sx = sx.reshape(-1, 1).to(torch.float32)
        del w
        w_dq = stacks["magic"].dequantize(torch.bfloat16)  # every shape has the magic form
        offs = torch.cumsum(gs, 0, dtype=torch.int32)
        library_ms = cuda_time_ms(lambda: torch._grouped_mm(x, w_dq, offs=offs), iters=10)
        del w_dq
        for form, qa in stacks.items():
            if form == "magic":
                s, b = k1.transport_qparams(qa.scale, qa.zero_point, qa.zero_point_domain)
                run = lambda g: k13.int4_grouped_magic(  # noqa: E731
                    x, qa.qdata, qa.scale, qa.zero_point, g, GROUP, qa.zero_point_domain)
                plain = lambda g: k13.int4_grouped_magic_plain(  # noqa: E731
                    x, qa.qdata, s, b, g, GROUP)
                launch = lambda: k13._launch_magic(  # noqa: E731
                    x, qa.qdata, qa.scale, qa.zero_point, gs, GROUP, raw_zp=True)
            else:
                s, b = qa.scale, qa.zero_point  # bf16 tinygemm: K3's transport form
                run = lambda g: k13.int4_grouped_w4a8(  # noqa: E731
                    xq, sx, qa.qdata, qa.scale, qa.zero_point, g, GROUP, qa.zero_point_domain)
                plain = lambda g: k13.int4_grouped_w4a8_plain(  # noqa: E731
                    xq, sx, qa.qdata, s, b, g, GROUP)
                launch = lambda: k13._launch_w4a8(  # noqa: E731
                    xq, sx, qa.qdata, s, b, gs, GROUP)
            results = []
            for what, g in routings:
                got, ref = run(g), plain(g)
                torch.cuda.synchronize()
                sqnr = float(compute_error(ref, got))
                nonzero = bool(got.float().abs().amax(dim=1).gt(0).all()
                               and ref.abs().amax(dim=1).gt(0).all())
                fails.check(bool(torch.isfinite(got).all()) and nonzero and sqnr >= K13_SQNR_DB,
                            f"K13 {form} T={t} K={k} N={n} ({what}): sqnr {sqnr:.2f} dB < "
                            f"{K13_SQNR_DB} or a zero row")
                print(f"K13 {form} T={t} K={k} N={n}, {what} routing (group sizes "
                      f"{g.tolist()}): sqnr {sqnr:.2f} dB (>= {K13_SQNR_DB})", flush=True)
                results.append((got, ref, sqnr))
            got, ref, sqnr = results[0]  # the top-2 routing, which the times are of
            ms = cuda_time_ms(launch, iters=20)
            plain_ms = cuda_time_ms(lambda: plain(gs), iters=2, warmup=1)
            nbytes, ops = k13.traffic(t, k, n, GROUP, active, w4a8=form == "w4a8")
            rows[(form, t, k, n)] = kernel_row(
                f"K13 {K13_FORMS[form][0]}", f"T={t} E={n_experts} K={k} N={n}", got, ref,
                f"sqnr {sqnr:.2f} dB (>= {K13_SQNR_DB}), {active} experts own a row"
                + ("" if forms[form] else ", on no main path"), ms,
                plain_ms, library_ms, nbytes, ops,
                INT8_OPS_PER_S if form == "w4a8" else BF16_FLOPS_PER_S,
                tiles=k13_plan(torch, form, t, k, n, n_experts))
            del results, got, ref
        del stacks, x, xq, tokens
        torch.cuda.empty_cache()
    return rows


def k13_plan(torch, form, t, k, n, n_experts):
    """What a K13 launch of the magic form runs: the decode kernel's K split
    (splits, super-groups a split) or the row tile (None for the w4a8 form
    and in a checkout that predates the plans)."""
    from ao_tpu_torch.ops.hopper import grouped_matmul as k13
    from ao_tpu_torch.ops.hopper import int4_matmul as k1

    if form != "magic" or not hasattr(k13, "decode_plan"):
        return None
    if t > k13.DECODE_MAX_T:
        return f"row tiles of {k13.pick_bm(t, n_experts)}"
    dev = torch.device(DEV, torch.cuda.current_device())
    splits = k13.decode_plan(k, n, n_experts, GROUP, k1._sm_count(dev))
    return f"decode (splits, super-groups a split) {splits}"


@contextlib.contextmanager
def k13_as_plain():
    """K13's wrappers run their plain versions on the card: the same route,
    its quantizers and its routing, the kernel the only difference."""
    import torch

    from ao_tpu_torch.ops.hopper import grouped_matmul as k13
    from ao_tpu_torch.ops.hopper import int4_matmul as k1
    from ao_tpu_torch.quantization.primitives import ZeroPointDomain

    def magic(x, word3, s3, b23, gs, g, raw_zp):
        if raw_zp:
            s3, b23 = k1.transport_qparams(s3, b23, ZeroPointDomain.FLOAT)
        return k13.int4_grouped_magic_plain(x, word3, s3, b23, gs, g).to(torch.bfloat16)

    saved = (k13._launch_magic, k13._launch_w4a8)
    k13._launch_magic, k13._launch_w4a8 = magic, k13.int4_grouped_w4a8_plain
    try:
        yield
    finally:
        k13._launch_magic, k13._launch_w4a8 = saved


def f1_phase(torch, fails, counters):
    """F1: two tiny bf16 models whose attention shapes the kernels do not
    take (head_dim 256; 16 query heads per kv head) decode on the card
    through generate (bf16 and int8 KV), a flash-route prefill and a paged
    decode step. Their greedy tokens equal the "torch" backend's (the same
    einsum attention, no kernel in between); the flash prefill (K8 takes
    the 16-head group, not head_dim 256) and the paged step's logits are
    held to the "torch" backend's at 30 dB; the attention kernels launch
    only where they take the shape."""
    import ao_tpu_torch
    from ao_tpu_torch.models import llama
    from ao_tpu_torch.ops import kernels
    from ao_tpu_torch.quantization.primitives import compute_error
    from ao_tpu_torch.serving.paged import PagedKVPool

    for name, kw in F1_CONFIGS.items():
        cfg = llama.LlamaConfig(vocab_size=512, dim=512, n_layers=2, ffn_dim=1024,
                                tie_embeddings=False, **kw)
        params = llama.init_params(cfg, torch.Generator(device=DEV).manual_seed(SEED),
                                   device=DEV)
        prompt = torch.randint(0, cfg.vocab_size, (2, 16), device=DEV, dtype=torch.int32,
                               generator=torch.Generator(device=DEV).manual_seed(SEED + 1))
        for c in counters.values():
            c.launches = 0
        for kv in (None, "int8"):
            got = ao_tpu_torch.generate(params, prompt, cfg, num_steps=8, max_seq=32,
                                        kv_quant=kv)
            with kernels.backend("torch"):
                want = ao_tpu_torch.generate(params, prompt, cfg, num_steps=8, max_seq=32,
                                             kv_quant=kv)
            same = bool(torch.equal(got, want))
            print(f"F1 {name} (head_dim {cfg.head_dim}, {cfg.n_heads // cfg.n_kv_heads} query "
                  f"heads per kv head), generate over {kv or 'bf16'} KV: tokens equal to the "
                  f"torch backend's: {same}", flush=True)
            fails.check(same, f"F1 {name} {kv or 'bf16'} KV: generate differs from torch's")

        def flash_and_paged():
            caches = llama.init_kv_caches(cfg, 2, 128, device=DEV)
            pre, caches = llama.forward(params, prompt, cfg, kv_caches=caches, cache_index=0,
                                        use_flash=True)
            pools = [tuple(PagedKVPool.create(5, 16, cfg.n_kv_heads, cfg.head_dim, "bf16",
                                              device=DEV) for _ in range(2))
                     for _ in range(cfg.n_layers)]
            table = torch.tensor([[1, 3], [2, 4]], dtype=torch.int32, device=DEV)
            for (kp, vp), (ck, cv) in zip(pools, caches):
                for i in range(2):
                    kp.write_prompt(ck[i, :32], table[i])
                    vp.write_prompt(cv[i, :32], table[i])
            lens = torch.full((2,), 16, dtype=torch.int32, device=DEV)
            step, _ = llama.forward(params, prompt[:, -1:], cfg, positions=lens[:, None],
                                    kv_caches=pools, cache_index=(table, lens))
            return pre, step

        got = flash_and_paged()
        with kernels.backend("torch"):
            want = flash_and_paged()
        for what, g, w in zip(("flash-route prefill", "paged decode step"), got, want):
            sqnr = float(compute_error(w, g))
            print(f"F1 {name} {what} logits vs the torch backend: sqnr {sqnr:.2f} dB "
                  f"(>= {PATH_SQNR_DB})", flush=True)
            fails.check(bool(torch.isfinite(g).all()) and sqnr >= PATH_SQNR_DB,
                        f"F1 {name} {what}: sqnr {sqnr:.2f} dB")
        launched = {k: c.launches for k, c in counters.items() if c.launches}
        want = {"flash_attention": cfg.n_layers} if name == "group16" else {}
        print(f"F1 {name}: kernel launches {launched} (want {want})", flush=True)
        fails.check(launched == want, f"F1 {name}: launches {launched} != {want}")


def linear_scratch(torch, fails, tag, qw):
    """One linear of the path's quantized (K, N) weight at decode (M = B):
    the device memory it allocates beyond its output must stay below a
    quarter of the weight's bytes, so no kernel copies or dequantizes the
    weight per call (the GEMMs read the column-major qdata as stored). The
    decode step's kernels are in ``profile_decode``'s lines."""
    from ao_tpu_torch.ops.linear import linear

    k, n = qw.shape
    gen = torch.Generator(device=DEV).manual_seed(SEED + 14)
    x = torch.randn((BATCH, k), generator=gen, device=DEV).to(torch.bfloat16)
    linear(x, qw)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    y = linear(x, qw)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base - y.numel() * y.element_size()
    print(f"{tag} one linear M={BATCH} K={k} N={n}: scratch beyond the output "
          f"{extra / 2 ** 20:.2f} MiB (weight {k * n / 2 ** 20:.1f} MiB)", flush=True)
    fails.check(extra < k * n // 4,
                f"{tag} linear M={BATCH}: {extra} bytes of scratch, a copy of the weight?")


def weight_config(ao_tpu_torch, tag):
    """The quantization config of a weight path of WEIGHT_PATHS."""
    return {"int8-WO": ao_tpu_torch.Int8WeightOnlyConfig(),
            "W8A8": ao_tpu_torch.Int8DynamicActivationInt8WeightConfig(),
            "fp8-row": ao_tpu_torch.Float8DynamicActivationFloat8WeightConfig(),
            "fp8-block": ao_tpu_torch.Float8DynamicActivationFloat8WeightConfig(
                granularity=ao_tpu_torch.PerBlock((128, 128))),
            "MXFP4-WO": ao_tpu_torch.MXWeightOnlyConfig(elem_dtype="float4_e2m1fn"),
            "NVFP4-WO": ao_tpu_torch.NVFP4WeightOnlyConfig(),
            "NVFP4-dyn": ao_tpu_torch.NVFP4DynamicActivationNVFP4WeightConfig(),
            "NF4-WO": ao_tpu_torch.NF4WeightOnlyConfig()}[tag]


def k8_phase(torch, fails, seed, b, sq, sk):
    """K8 at (B, Sq, Sk) with Llama-3-8B's heads; the library yardstick is
    SDPA with is_causal and GQA on the same tensors, whose causal mask is
    top-left aligned like the reference's (checked here where Sq < Sk)."""
    import torch.nn.functional as F

    from ao_tpu_torch.ops.hopper import flash_attention as k8
    from ao_tpu_torch.quantization.primitives import compute_error
    from ao_tpu_torch.utils.timing import cuda_time_ms

    h, hkv, d = K2_SHAPE["h"], K2_SHAPE["hkv"], K2_SHAPE["d"]
    gen = torch.Generator(device=DEV).manual_seed(seed + 8)
    q = torch.randn((b, sq, h, d), generator=gen, device=DEV).to(torch.bfloat16)
    kc = torch.randn((b, sk, hkv, d), generator=gen, device=DEV).to(torch.bfloat16)
    vc = torch.randn((b, sk, hkv, d), generator=gen, device=DEV).to(torch.bfloat16)
    sm = d ** -0.5
    got = k8.flash_attention(q, kc, vc, causal=True)
    ref = k8.flash_attention_plain(q, kc, vc, True, sm)
    torch.cuda.synchronize()
    sqnr = float(compute_error(ref.float(), got.float()))
    fails.check(bool(torch.isfinite(got).all()) and sqnr >= K8_SQNR_DB,
                f"K8 flash_attention {(b, sq, sk)}: sqnr {sqnr:.2f} dB < {K8_SQNR_DB}")

    def sdpa():
        return F.scaled_dot_product_attention(q.transpose(1, 2), kc.transpose(1, 2),
                                              vc.transpose(1, 2), is_causal=True,
                                              enable_gqa=True)

    if sq < sk:
        lib = float(compute_error(ref.float(), sdpa().transpose(1, 2).float()))
        print(f"K8 {(b, sq, sk)}: SDPA is_causal against the plain version: {lib:.2f} dB "
              f"(top-left aligned if high)", flush=True)
        fails.check(lib >= 30, f"SDPA is_causal is not top-left aligned at {(b, sq, sk)}")
    ms = cuda_time_ms(lambda: k8._launch(q, kc, vc, True, sm), iters=20)
    plain_ms = cuda_time_ms(lambda: k8.flash_attention_plain(q, kc, vc, True, sm), iters=3,
                            warmup=1)
    nbytes, flops = k8.traffic(tuple(q.shape), tuple(kc.shape))
    tiles = None
    if hasattr(k8, "launch_plan"):  # a checkout whose wrapper predates it has no plan
        plan = k8.launch_plan(tuple(q.shape), tuple(kc.shape), True)
        tiles = (f"block_q {plan.block_q}, {len(plan.ctas)} CTAs, key tiles "
                 f"{plan.ctas[0][3]}-{plan.ctas[-1][3]}")
    return kernel_row("K8 flash_attention", f"B={b} Sq={sq} Sk={sk} H={h} Hkv={hkv} D={d}", got,
                      ref, f"sqnr {sqnr:.2f} dB (>= {K8_SQNR_DB})", ms, plain_ms,
                      cuda_time_ms(sdpa, iters=20), nbytes, flops, tiles=tiles)


def k9_phase(torch, fails, seed, lengths, max_pages, dtype_name=None):
    """K9 over pools of 128-row pages (bf16, or with ``dtype_name`` int8,
    fp8 or int4 pages written by ``write_prompt`` from random bf16 values),
    each sequence's pages scattered through a shuffled block table, entries
    past its pages 0 (the null page); the library yardstick is SDPA over the
    same tokens gathered (and dequantized) beforehand into a dense bf16
    cache, the gather not timed."""
    from ao_tpu_torch.ops.hopper import paged_attention as k9
    from ao_tpu_torch.quantization.primitives import compute_error
    from ao_tpu_torch.serving.paged import PagedKVPool
    from ao_tpu_torch.utils.timing import cuda_time_ms

    b, h, hkv, d = (K2_SHAPE[key] for key in ("b", "h", "hkv", "d"))
    n_pages = b * max_pages + 1
    gen = torch.Generator(device=DEV).manual_seed(seed + 9)
    q = torch.randn((b, h, d), generator=gen, device=DEV).to(torch.bfloat16)
    pools = []
    for _ in range(2):
        pool = PagedKVPool.create(n_pages, PAGE, hkv, d, dtype_name or "bf16", device=DEV)
        pool.write_prompt(torch.randn((n_pages * PAGE, hkv, d), generator=gen,
                                      device=DEV).to(torch.bfloat16),
                          torch.arange(n_pages, device=DEV))
        pools.append(pool)
    kp, vp = pools
    order = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(seed)) + 1
    table = order.reshape(b, max_pages).to(torch.int32)
    for i, n in enumerate(lengths):
        table[i, -(-n // PAGE):] = 0
    table = table.to(DEV)
    lens = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    sm = d ** -0.5
    name = POOL_KERNELS[dtype_name]
    wrapper = getattr(k9, name)
    args = (q, kp.pages, kp.scale, vp.pages, vp.scale, table, lens)
    got = (wrapper(*args) if dtype_name else
           wrapper(q, kp.pages, vp.pages, table, lens))
    ref = k9.paged_decode_attention_plain(q, kp.pages, vp.pages, table, lens, sm, kp.scale,
                                          vp.scale)
    torch.cuda.synchronize()
    sqnr = float(compute_error(ref, got))
    t = max_pages * PAGE
    fails.check(bool(torch.isfinite(got).all()) and sqnr >= K2_SQNR_DB,
                f"K9 {name} {dtype_name or 'bf16'} T={t}: sqnr {sqnr:.2f} dB < {K2_SQNR_DB}")
    launch = lambda: k9._launch(*args, sm)  # noqa: E731
    ms = cuda_time_ms(launch, iters=50)
    plain_ms = cuda_time_ms(lambda: k9.paged_decode_attention_plain(
        q, kp.pages, vp.pages, table, lens, sm, kp.scale, vp.scale), iters=10)
    dense_k, dense_v = (pool.gather(table) for pool in (kp, vp))  # bf16 (B, T, Hkv, D)
    nbytes, flops = k9.traffic((b, h, d), tuple(kp.pages.shape), max_pages, lengths,
                               dtype_name or "bf16")
    plan = getattr(k9, "launch_plan", None)  # None in a checkout that predates it
    desc = one_launch(torch, fails, f"K9 {name} {dtype_name or 'bf16'} T={t}", launch,
                      plan and plan(q.shape, kp.pages.shape, max_pages, kp.pages.dtype))
    return kernel_row(f"K9 {name}",
                      f"B={b} H={h} Hkv={hkv} D={d} page_size={PAGE} T={t} "
                      f"{dtype_name or 'bf16'} pool", got, ref,
                      f"sqnr {sqnr:.2f} dB (>= {K2_SQNR_DB})", ms, plain_ms,
                      sdpa_ms(torch, q, dense_k, dense_v, lens, sm), nbytes, flops, tiles=desc)


def k9_rows(torch, fails, seed):
    """K9 in each mode at the paged engine's decode shape and at T_LONG:
    {pool dtype (None for bf16): (engine row, T_LONG row)}."""
    return {kv: (k9_phase(torch, fails, seed, ENGINE_LENGTHS, ENGINE_CFG["max_seq"] // PAGE, kv),
                 k9_phase(torch, fails, seed, [T_LONG] * K2_SHAPE["b"], T_LONG // PAGE, kv))
            for kv in (None,) + KV_QUANT}


def check_serving_logits(torch, fails, qparams, cfg, seed, kv_quant=None):
    """Two-layer logits of the serving paths, kernel route against the plain
    route (the "torch" backend), each from its own prefill: (a) a prefill
    with use_flash=True over a cache longer than the prompt (K8), (c) then
    one decode step with a per-slot cache_index whose positions differ by
    row (row 1 rewrites position 77; K2 over each row's length), and (b) one
    paged decode step (K9) after prefills written into scattered pages. With
    ``kv_quant`` the slot caches are ``QuantKVCache``s (K8 over their
    values, K5 / K6 / K7 at the step) and the pools are quantized by
    ``write_prompt`` from bf16 prefills, as the engine writes them (K9
    "vec8" / "int4"). No quantizer lies on the bf16 paths, so the fixed 30
    dB bound applies there; a cache's quantizer turns bf16-level
    differences into whole steps, so with ``kv_quant`` the bound comes
    within FLOOR_MARGIN_DB of the plain route's own nudge floor
    (``check_logits``), and each decode kernel is also held at 30 dB to the
    einsum attention (slots, ``force_xla_attention``) or the gather
    reference (pages) on the same linears and the same cache."""
    import copy
    from unittest import mock

    from ao_tpu_torch.models import llama
    from ao_tpu_torch.ops import kernels
    from ao_tpu_torch.quantization.primitives import compute_error
    from ao_tpu_torch.serving import paged

    tag = KV_TAG[kv_quant] if kv_quant else "int4-WO"
    cut = dataclasses.replace(cfg, n_layers=2)
    params = dict(qparams, layers=qparams["layers"][:2])
    gen = torch.Generator(device=DEV).manual_seed(seed + 7)
    b, s, t = 2, PROMPT, MAX_SEQ
    toks = torch.randint(0, cfg.vocab_size, (b, t), generator=gen, device=DEV, dtype=torch.int32)
    rows = torch.arange(b, device=DEV)
    slot_pos = torch.tensor([s, 77], dtype=torch.int32, device=DEV)
    paged_len = torch.tensor([100, 200], dtype=torch.int32, device=DEV)
    table = torch.tensor([[3, 1], [4, 2]], dtype=torch.int32, device=DEV)

    def prefill(p):
        caches = init_caches(cut, b, t, kv_quant)
        logits, caches = llama.forward(p, toks[:, :s], cut, kv_caches=caches, cache_index=0,
                                       use_flash=True)
        pools = [tuple(paged.PagedKVPool.create(2 * b + 1, PAGE, cut.n_kv_heads, cut.head_dim,
                                                kv_quant or "bf16", device=DEV)
                       for _ in range(2)) for _ in range(2)]
        for i in range(b):
            scratch = llama.init_kv_caches(cut, 1, t, device=DEV)
            llama.forward(p, toks[i:i + 1], cut, kv_caches=scratch, cache_index=0,
                          use_flash=True)
            for (kp, vp), (sk, sv) in zip(pools, scratch):
                kp.write_prompt(sk[0], table[i])
                vp.write_prompt(sv[0], table[i])
        return logits, caches, pools

    def steps(p, caches, pools, c=cut):
        slot, _ = llama.forward(p, toks[rows, slot_pos.long()][:, None], c,
                                positions=slot_pos[:, None], kv_caches=caches,
                                cache_index=slot_pos)
        pg, _ = llama.forward(p, toks[rows, paged_len.long()][:, None], c,
                              positions=paged_len[:, None], kv_caches=pools,
                              cache_index=(table, paged_len))
        return slot, pg

    def run(p):
        logits, caches, pools = prefill(p)
        return (logits,) + steps(p, caches, pools)

    logits, caches, pools = prefill(params)
    same_cache = copy.deepcopy((caches, pools)) if kv_quant else None
    got = (logits,) + steps(params, caches, pools)
    with kernels.backend("torch"):
        plain = run(params)
        if kv_quant:
            emb = params["embed"]
            nudged = run(dict(params, embed=(emb.float() * (1 + 2 ** -8)).to(emb.dtype)))
    for i, what in enumerate(("flash prefill (a)", "per-slot decode step (c)",
                              "paged decode step (b)")):
        sqnr = float(compute_error(plain[i], got[i]))
        need, note = PATH_SQNR_DB, ""
        if kv_quant:
            floor = float(compute_error(plain[i], nudged[i]))
            need = min(PATH_SQNR_DB, max(PATH_MIN_DB, floor - FLOOR_MARGIN_DB))
            note = f"; plain route vs itself nudged by 2^-8: {floor:.2f} dB"
        print(f"{tag} two-layer {what} logits, kernel route vs plain route: sqnr {sqnr:.2f} dB "
              f"(>= {need:.2f}){note}", flush=True)
        fails.check(bool(torch.isfinite(got[i]).all()) and sqnr >= need,
                    f"{tag} two-layer {what} logits: sqnr {sqnr:.2f} dB < {need:.2f}")
    if kv_quant:
        with mock.patch.object(paged, "paged_attention", paged.paged_decode_attention_reference):
            plain_attn = steps(params, *same_cache, c=dataclasses.replace(
                cut, force_xla_attention=True))
        for i, (what, ref) in enumerate((("per-slot decode step (c)", "einsum"),
                                         ("paged decode step (b)", "gather"))):
            sqnr = float(compute_error(plain_attn[i], got[i + 1]))
            print(f"{tag} two-layer {what} logits, the decode kernel vs the {ref} attention on "
                  f"the same linears and cache: sqnr {sqnr:.2f} dB (>= {PATH_SQNR_DB})",
                  flush=True)
            fails.check(sqnr >= PATH_SQNR_DB,
                        f"{tag} {what} logits, kernel vs plain attention: sqnr {sqnr:.2f} dB")


def engine_requests(seed, vocab):
    """The engine runs' 16 requests, (prompt, max_new_tokens, sampling
    overrides), from ``seed``: 12 prompts of 32-500 tokens, one of 128, one
    of 512 and two of 600-900 (chunked prefills), 16-64 new tokens, two of
    them sampled."""
    import torch

    rnd = random.Random(seed)
    lengths = ([rnd.randint(32, 500) for _ in range(12)] + [128, 512]
               + [rnd.randint(600, 900) for _ in range(2)])
    rnd.shuffle(lengths)
    sampled = set(rnd.sample(range(N_REQUESTS), 2))
    gen = torch.Generator().manual_seed(seed)
    return [(torch.randint(0, vocab, (n,), generator=gen).tolist(), rnd.randint(16, 64),
             dict(temperature=0.8, top_k=50, top_p=0.95) if i in sampled else {})
            for i, n in enumerate(lengths)]


def k13_takes_rows():
    """Whether the route sends T routed rows of a magic expert stack on the
    card to K13 (``moe.grouped.k13_takes_rows``; the reference's gate of
    ``kernels.GROUPED_KERNEL_MAX_T`` rows in a checkout that predates it)."""
    from ao_tpu_torch.moe import grouped
    from ao_tpu_torch.ops import kernels

    rule = getattr(grouped, "k13_takes_rows", None)
    if rule is None:
        return lambda t: t <= kernels.GROUPED_KERNEL_MAX_T
    return lambda t: rule(t, "magic", True)


def engine_tag(paged, kv_quant=None):
    return ("engine-paged" if paged else "engine-slots") + (
        f"-{SHORT[kv_quant]}KV" if kv_quant else "")


def engine_run(torch, fails, qparams, cfg, requests, counters, paged, kv_quant=None):
    """Serve ``requests`` with the Engine in one layout, over a bf16 or a
    ``kv_quant`` KV: every counter set to 0 before and checked exactly after
    against the engine's own schedule, every request finished with its
    tokens. Returns (launches, the finished requests' tokens, metrics)."""
    import ao_tpu_torch

    model = "Mixtral-8x7B" if cfg.n_experts else "Llama-3-8B"
    tag = ("Mixtral " if cfg.n_experts else "") + engine_tag(paged, kv_quant)
    layout = dict(kv_layout="paged", page_size=PAGE) if paged else {}
    eng = ao_tpu_torch.Engine(qparams, cfg, ao_tpu_torch.ServeConfig(
        **ENGINE_CFG, **layout, kv_quant=kv_quant), device=DEV)
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for prompt, m, kw in requests:
        eng.submit(prompt, m, **kw)
    first = []  # time to each request's first token, in admission (= uid) order
    while True:
        st = eng.stats()
        if not st["queued_requests"] and not st["active_slots"]:
            break
        eng.step()
        now = time.perf_counter() - t0
        first += [now] * (eng.stats()["prefills"] - len(first))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    done = eng.run(max_steps=0)
    got = {name: c.launches for name, c in counters.items()}
    st = eng.stats()
    buckets = ENGINE_CFG["prefill_buckets"]
    chunk = max(buckets)
    per_bucket = {bk: sum(len(p) <= chunk and min(x for x in buckets if x >= len(p)) == bk
                          for p, _, _ in requests) for bk in buckets}
    n_bucketed = sum(per_bucket.values())
    n_chunks = sum(-(-len(p) // chunk) for p, _, _ in requests if len(p) > chunk)
    n_steps = st["steps"]  # every step of the loop ran a decode forward
    # an MoE layer's four attention linears take K1, its experts K13
    linears = (4 if cfg.n_experts else 7) * cfg.n_layers + 1
    want = {name: 0 for name in counters}
    want["flash_attention"] = cfg.n_layers * n_bucketed
    want["int4_wo_magic"] = linears * (n_bucketed + n_chunks + n_steps)
    if cfg.n_experts:
        # K13 for w_gate, w_up and w_down at every decode step (8 slots x
        # top-k rows) and in the prefills (a bucket's or a chunk's padded
        # tokens x top-k rows) whose rows its route takes (all of them on
        # the card; a prefill it does not take runs the ragged fallback)
        takes = k13_takes_rows()
        fits = sum(n for bk, n in per_bucket.items() if takes(bk * cfg.top_k_experts))
        fits += n_chunks if takes(chunk * cfg.top_k_experts) else 0
        want["int4_grouped_magic"] = 3 * cfg.n_layers * (n_steps + fits)
    decode = (POOL_KERNELS[kv_quant] if paged
              else KV_KERNELS[kv_quant][0] if kv_quant else "decode_attention")
    want[decode] = cfg.n_layers * n_steps
    print(f"{tag}: {n_bucketed} bucketed prefills (per bucket {per_bucket}), {n_chunks} prefill "
          f"chunks, {n_steps} decode steps; launches {got} (want {want})", flush=True)
    fails.check(got == want, f"{tag} launch counts {got} != {want}")
    fails.check(st["prefills"] == len(requests) == len(done) == st["finished_requests"],
                f"{tag}: {len(done)} of {len(requests)} requests finished ({st})")
    tokens = {}
    for r in done:
        ok = (len(r.generated) == r.max_new_tokens and r.finish_reason == "length"
              and all(0 <= x < cfg.vocab_size for x in r.generated))
        fails.check(ok, f"{tag} request {r.uid}: {len(r.generated)} tokens of "
                        f"{r.max_new_tokens}, finish {r.finish_reason}")
        tokens[r.uid] = r.generated
    n_tok = sum(len(g) for g in tokens.values())
    metrics = dict(requests_per_s=len(requests) / wall, tok_per_s=n_tok / wall,
                   mean_ttft_s=sum(first) / len(first), wall_s=wall, steps=n_steps)
    print(f"{tag} ({model} int4-WO, {kv_quant or 'bf16'} KV, {cfg.n_layers} layers, "
          f"{len(requests)} requests on "
          f"{ENGINE_CFG['max_batch']} slots, max_seq {ENGINE_CFG['max_seq']}): {wall:.2f} s, "
          f"{metrics['requests_per_s']:.3f} requests/s, {metrics['tok_per_s']:.1f} output tok/s, "
          f"mean time to first token {metrics['mean_ttft_s']:.3f} s", flush=True)
    profile_engine(torch, eng, cfg, tag)
    return got, tokens, metrics


def profile_engine(torch, eng, cfg, tag, steps=4):
    """One engine step with all 8 slots decoding (128-token prompts, after
    their admission): host wall time per step (host clock; each step ends in
    its token read) and device busy time, ops and kernels per step
    (torch.profiler, CUDA activity, over a second window)."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator().manual_seed(SEED + 11)
    for _ in range(ENGINE_CFG["max_batch"]):
        eng.submit(torch.randint(0, cfg.vocab_size, (PROMPT,), generator=gen).tolist(), 16)
    for _ in range(3):  # admission and two warm steps
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    busy_ms, ops, top = device_time(prof, steps)
    print(f"{tag} step ({cfg.n_layers} layers, 8 slots decoding): host wall {wall_ms:.3f} "
          f"ms/step, device busy {busy_ms:.3f} ms/step ({busy_ms / wall_ms:.1%}), "
          f"{ops} device ops/step", flush=True)
    for name, ms in top:
        print(f"    {ms:.3f} ms/step  {name[:110]}", flush=True)
    eng.run()


def init_caches(cfg, batch, max_seq, kv_quant):
    """Per-layer KV caches on the card: bf16, or quantized with ``kv_quant``."""
    from ao_tpu_torch.models import llama
    from ao_tpu_torch.serving.kvcache import init_quant_kv_caches

    if kv_quant:
        return init_quant_kv_caches(cfg, batch, max_seq, kv_quant, device=DEV)
    return llama.init_kv_caches(cfg, batch, max_seq, device=DEV)


@contextlib.contextmanager
def k14_as_plain():
    """K14's wrappers run their plain versions on the card: the kernel route
    with its quantizers and roundings, the kernel itself the only
    difference."""
    from ao_tpu_torch.ops.hopper import fp4_matmul as k14

    def plain(kind, x, word, scale, pts, name):
        if kind == k14.MX:
            return k14.mxfp4_wo_matmul_plain(x, word, scale)
        return k14.nvfp4_wo_matmul_plain(x, word, scale, pts)

    saved, k14._launch = k14._launch, plain
    try:
        yield
    finally:
        k14._launch = saved


class RoutePin:
    """Pins an MoE model's expert choices: ``record`` keeps the top-k
    experts of every ``route`` call of one run (the plain route),
    ``replay(what)`` makes a later run take them in the same order, weighted
    by its own router probabilities, and prints on how many token decisions
    its own top-k would have differed, and at what gap between the k-th and
    (k+1)-th expert probability."""

    def __init__(self):
        self.routes = []

    @contextlib.contextmanager
    def _patched(self, fn):
        from ao_tpu_torch.moe import layer

        orig = layer.route
        layer.route = lambda x2, w, cfg: fn(orig, x2, w, cfg)
        try:
            yield
        finally:
            layer.route = orig

    def record(self):
        def keep(orig, x2, w, cfg):
            out = orig(x2, w, cfg)
            self.routes.append(out)
            return out

        return self._patched(keep)

    @contextlib.contextmanager
    def replay(self, what):
        import torch

        calls, moved, total, gaps = iter(self.routes), 0, 0, []

        def pinned(orig, x2, w, cfg):
            nonlocal moved, total
            topi = next(calls)[1]
            own = orig(x2, w, cfg)[1]
            diff = (own.sort(dim=-1).values != topi.sort(dim=-1).values).any(dim=-1)
            probs = torch.softmax(x2.float() @ w.float(), dim=-1)
            top = torch.topk(probs, cfg.top_k + 1, dim=-1).values
            gaps.append((top[:, -2] - top[:, -1])[diff])
            moved, total = moved + int(diff.sum()), total + diff.numel()
            topw = probs.gather(-1, topi.long())
            if cfg.norm_topk:
                topw = topw / torch.sum(topw, dim=-1, keepdim=True)
            return topw, topi

        with self._patched(pinned):
            yield
        gap = float(torch.cat(gaps).max()) if moved else 0.0
        print(f"  {what}: its own router would route {moved} of {total} token decisions "
              f"otherwise than the plain route (largest top-k gap among them {gap:.2e}); "
              f"pinned to the plain route's", flush=True)


def check_logits(torch, fails, qparams, cfg, seed, tag, batch=2, prompt_len=16,
                 floor_margin_db=None, kv_quant=None, min_db=PATH_MIN_DB, isolate=None):
    """A two-layer cut of the quantized model at full width: a prefill of
    ``batch`` x ``prompt_len`` tokens and one decode step through the kernel
    route, against the plain route (the "torch" backend: dequantize +
    torch.matmul, or q/dq for W4A8, and masked einsum attention) on the same
    inputs. The two differ by bf16 roundings (the kernels keep qparams in
    bf16 and sum in f32; the plain route rounds each dequantized weight, and
    for W4A8 each dequantized activation, to bf16), which compound over the
    layers: 30 dB for int4-WO.

    W4A8 quantizes every linear's input to int8 per token, and a quantizer
    turns a difference at bf16's rounding level into whole-step flips, so two
    correct routes drift apart as far as one route does from itself under a
    nudge of one bf16 rounding. With ``floor_margin_db`` the check measures
    that floor, the plain route against itself with its embedding table
    scaled by (1 + 2^-8), and asks the kernel route for 30 dB or, where the
    floor is lower, to come within ``floor_margin_db`` of it, never below
    PATH_MIN_DB.

    With ``kv_quant`` both routes run over a quantized KV cache, whose
    quantizer amplifies the routes' bf16 differences in K and V in the same
    way. The decode step of the kernel route reads the cache with K5, K6 or
    K7, so the check also holds its decode logits at 30 dB against the same
    linears and cache with the masked einsum attention
    (``force_xla_attention``): there the kernel is the only difference.

    ``min_db`` replaces PATH_MIN_DB where the quantizer is coarser than int8
    or fp8 (NVFP4's fp4 activations, whose floor lies near 10 dB); there
    ``isolate``, a context in which the kernels run their plain versions on
    the card, gives the same route with the kernel as the only difference.
    Even that difference (f32 sums in another order, a bf16 rounding
    flipped here and there) crosses fp4 steps, so it is held to the same
    calibrated bound and printed beside it.

    For an MoE model (``cfg.n_experts``) every run takes the plain route's
    expert choices (``RoutePin``): the router is plain torch on both routes,
    and its top-k, a discrete decision like a quantizer's, moves a token to
    another expert where its k-th and (k+1)-th probabilities nearly tie (a
    gap of 1.3e-4 on the int4-WO cut's prefill); how often each run's own
    router would have chosen otherwise is printed."""
    from ao_tpu_torch.models import llama
    from ao_tpu_torch.ops import kernels
    from ao_tpu_torch.quantization.primitives import compute_error

    cut = dataclasses.replace(cfg, n_layers=2)
    params = dict(qparams, layers=qparams["layers"][:2])
    gen = torch.Generator(device=DEV).manual_seed(seed + 2)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt_len + 1), generator=gen, device=DEV,
                         dtype=torch.int32)

    def run(p, c=cut):
        caches = init_caches(c, batch, prompt_len + 16, kv_quant)
        pos = torch.arange(prompt_len, dtype=torch.int32, device=DEV).expand(batch, prompt_len)
        l0, caches = llama.forward(p, toks[:, :prompt_len], c, positions=pos,
                                   kv_caches=caches, cache_index=0)
        l1, _ = llama.forward(p, toks[:, prompt_len:], c,
                              positions=torch.full((batch, 1), prompt_len, dtype=torch.int32,
                                                   device=DEV),
                              kv_caches=caches, cache_index=prompt_len)
        return l0, l1

    pin = RoutePin() if cfg.n_experts else None
    replay = pin.replay if pin else (lambda what: contextlib.nullcontext())
    with kernels.backend("torch"):
        with pin.record() if pin else contextlib.nullcontext():
            plain = run(params)
        if floor_margin_db is not None:
            emb = params["embed"]
            with replay("the plain route nudged by 2^-8"):
                nudged = run(dict(params, embed=(emb.float() * (1 + 2 ** -8)).to(emb.dtype)))
    with replay("the kernel route"):
        got = run(params)
    needs = []
    for i, step in enumerate(("prefill", "decode")):
        sqnr = float(compute_error(plain[i], got[i]))
        need, note = PATH_SQNR_DB, ""
        if floor_margin_db is not None:
            floor = float(compute_error(plain[i], nudged[i]))
            need = min(PATH_SQNR_DB, max(min_db, floor - floor_margin_db))
            note = f"; plain route vs itself nudged by 2^-8: {floor:.2f} dB"
        print(f"{tag} two-layer {step} logits (B={batch}, prompt {prompt_len}), kernel route vs "
              f"plain route: sqnr {sqnr:.2f} dB (>= {need:.2f}){note}", flush=True)
        fails.check(bool(torch.isfinite(got[i]).all()) and sqnr >= need,
                    f"{tag} two-layer {step} logits: sqnr {sqnr:.2f} dB < {need:.2f}")
        needs.append(need)
    if isolate is not None:
        with isolate(), replay("the kernels' plain versions"):
            plain_kernels = run(params)
        for i, step in enumerate(("prefill", "decode")):
            sqnr = float(compute_error(plain_kernels[i], got[i]))
            print(f"{tag} two-layer {step} logits, the kernels vs their plain versions in the "
                  f"same route: sqnr {sqnr:.2f} dB (>= {needs[i]:.2f})", flush=True)
            fails.check(sqnr >= needs[i],
                        f"{tag} {step} logits, kernels vs plain versions: sqnr {sqnr:.2f} dB")
    if kv_quant:
        with replay("the einsum attention"):
            einsum = run(params, dataclasses.replace(cut, force_xla_attention=True))
        sqnr = float(compute_error(einsum[1], got[1]))
        print(f"{tag} two-layer decode logits, the decode attention kernel vs the einsum "
              f"attention on the same linears and cache: sqnr {sqnr:.2f} dB "
              f"(>= {PATH_SQNR_DB})", flush=True)
        fails.check(sqnr >= PATH_SQNR_DB,
                    f"{tag} decode logits, kernel vs einsum attention: sqnr {sqnr:.2f} dB")


def generate_tok_per_s(torch, generate, runs, prompt, steps, rounds=2):
    """tok/s of greedy ``generate`` for each (tag, params, kv_quant, cfg) of
    ``runs``: host clock around a whole call that ends in a synchronize, the
    runs taken in turns for ``rounds`` rounds after one warm-up call each;
    the median (of two rounds, their mean)."""
    times = {tag: [] for tag, *_ in runs}
    for _, params, kv, cfg in runs:
        generate(params, prompt, cfg, num_steps=steps, max_seq=MAX_SEQ, kv_quant=kv)
    for _ in range(rounds):
        for tag, params, kv, cfg in runs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            generate(params, prompt, cfg, num_steps=steps, max_seq=MAX_SEQ, kv_quant=kv)
            torch.cuda.synchronize()
            times[tag].append(time.perf_counter() - t0)
    return {tag: prompt.shape[0] * steps / statistics.median(ts) for tag, ts in times.items()}


def device_time(prof, runs):
    """(device busy ms per run, device ops per run, the five largest kernels
    as (name, ms per run)) from a profile of ``runs`` runs."""
    from torch.autograd import DeviceType

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / runs
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return sum(by_name.values()), len(kernels) // runs, top


def profile_decode(torch, params, cfg, prompt, tag, steps=4, kv_quant=None):
    """Where the time of the prefill and of one eager decode step goes: host
    wall time (host clock around work ending in a synchronize), device busy
    time and the kernels that take it (torch.profiler, CUDA activity, in a
    second run of the same work)."""
    from torch.profiler import ProfilerActivity, profile

    from ao_tpu_torch.models import llama

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    b, s = prompt.shape

    def prefill():
        caches = init_caches(cfg, b, MAX_SEQ, kv_quant)
        logits, caches = llama.forward(params, prompt, cfg, positions=torch.arange(
            s, dtype=torch.int32, device=DEV).expand(b, s), kv_caches=caches, cache_index=0)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), caches

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tok, caches = prefill()
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=activities) as prof:
        prefill()
        torch.cuda.synchronize()
    pre_busy, pre_ops, pre_top = device_time(prof, 1)

    def run(first):
        nonlocal tok
        for i in range(first, first + steps):
            pos = torch.full((b, 1), s + i, dtype=torch.int32, device=DEV)
            lg, _ = llama.forward(params, tok[:, None], cfg, positions=pos, kv_caches=caches,
                                  cache_index=s + i)
            tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)
        torch.cuda.synchronize()

    run(0)
    t0 = time.perf_counter()
    run(steps)
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=activities) as prof:
        run(2 * steps)
    busy_ms, ops, top = device_time(prof, steps)
    print(f"{tag} decode step ({cfg.n_layers} layers, B={b}): host wall {wall_ms:.3f} ms/step, "
          f"device busy {busy_ms:.3f} ms/step ({busy_ms / wall_ms:.1%}), "
          f"{ops} device ops/step", flush=True)
    for name, ms in top:
        print(f"    {ms:.3f} ms/step  {name[:110]}", flush=True)
    print(f"{tag} prefill (B={b}, prompt {s}): host wall {prefill_ms:.1f} ms, device busy "
          f"{pre_busy:.3f} ms ({pre_busy / prefill_ms:.1%}), {pre_ops} device ops", flush=True)
    for name, ms in pre_top:
        print(f"    {ms:.3f} ms  {name[:110]}", flush=True)


def fill_rel_pos(torch, params, gen):
    """SAM's init zeroes the rel-pos tables (the ViTDet default), so a
    kernel that dropped the bias would pass every check: fill them from the
    seed, scaled so that the rel terms come out about REL_POS_SCALE large."""
    for lp in params["layers"]:
        for key in ("rel_pos_h", "rel_pos_w"):
            tab = lp["attn"][key]
            lp["attn"][key] = (torch.randn(tab.shape, generator=gen, device=DEV)
                               * REL_POS_SCALE * tab.shape[-1] ** -0.5).to(tab.dtype)
    return params


@contextlib.contextmanager
def vision_as_plain():
    """K16's, K12n's and K12g's wrappers run their plain versions on the
    card: the same route with its quantizers, the kernels the only
    difference."""
    from ao_tpu_torch.ops.hopper import fused_act as k12
    from ao_tpu_torch.ops.hopper import window_attention as k16

    saved = (k16._launch, k12._launch_norm, k12._launch_gelu)
    k16._launch = lambda q, k, v, rh, rw, side, scale: k16.window_bias_attention_plain(
        q, k, v, rh, rw, side, scale)
    k12._launch_norm = k12.norm_modulate_quant_plain
    k12._launch_gelu = k12.gelu_quant_plain
    try:
        yield
    finally:
        k16._launch, k12._launch_norm, k12._launch_gelu = saved


def forward_ms(torch, run) -> float:
    """Host milliseconds of one call of ``run`` ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def profile_forward(torch, tag, run, n_images, rounds=3, wall_ms=None):
    """images/s of ``run`` (host clock around a call ending in a
    synchronize; the median of ``rounds`` calls after the launch-count
    call, or ``wall_ms`` where the caller timed it), and the device busy
    share, ops and top kernels of one profiled call. Returns images/s."""
    from torch.profiler import ProfilerActivity, profile

    if wall_ms is None:
        wall_ms = statistics.median(forward_ms(torch, run) for _ in range(rounds))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    busy_ms, ops, top = device_time(prof, 1)
    ips = n_images / wall_ms * 1e3
    print(f"{tag} forward ({n_images} images): {ips:.2f} images/s, host wall {wall_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}), {ops} device ops", flush=True)
    for name, ms in top:
        print(f"    {ms:.3f} ms  {name[:110]}", flush=True)
    return ips


def sam_paths(torch, fails, counters, launches, ips):
    """SAM-B at full width (12 layers, image 1024, windows of 14, global
    layers 2, 5, 8, 11; rel-pos tables filled), random weights from the
    seed: 4 images with 2 point prompts each through ``sam.forward``, under
    W8A8 (``Int8DynamicActivationInt8WeightConfig()``: torch._int_mm for
    the linears, K12n and K12g in the MLPs and before the global layers'
    q, k, v, K16 for the attention) and in bf16 (K16). Launch counts exact;
    masks and IoU against the "torch" backend: 30 dB in bf16; under W8A8,
    where the int8 activation quantizers turn bf16-level differences into
    whole steps, within FLOOR_MARGIN_DB of the plain route's own floor under
    a nudge of the images by (1 + 2^-8) (30 dB where the floor is higher),
    and where that floor is under 23 dB the kernels are also held against
    their plain versions inside the same route at that bound."""
    import ao_tpu_torch
    from ao_tpu_torch.models import sam
    from ao_tpu_torch.ops import kernels
    from ao_tpu_torch.quantization.primitives import compute_error

    cfg = sam.SAM_B
    gen = torch.Generator(device=DEV).manual_seed(SEED + 30)
    params = fill_rel_pos(torch, sam.init_params(cfg, gen, device=DEV), gen)
    images = torch.randn((SAM_BATCH, cfg.image_size, cfg.image_size, 3), generator=gen,
                         device=DEV)
    coords = torch.rand((SAM_BATCH, SAM_POINTS, 2), generator=gen, device=DEV) * cfg.image_size
    labels = torch.tensor([[1, 0]] * SAM_BATCH, dtype=torch.int32, device=DEV)
    n_glb = len(cfg.global_attn_layers)
    n_win = cfg.n_layers - n_glb
    for tag in ("SAM-B W8A8", "SAM-B bf16"):
        w8a8 = tag.endswith("W8A8")
        p = (ao_tpu_torch.quantize_(params, ao_tpu_torch.Int8DynamicActivationInt8WeightConfig())
             if w8a8 else params)
        want = {name: 0 for name in counters}
        want["window_bias_attention"] = cfg.n_layers
        if w8a8:
            want["norm_modulate_quant"] = 2 * n_glb + n_win
            want["gelu_quant"] = cfg.n_layers

        def run(imgs=images, p=p):
            return sam.forward(p, imgs, coords, labels, cfg)

        for c in counters.values():
            c.launches = 0
        got = run()
        torch.cuda.synchronize()
        launches[tag] = {name: c.launches for name, c in counters.items()}
        print(f"{tag} launches: {launches[tag]} (want {want})", flush=True)
        fails.check(launches[tag] == want, f"{tag} launch counts {launches[tag]} != {want}")
        g4 = 4 * cfg.grid
        fails.check(tuple(got[0].shape) == (SAM_BATCH, cfg.n_mask_tokens, g4, g4)
                    and tuple(got[1].shape) == (SAM_BATCH, cfg.n_mask_tokens)
                    and all(bool(torch.isfinite(x).all()) for x in got),
                    f"{tag}: masks {tuple(got[0].shape)}, iou {tuple(got[1].shape)} not finite "
                    f"or out of shape")
        with kernels.backend("torch"):
            plain = run()
            nudged = run(images * (1 + 2 ** -8)) if w8a8 else None
        needs = []
        for i, what in enumerate(("masks", "IoU")):
            sqnr = float(compute_error(plain[i], got[i]))
            need, note = PATH_SQNR_DB, ""
            if w8a8:
                floor = float(compute_error(plain[i], nudged[i]))
                need = min(PATH_SQNR_DB, floor - FLOOR_MARGIN_DB)
                note = f"; plain route vs itself with the images nudged by 2^-8: {floor:.2f} dB"
            needs.append(need)
            print(f"{tag} {what}, kernel route vs plain route: sqnr {sqnr:.2f} dB "
                  f"(>= {need:.2f}){note}", flush=True)
            fails.check(sqnr >= need, f"{tag} {what}: sqnr {sqnr:.2f} dB < {need:.2f}")
        if w8a8 and min(needs) < PATH_SQNR_DB - 7:  # a floor under 23 dB
            with vision_as_plain():
                alone = run()
            for i, what in enumerate(("masks", "IoU")):
                sqnr = float(compute_error(alone[i], got[i]))
                print(f"{tag} {what}, the kernels vs their plain versions in the same route: "
                      f"sqnr {sqnr:.2f} dB (>= {needs[i]:.2f})", flush=True)
                fails.check(sqnr >= needs[i], f"{tag} {what}, kernels vs plain versions: "
                                              f"sqnr {sqnr:.2f} dB")
        del plain, nudged, got
        torch.cuda.empty_cache()
        ips[tag] = profile_forward(torch, tag, run, SAM_BATCH)
        del p
        torch.cuda.empty_cache()


def vit_paths(torch, fails, counters, launches, ips):
    """ViT-B/16 at full width (12 layers), random weights from the seed,
    batch 4 at 224^2 (M = 788 rows per linear) through ``vit.forward``:
    under ``Int4WeightOnlyConfig(group_size=128)`` (K11 for wq, wk, wv, wo
    and w1, whose 768-wide inputs have 6 groups: the split-half layout; K1
    for w2, 24 groups: magic; the 1000-class head, N % 128 != 0, dequantized)
    and in bf16 (no kernel). Launch counts exact; int4-WO logits against the
    "torch" backend at 30 dB."""
    import ao_tpu_torch
    from ao_tpu_torch.models import vit
    from ao_tpu_torch.ops import kernels
    from ao_tpu_torch.quantization.primitives import compute_error

    cfg = vit.VIT_B16
    gen = torch.Generator(device=DEV).manual_seed(SEED + 31)
    params = vit.init_params(cfg, gen, device=DEV)
    images = torch.randn((VIT_BATCH, cfg.image_size, cfg.image_size, 3), generator=gen,
                         device=DEV)
    qparams = ao_tpu_torch.quantize_(params, ao_tpu_torch.Int4WeightOnlyConfig(group_size=GROUP))
    for tag, p in (("ViT-B/16 int4-WO", qparams), ("ViT-B/16 bf16", params)):
        want = {name: 0 for name in counters}
        if p is qparams:
            want["int4_wo_matmul"] = 5 * cfg.n_layers
            want["int4_wo_magic"] = cfg.n_layers

        def run(p=p):
            return vit.forward(p, images, cfg)

        for c in counters.values():
            c.launches = 0
        got = run()
        torch.cuda.synchronize()
        launches[tag] = {name: c.launches for name, c in counters.items()}
        print(f"{tag} launches: {launches[tag]} (want {want})", flush=True)
        fails.check(launches[tag] == want, f"{tag} launch counts {launches[tag]} != {want}")
        fails.check(tuple(got.shape) == (VIT_BATCH, cfg.n_classes) and got.dtype == torch.float32
                    and bool(torch.isfinite(got).all()),
                    f"{tag}: logits {tuple(got.shape)} {got.dtype} not finite or out of shape")
        with kernels.backend("torch"):
            plain = run()
        sqnr = float(compute_error(plain, got))
        print(f"{tag} logits, kernel route vs plain route: sqnr {sqnr:.2f} dB "
              f"(>= {PATH_SQNR_DB})", flush=True)
        fails.check(sqnr >= PATH_SQNR_DB, f"{tag} logits: sqnr {sqnr:.2f} dB < {PATH_SQNR_DB}")
        ips[tag] = profile_forward(torch, tag, run, VIT_BATCH)


def torch_bsr_ms(torch, x, w_dq, b, got):
    """``torch.sparse``'s BSR x dense product on the same function (the
    weight's transpose in BSR times x's transpose): (ms, note), or (None,
    the error) where it raises on the card."""
    from ao_tpu_torch.utils.timing import cuda_time_ms

    try:
        wt = w_dq.t().contiguous().to_sparse_bsr((b, b))
        xt = x.t().contiguous()
        y = (wt @ xt).t()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError, ValueError) as e:
        return None, f"raises {type(e).__name__}: {str(e).splitlines()[0][:200]}"
    err = float((y.float() - got.float()).abs().max())
    return cuda_time_ms(lambda: wt @ xt, iters=10), f"max|err| vs K18 {err:.3g}"


def host_us(torch, fn, n=50) -> float:
    """Host microseconds per call of ``fn`` over ``n`` calls enqueued back
    to back (a synchronize before and none inside: the Python and launch
    cost, as long as the device keeps up)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def k18_phase(torch, fails, seed):
    """K18 at K18_SHAPES: a random bf16 weight made block-sparse as
    ``BlockSparseWeightConfig`` does; the library yardstick is bf16
    torch.matmul on the dequantized weight (``torch.sparse``'s BSR product
    printed beside it). At the main path's shapes it also prints the host
    cost of one ``linear`` call through K18 and through cuBLAS on the
    dense weight."""
    from ao_tpu_torch.ops.hopper import bsr_matmul as k18
    from ao_tpu_torch.ops.linear import linear
    from ao_tpu_torch.quantization.primitives import compute_error
    from ao_tpu_torch.sparsity.blocksparse import BlockSparseArray
    from ao_tpu_torch.utils.timing import cuda_time_ms

    rows = {}
    gen = torch.Generator(device=DEV).manual_seed(seed + 40)
    for m, k, n, b, keep, path in K18_SHAPES:
        w = (torch.randn((k, n), generator=gen, device=DEV) * k ** -0.5).to(torch.bfloat16)
        bw = BlockSparseArray.from_hp(w, b, keep)
        x = torch.randn((m, k), generator=gen, device=DEV).to(torch.bfloat16)
        got = k18.bsr_matmul(x, bw)
        ref = k18.bsr_matmul_plain(x, bw)
        torch.cuda.synchronize()
        sqnr = float(compute_error(ref, got))
        shape = f"M={m} K={k} N={n} b={b} keep={keep} nnz={bw.nnz_blocks}"
        fails.check(bool(torch.isfinite(got).all()) and sqnr >= K18_SQNR_DB,
                    f"K18 bsr_matmul {shape}: sqnr {sqnr:.2f} dB < {K18_SQNR_DB}")
        launch = lambda: k18._launch(x, bw)  # noqa: E731
        ms = cuda_time_ms(launch, iters=20)
        plain_ms = cuda_time_ms(lambda: k18.bsr_matmul_plain(x, bw), iters=5, warmup=1)
        n_dev = device_kernels(torch, launch)
        desc = f"{n_dev} device kernel(s) a call"
        plan = getattr(k18, "launch_plan", None)  # None in a checkout that predates it
        if plan is not None:
            fails.check(n_dev == 1, f"K18 bsr_matmul {shape}: {n_dev} device kernels a call")
            sms = torch.cuda.get_device_properties(DEV).multi_processor_count
            desc += (", plan (splits, ctas, m_tiles, items) "
                     f"{tuple(plan(m, n, b, bw.nnz_blocks, sms))}")
        w_dq = bw.dequantize(torch.bfloat16)
        library_ms = cuda_time_ms(lambda: torch.matmul(x, w_dq), iters=20)
        sparse_ms, note = torch_bsr_ms(torch, x, w_dq, b, got)
        sparse = "not timed" if sparse_ms is None else f"{sparse_ms:.4f} ms"
        print(f"K18 {shape}: torch.sparse BSR x dense (bf16) {sparse}, {note}", flush=True)
        if path is not None:
            x3 = x.reshape(VITL_BATCH, -1, k)
            print(f"K18 {shape}: host per linear call, K18 {host_us(torch, lambda: linear(x3, bw)):.1f}"
                  f" us, cuBLAS on the dense weight {host_us(torch, lambda: linear(x3, w_dq)):.1f} us",
                  flush=True)
        nbytes, flops = k18.traffic(m, k, n, b, bw.nnz_blocks)
        rows[(m, k, n, b, keep)] = kernel_row(
            "K18 bsr_matmul", shape, got, ref, f"sqnr {sqnr:.2f} dB (>= {K18_SQNR_DB})", ms,
            plain_ms, library_ms, nbytes, flops, tiles=desc)
    return rows


def vitl_sparse_paths(torch, fails, counters, launches, ips):
    """ViT-L/16 at full width (24 layers), random weights from the seed,
    batch 16 at 224^2 (M = 3152 rows per linear) through ``vit.forward``:
    block-sparse MLPs (BlockSparseWeightConfig(blocksize=64,
    keep_fraction=0.1) on the 48 mlp.w1 / mlp.w2; K18 each), 2:4
    (SemiSparseWeightConfig(), default filter: dequantize + torch.matmul),
    2:4 with int4 values (Sparse24Int4WeightConfig(group_size=128)) and
    bf16. Launch counts exact; BSR logits against the "torch" backend (the
    ragged route) at 30 dB; 2:4 logits against the dense forward on the
    dequantized weights, equal or at 60 dB. The four forwards are then timed
    in turns (VITL_ROUNDS rounds, the order reversed every other round, as
    the host's clock drifts between phases), images/s from each one's
    median, and profiled once each."""
    import ao_tpu_torch
    from ao_tpu_torch.models import vit
    from ao_tpu_torch.ops import kernels
    from ao_tpu_torch.quantization.primitives import compute_error
    from ao_tpu_torch.quantization.qarrays.base import QuantizedArray

    cfg = vit.VIT_L16
    gen = torch.Generator(device=DEV).manual_seed(SEED + 32)
    params = vit.init_params(cfg, gen, device=DEV)
    images = torch.randn((VITL_BATCH, cfg.image_size, cfg.image_size, 3), generator=gen,
                         device=DEV)

    def mlp_only(fqn, leaf):
        return fqn.endswith(("mlp.w1", "mlp.w2"))

    def dequantized(tree):
        if isinstance(tree, QuantizedArray):
            return tree.dequantize()
        if isinstance(tree, dict):
            return {k: dequantized(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [dequantized(v) for v in tree]
        return tree

    configs = {"ViT-L/16 BSR": (ao_tpu_torch.BlockSparseWeightConfig(BSR_BLOCK, BSR_KEEP),
                                mlp_only),
               "ViT-L/16 2:4": (ao_tpu_torch.SemiSparseWeightConfig(), None),
               "ViT-L/16 2:4-int4": (ao_tpu_torch.Sparse24Int4WeightConfig(group_size=GROUP),
                                     None)}
    runs = {}
    for tag in SPARSE_PATHS:
        with phase(tag):
            p = params
            if tag in configs:
                p = ao_tpu_torch.sparsify_(params, *configs[tag])
                torch.cuda.synchronize()
            want = {name: 0 for name in counters}
            if tag == "ViT-L/16 BSR":
                want["bsr_matmul"] = 2 * cfg.n_layers

            def run(p=p):
                return vit.forward(p, images, cfg)

            for c in counters.values():
                c.launches = 0
            got = run()
            torch.cuda.synchronize()
            launches[tag] = {name: c.launches for name, c in counters.items()}
            print(f"{tag} launches: {launches[tag]} (want {want})", flush=True)
            fails.check(launches[tag] == want, f"{tag} launch counts {launches[tag]} != {want}")
            fails.check(tuple(got.shape) == (VITL_BATCH, cfg.n_classes)
                        and got.dtype == torch.float32 and bool(torch.isfinite(got).all()),
                        f"{tag}: logits {tuple(got.shape)} {got.dtype} not finite or out of shape")
            if tag == "ViT-L/16 BSR":
                with kernels.backend("torch"):
                    plain = run()
                sqnr = float(compute_error(plain, got))
                print(f"{tag} logits, K18 route vs the ragged route: sqnr {sqnr:.2f} dB "
                      f"(>= {PATH_SQNR_DB})", flush=True)
                fails.check(sqnr >= PATH_SQNR_DB, f"{tag} logits: sqnr {sqnr:.2f} dB")
            elif tag in configs:
                dense = run(dequantized(p))
                same = bool(torch.equal(dense, got))
                sqnr = float(compute_error(dense, got))
                print(f"{tag} logits vs the dense forward on the dequantized weights: "
                      f"{'equal' if same else 'not equal'}, sqnr {sqnr:.2f} dB "
                      f"(equal or >= {SPARSE_EXACT_DB})", flush=True)
                fails.check(same or sqnr >= SPARSE_EXACT_DB, f"{tag} logits: sqnr {sqnr:.2f} dB")
            runs[tag] = run
            del got
            torch.cuda.empty_cache()
    walls = {tag: [] for tag in SPARSE_PATHS}
    for r in range(VITL_ROUNDS):
        for tag in (SPARSE_PATHS if r % 2 == 0 else SPARSE_PATHS[::-1]):
            walls[tag].append(forward_ms(torch, runs[tag]))
    for tag in SPARSE_PATHS:
        print(f"{tag} host wall per forward in turns (ms): "
              + ", ".join(f"{t:.3f}" for t in walls[tag]), flush=True)
        ips[tag] = profile_forward(torch, tag, runs[tag], VITL_BATCH,
                                   wall_ms=statistics.median(walls[tag]))


def tree_bytes(tree) -> int:
    """Bytes of every tensor of a params tree (a quantized container's
    ``nbytes``: its data fields)."""
    import torch

    from ao_tpu_torch.quantization.qarrays.base import QuantizedArray

    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if isinstance(tree, QuantizedArray):
        return tree.nbytes
    return tree.numel() * tree.element_size() if isinstance(tree, torch.Tensor) else 0


def mixtral_models(torch):
    """Mixtral-8x7B at its published widths with random weights from SEED,
    built one layer at a time: each bf16 layer is drawn, quantized with
    int4-WO (kept for all 32 layers) and, for the first MOE_CUT layers, with
    W4A8 and kept in bf16 too, so the cuts are one model. The embedding
    (bf16) is shared; the lm_head is quantized as each config quantizes it.
    Returns (cfg, {"int4-WO", "W4A8", "bf16": params})."""
    import ao_tpu_torch
    from ao_tpu_torch.models import llama

    cfg = llama.LlamaConfig(**MIXTRAL)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    top = llama.init_params(dataclasses.replace(cfg, n_layers=0), gen, device=DEV)
    configs = {"int4-WO": ao_tpu_torch.Int4WeightOnlyConfig(group_size=GROUP),
               "W4A8": ao_tpu_torch.Int8DynamicActivationInt4WeightConfig(group_size=GROUP)}
    models = {tag: ao_tpu_torch.quantize_(top, c) for tag, c in configs.items()}
    models["bf16"] = dict(top)
    for m in models.values():
        m["layers"] = []
    for i in range(cfg.n_layers):
        layer = llama.init_layer(cfg, gen, device=DEV)
        models["int4-WO"]["layers"].append(ao_tpu_torch.quantize_(layer, configs["int4-WO"]))
        if i < MOE_CUT:
            models["W4A8"]["layers"].append(ao_tpu_torch.quantize_(layer, configs["W4A8"]))
            models["bf16"]["layers"].append(layer)
        del layer
    torch.cuda.synchronize()
    return cfg, models


def mixtral_paths(torch, fails, counters, launches, tps, card):
    """The MoE slice's main paths on Mixtral-8x7B widths: greedy
    ``generate`` at batch 8, prompt 128, 64 steps under int4-WO (32 layers:
    K13 magic at decode and at the 2048-row prefill, K1 for the attention
    linears and the lm_head), W4A8 (8 layers: K13 w4a8 at decode, the ragged
    fallback at the prefill, K3 / K4 for the linears) and bf16 (8 layers:
    the ragged dot),
    with exact launch counts; two-layer logits against the plain route; a
    decode-shape MoE FFN under CUDA's sync debug mode; tok/s and profiles;
    then the slot Engine over the 32-layer int4-WO model. Prints the
    phases' peak device memory."""
    import ao_tpu_torch
    from ao_tpu_torch.models import llama
    from ao_tpu_torch.moe.layer import moe_forward

    torch.cuda.reset_peak_memory_stats()
    with phase("Mixtral init and quantize_ (layer by layer)"):
        cfg, models = mixtral_models(torch)
        print(f"model: Mixtral-8x7B widths (mistralai/Mixtral-8x7B-v0.1 config.json), random "
              f"weights (seed {SEED}): int4-WO {cfg.n_layers} layers "
              f"{tree_bytes(models['int4-WO']) / 1e9:.2f} GB, W4A8 {MOE_CUT} layers "
              f"{tree_bytes(models['W4A8']) / 1e9:.2f} GB, bf16 {MOE_CUT} layers "
              f"{tree_bytes(models['bf16']) / 1e9:.2f} GB (the bf16 embedding "
              f"{tree_bytes(models['bf16']['embed']) / 1e9:.2f} GB shared); device memory "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated", flush=True)
    cut = dataclasses.replace(cfg, n_layers=MOE_CUT)
    q_cut = dict(models["int4-WO"], layers=models["int4-WO"]["layers"][:MOE_CUT])
    gen = torch.Generator(device=DEV).manual_seed(SEED + 7)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device=DEV,
                           dtype=torch.int32)

    def want_of(tag, c):
        n, decode = c.n_layers, c.n_layers * (STEPS - 1)
        linears = 4 * n + 1  # wq, wk, wv, wo per layer, and the lm_head
        if tag.startswith("Mixtral int4-WO"):
            # K13 at every decode step and, where the route takes its 8 x
            # 128 x top-2 rows, at the prefill
            prefill = 3 * n if k13_takes_rows()(BATCH * PROMPT * c.top_k_experts) else 0
            return {"int4_wo_magic": linears * STEPS, "decode_attention": decode,
                    "int4_grouped_magic": 3 * decode + prefill}
        if tag.startswith("Mixtral W4A8"):  # the 1024-row prefill requantizes (K4)
            return {"int4_w4a8_matmul": linears * (STEPS - 1),
                    "int4_magic8_requant_int8": linears, "decode_attention": decode,
                    "int4_grouped_w4a8": 3 * decode}
        return {"decode_attention": decode}

    paths = [("Mixtral int4-WO", models["int4-WO"], cfg),
             (f"Mixtral W4A8/{MOE_CUT}L", models["W4A8"], cut),
             (f"Mixtral bf16/{MOE_CUT}L", models["bf16"], cut)]
    with phase(f"Mixtral generate launch counts (int4-WO: {cfg.n_layers} layers; W4A8, "
               f"bf16: {MOE_CUT})"):
        for tag, params, c in paths:
            want = {name: 0 for name in counters}
            want.update(want_of(tag, c))
            for ctr in counters.values():
                ctr.launches = 0
            toks = ao_tpu_torch.generate(params, prompt, c, num_steps=STEPS, max_seq=MAX_SEQ)
            torch.cuda.synchronize()
            got = {name: ctr.launches for name, ctr in counters.items()}
            launches[tag] = got
            print(f"{tag} ({c.n_layers} layers) main path launches: {got} (want {want})",
                  flush=True)
            fails.check(got == want, f"{tag} launch counts {got} != {want}")
            fails.check(toks.shape == (BATCH, STEPS) and toks.dtype == torch.int32
                        and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
                        f"{tag} tokens {tuple(toks.shape)} {toks.dtype} out of shape or range")
    with phase("Mixtral two-layer logits and sync checks"):
        # the router's top-2 is a discrete decision: a bf16-level difference
        # moves a token to another expert at a near tie, so each run takes
        # the plain route's routing, and K13 is also held alone against its
        # plain version in the same route; 2 x 16 prefill rows take K13
        check_logits(torch, fails, models["int4-WO"], cfg, SEED, "Mixtral int4-WO",
                     isolate=k13_as_plain)
        # 8 x 80 rows: K4 for the attention linears and the ragged fallback
        # for the experts at the prefill, K3 and K13 at the decode step
        check_logits(torch, fails, models["W4A8"], cut, SEED, "Mixtral W4A8", batch=BATCH,
                     prompt_len=80, floor_margin_db=FLOOR_MARGIN_DB, isolate=k13_as_plain)
        mcfg = llama._moe_config(cfg)
        x = torch.randn((BATCH, 1, cfg.dim), generator=gen, device=DEV).to(torch.bfloat16)
        for tag, params in models.items():
            moe_forward(params["layers"][0]["mlp"], x, mcfg)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                y = moe_forward(params["layers"][0]["mlp"], x, mcfg)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            fails.check(y.shape == x.shape and bool(torch.isfinite(y).all()),
                        f"Mixtral {tag} MoE FFN under the sync check: {tuple(y.shape)}")
            print(f"Mixtral {tag} MoE FFN at the decode shape ({BATCH} tokens, top-2) ran under "
                  f"torch.cuda.set_sync_debug_mode('error'): no host sync", flush=True)

    cut_tag = f"/{MOE_CUT}L"
    runs = [("Mixtral int4-WO", models["int4-WO"], None, cfg),
            ("Mixtral int4-WO" + cut_tag, q_cut, None, cut),
            ("Mixtral W4A8" + cut_tag, models["W4A8"], None, cut),
            ("Mixtral bf16" + cut_tag, models["bf16"], None, cut)]
    with phase("Mixtral generate tok/s and profiles"):
        tps.update(generate_tok_per_s(torch, ao_tpu_torch.generate, runs, prompt, STEPS))
        print(f"Mixtral generate (B={BATCH}, prompt {PROMPT}, {STEPS} steps, max_seq {MAX_SEQ}; "
              f"{cfg.n_layers} layers, {MOE_CUT} where marked {cut_tag}) on {card}: "
              + ", ".join(f"{tag} {tps[tag]:.1f} tok/s" for tag, *_ in runs)
              + f"; int4-WO / bf16 at {MOE_CUT} layers: "
              f"{tps['Mixtral int4-WO' + cut_tag] / tps['Mixtral bf16' + cut_tag]:.2f}x",
              flush=True)
        for tag, params, kv, c in runs:
            if tag != "Mixtral int4-WO" + cut_tag:
                profile_decode(torch, params, c, prompt, tag, kv_quant=kv)
    del runs, q_cut
    models = {"int4-WO": models["int4-WO"]}
    torch.cuda.empty_cache()
    with phase("Mixtral engine run (slots, bf16 KV)"):
        requests = engine_requests(SEED, cfg.vocab_size)
        launches["Mixtral engine-slots"], _, _ = engine_run(
            torch, fails, models["int4-WO"], cfg, requests, counters, False)
    print(f"Mixtral phases: peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"(torch.cuda.max_memory_allocated) on {card}", flush=True)
    del models
    torch.cuda.empty_cache()


def build_all():
    """Build every source, printing ptxas's register and spill lines."""
    from ao_tpu_torch.ops.hopper import build

    with phase("build"):
        logs = build.build()
        print(f"build: nvcc sm_90a, {len(logs)} of {len(build.SOURCES)} sources compiled into "
              f"{build.BUILD_DIR.relative_to(ROOT)}", flush=True)
        for name, log in logs.items():
            for line in log.splitlines():
                if "Used" in line or "spill" in line:
                    print(f"  {name}: {line.split(':', 1)[-1].strip()}")


def k14_both(torch, fails, seed):
    """K14's rows in both forms, keyed (kind, M, K, N), each row naming its
    kind."""
    return {(kind,) + shape: dict(row, kind=kind) for kind in ("mx", "nv")
            for shape, row in k14_phase(torch, fails, seed, kind).items()}


def k11_tile_cache(torch, card):
    """autotune_int4 at ViT-B's two K11 shapes into a temporary tile cache,
    printed beside the heuristic's tiles and time; the cache is removed and
    the process's cache state restored, so the paths below take the
    heuristic's tiles, as the kernel rows above did."""
    import os
    import shutil
    import tempfile

    from ao_tpu_torch.ops.hopper import autotune
    from ao_tpu_torch.ops.hopper import int4_matmul as k1
    from ao_tpu_torch.utils.timing import cuda_time_ms

    tmp = tempfile.mkdtemp(prefix="ao_tpu_tiles_")
    prev = os.environ.get("AO_TPU_NATIVE_CACHE")
    os.environ["AO_TPU_NATIVE_CACHE"] = tmp
    autotune._CACHE = None
    try:
        dev = torch.device(DEV, torch.cuda.current_device())
        for m, k, n in K11_SHAPES:
            heur = k1.pick_tiles_halves(m, k, n, GROUP, k1._sm_count(dev))
            best, best_us = autotune.autotune_int4(m, k, n, GROUP, iters=20)
            tuned = k1.pick_tiles_halves(m, k, n, GROUP, k1._sm_count(dev))
            x = torch.randn((m, k), device=DEV).to(torch.bfloat16)
            packed = torch.randint(0, 256, (k // 2, n), device=DEV, dtype=torch.int32).to(
                torch.uint8)
            s = torch.full((k // GROUP, n), 0.01, device=DEV, dtype=torch.bfloat16)
            heur_us = 1e3 * cuda_time_ms(lambda: k1._launch_halves(x, packed, s, -8 * s, GROUP,
                                                                   True, heur), iters=20)
            print(f"K11 tile cache (M={m} K={k} N={n}, g {GROUP}) on {card}: autotune_int4 "
                  f"winner (bm, bn, splits) {best} {best_us:.2f} us, the picker now takes "
                  f"{tuned}; heuristic {heur} {heur_us:.2f} us", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if prev is None:
            os.environ.pop("AO_TPU_NATIVE_CACHE", None)
        else:
            os.environ["AO_TPU_NATIVE_CACHE"] = prev
        autotune._CACHE = None


def k8_rows(torch, fails, seed):
    """K8's rows at each shape of K8_SHAPES."""
    return {shape: k8_phase(torch, fails, seed, *shape) for shape in K8_SHAPES}


def k16_rows(torch, fails, seed):
    """K16's rows at each shape of K16_SHAPES."""
    return {shape: k16_phase(torch, fails, seed, *shape) for shape in K16_SHAPES}


def kernels_only(torch, names) -> int:
    """Build, then run only the phases of ``names`` (of K1, K2, K2v, K3, K8,
    K9, K10, K11, K13, K14, K15, K16, K17, K18) and print each one's rows as
    one JSON line."""
    phases = {"K1": k1_phase, "K2": k2_rows, "K2v": k2v_rows, "K3": k3_phase, "K8": k8_rows,
              "K9": k9_rows, "K10": k10_phase, "K11": k11_phase, "K13": k13_phase, "K14": k14_both,
              "K15": k15_phase, "K16": k16_rows, "K17": k17_phase, "K18": k18_phase}
    if not set(names) <= set(phases):
        print(f"chip_smoke: --kernels takes {', '.join(phases)}", file=sys.stderr)
        return 2
    print(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    build_all()
    fails = Failures()
    for name in names:
        with phase(f"kernel {name}"):
            rows = phases[name](torch, fails, SEED)
        print(json.dumps({name: list(rows.values())}), flush=True)
    return 1 if fails else 0


def mixtral_only(torch) -> int:
    """Build, then run only the MoE slice's paths (``mixtral_paths``: launch
    counts, logits, tok/s, profiles with the prefill's device time, and the
    slot engine's TTFT) and print tok/s as one JSON line."""
    from ao_tpu_torch.ops.hopper import decode_attention as k2
    from ao_tpu_torch.ops.hopper import flash_attention as k8
    from ao_tpu_torch.ops.hopper import grouped_matmul as k13
    from ao_tpu_torch.ops.hopper import int4_matmul as k1

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    build_all()
    fails = Failures()
    counters = {"int4_wo_magic": k1.int4_wo_magic, "decode_attention": k2.decode_attention,
                "int4_w4a8_matmul": k1.int4_w4a8_matmul,
                "int4_magic8_requant_int8": k1.int4_magic8_requant_int8,
                "flash_attention": k8.flash_attention,
                "int4_grouped_magic": k13.int4_grouped_magic,
                "int4_grouped_w4a8": k13.int4_grouped_w4a8}
    launches, tps = {}, {}
    mixtral_paths(torch, fails, counters, launches, tps, card)
    print(json.dumps({"tok/s": tps}), flush=True)
    return 1 if fails else 0


def sam_only(torch) -> int:
    """Build, then run only the SAM-B paths (W8A8 and bf16: exact launch
    counts, masks and IoU against the plain route, images/s over three
    forwards and a profile each) and print images/s as one JSON line."""
    from ao_tpu_torch.ops.hopper import fused_act as k12
    from ao_tpu_torch.ops.hopper import window_attention as k16

    print(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    build_all()
    fails = Failures()
    counters = {"window_bias_attention": k16.window_bias_attention,
                "norm_modulate_quant": k12.norm_modulate_quant, "gelu_quant": k12.gelu_quant}
    launches, ips = {}, {}
    with phase("SAM-B paths"):
        sam_paths(torch, fails, counters, launches, ips)
    print(json.dumps({"images/s": ips}), flush=True)
    return 1 if fails else 0


def vitl_only(torch) -> int:
    """Build, then run only the ViT-L/16 sparse paths (BSR through K18, 2:4,
    2:4-int4, bf16: exact launch counts, logits, images/s in turns and a
    profile each) and print images/s as one JSON line."""
    from ao_tpu_torch.ops.hopper import bsr_matmul as k18

    print(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    build_all()
    fails = Failures()
    launches, ips = {}, {}
    with phase("ViT-L/16 sparse paths"):
        vitl_sparse_paths(torch, fails, {"bsr_matmul": k18.bsr_matmul}, launches, ips)
    print(json.dumps({"images/s": ips}), flush=True)
    return 1 if fails else 0


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description="Smoke run of ao_tpu_torch on one NVIDIA GPU.")
    parser.add_argument("--kernels", type=lambda v: v.split(","),
                        help="only these kernels' phases, of K1, K2, K2v, K3, K8, K9, K10, K11, "
                             "K13, K14, K15, K16, K17, K18 (comma-separated)")
    parser.add_argument("--sam", action="store_true",
                        help="only the SAM-B paths (W8A8 and bf16), for images/s")
    parser.add_argument("--vitl", action="store_true",
                        help="only the ViT-L/16 sparse paths (BSR, 2:4, 2:4-int4, bf16)")
    parser.add_argument("--mixtral", action="store_true",
                        help="only the Mixtral-8x7B paths (generate and the slot engine)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.kernels:
        return kernels_only(torch, args.kernels)
    if args.sam:
        return sam_only(torch)
    if args.vitl:
        return vitl_only(torch)
    if args.mixtral:
        return mixtral_only(torch)
    import ao_tpu_torch
    from ao_tpu_torch.models import llama
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

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {kind}; nvidia-smi name, power.limit: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    build_all()

    fails = Failures()
    long_lengths = [T_LONG] * K2_SHAPE["b"]
    with phase("kernels K1-K10, K12s, K14, K15, K17"):
        k1_rows = k1_phase(torch, fails, SEED)
        k2_by_path = k2_rows(torch, fails, SEED)
        kv_rows = {kv: kv_phase(torch, fails, SEED, kv) for kv in KV_ALL}
        kv_rows["k2v-int8"] = kv_phase(torch, fails, SEED, "int8", kernel=K2V_INT8)
        long_rows = {kv: kv_phase(torch, fails, SEED, kv, t=T_LONG, lengths=long_lengths)
                     for kv in KV_ALL}
        long_rows["k2v-int8"] = kv_phase(torch, fails, SEED, "int8", t=T_LONG,
                                         lengths=long_lengths, kernel=K2V_INT8)
        k3_rows = k3_phase(torch, fails, SEED)
        k4_rows = k4_phase(torch, fails, SEED)
        k12_row = k12_phase(torch, fails, SEED)
        k8_by_shape = k8_rows(torch, fails, SEED)
        # K9 in each mode at the engine's decode shape and at T = 4096
        k9_by_mode = k9_rows(torch, fails, SEED)
        # K5-K7 at the slot engine's decode shape, where they launch
        engine_kv_rows = {kv: kv_phase(torch, fails, SEED, kv, t=ENGINE_CFG["max_seq"],
                                       lengths=ENGINE_LENGTHS) for kv in KV_QUANT}
        k10_rows = k10_phase(torch, fails, SEED)
        k17_rows = k17_phase(torch, fails, SEED)
        k14_rows = {kind: k14_phase(torch, fails, SEED, kind) for kind in ("mx", "nv")}
        k15_rows = k15_phase(torch, fails, SEED)
    with phase("kernels K11, K12n, K12g, K16"):
        k11_rows = k11_phase(torch, fails, SEED)
        k11_tile_cache(torch, card)
        k12n_rows = {shape: k12v_phase(torch, fails, SEED, "norm", shape) for shape in K12N_SHAPES}
        k12g_rows = {shape: k12v_phase(torch, fails, SEED, "gelu", shape) for shape in K12G_SHAPES}
        k16_by_shape = k16_rows(torch, fails, SEED)
    with phase("kernel K13"):
        k13_rows = k13_phase(torch, fails, SEED)
    with phase("kernel K18"):
        k18_rows = k18_phase(torch, fails, SEED)

    # -- the main paths: Llama-3-8B widths, int4-WO and W4A8, greedy generate
    cfg = llama.LLAMA3_8B
    cut = dataclasses.replace(cfg, n_layers=CUT_LAYERS)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    with phase("init and quantize_"):
        params = llama.init_params(cfg, gen, device=DEV)
        qparams = ao_tpu_torch.quantize_(params,
                                         ao_tpu_torch.Int4WeightOnlyConfig(group_size=GROUP))
        wparams = ao_tpu_torch.quantize_(
            params, ao_tpu_torch.Int8DynamicActivationInt4WeightConfig(group_size=GROUP))
        torch.cuda.synchronize()
        print(f"model: Llama-3-8B widths, {cfg.n_layers} layers, random weights (seed {SEED})",
              flush=True)
    # the first CUT_LAYERS layers of the same models, with the same embedding
    # and lm_head, for the quantized-KV and the other weight paths
    params_cut = dict(params, layers=params["layers"][:CUT_LAYERS])
    qparams_cut = dict(qparams, layers=qparams["layers"][:CUT_LAYERS])
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device=DEV,
                           dtype=torch.int32)

    counters = {"int4_wo_magic": k1.int4_wo_magic, "decode_attention": k2.decode_attention,
                "int4_w4a8_matmul": k1.int4_w4a8_matmul,
                "int4_magic8_requant_int8": k1.int4_magic8_requant_int8,
                "silu_mul_quant": k12.silu_mul_quant, "flash_attention": k8.flash_attention,
                "paged_decode_attention": k9.paged_decode_attention,
                "paged_decode_attention_vec8": k9.paged_decode_attention_vec8,
                "paged_decode_attention_int4": k9.paged_decode_attention_int4}
    counters.update({name: getattr(k2, name) for name, _, _ in KV_KERNELS.values()})
    counters.update({"int8_wo_matmul": k10.int8_wo_matmul,
                     "fp8_blockwise_matmul": k17.fp8_blockwise_matmul,
                     "mxfp4_wo_matmul": k14.mxfp4_wo_matmul,
                     "nvfp4_wo_matmul": k14.nvfp4_wo_matmul,
                     "lut4_wo_magic": k15.lut4_wo_magic,
                     "int4_wo_matmul": k1.int4_wo_matmul,
                     "norm_modulate_quant": k12.norm_modulate_quant,
                     "gelu_quant": k12.gelu_quant,
                     "window_bias_attention": k16.window_bias_attention,
                     "int4_grouped_magic": k13.int4_grouped_magic,
                     "int4_grouped_w4a8": k13.int4_grouped_w4a8,
                     "bsr_matmul": k18.bsr_matmul})
    with phase("F1"):
        f1_phase(torch, fails, counters)

    def linears(c):  # q, k, v, o, w1, w3, w2 per layer, and the lm_head
        return 7 * c.n_layers + 1

    def decode_attn(c):
        return c.n_layers * (STEPS - 1)

    launches = {}
    paths = [("int4-WO", qparams, None, False, cfg,
              {"int4_wo_magic": linears(cfg) * STEPS, "decode_attention": decode_attn(cfg)}),
             ("W4A8", wparams, None, False, cfg,
              {"decode_attention": decode_attn(cfg),
               "int4_w4a8_matmul": linears(cfg) * (STEPS - 1),
               "int4_magic8_requant_int8": linears(cfg), "silu_mul_quant": cfg.n_layers})]
    paths += [(KV_TAG[kv], qparams_cut, kv, False, cut,
               {"int4_wo_magic": linears(cut) * STEPS, KV_KERNELS[kv][0]: decode_attn(cut)})
              for kv in KV_ALL]
    paths.append(("int4-WO+flash", qparams, None, True, cfg,
                  {"int4_wo_magic": linears(cfg) * STEPS, "decode_attention": decode_attn(cfg),
                   "flash_attention": cfg.n_layers}))
    with phase("generate launch counts (int4-WO, W4A8, +flash: 32 layers; KV: 8)"):
        for tag, qp, kv, flash, c, want in paths:
            want = {name: want.get(name, 0) for name in counters}
            for ctr in counters.values():
                ctr.launches = 0
            toks = ao_tpu_torch.generate(qp, prompt, c, num_steps=STEPS, max_seq=MAX_SEQ,
                                         kv_quant=kv, use_flash=flash)
            torch.cuda.synchronize()
            got = {name: ctr.launches for name, ctr in counters.items()}
            launches[tag] = got
            print(f"{tag} ({c.n_layers} layers) main path launches: {got} (want {want})",
                  flush=True)
            fails.check(got == want, f"{tag} launch counts {got} != {want}")
            fails.check(toks.shape == (BATCH, STEPS) and toks.dtype == torch.int32
                        and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
                        f"{tag} tokens {tuple(toks.shape)} {toks.dtype} out of shape or range")
    with phase("two-layer logits checks"):
        check_logits(torch, fails, qparams, cfg, SEED, "int4-WO")
        # 8 x 80 = 640 prefill rows > 512: the W4A8 cut runs K4, K12 and the
        # int8 GEMM at prefill and K3 at decode
        check_logits(torch, fails, wparams, cfg, SEED, "W4A8", batch=BATCH, prompt_len=80,
                     floor_margin_db=FLOOR_MARGIN_DB)
        for kv in KV_ALL:
            check_logits(torch, fails, qparams, cfg, SEED, KV_TAG[kv], kv_quant=kv,
                         floor_margin_db=FLOOR_MARGIN_DB)
        for kv in (None,) + KV_QUANT:
            check_serving_logits(torch, fails, qparams, cfg, SEED, kv)

    cut_tag = f"/{CUT_LAYERS}L"
    runs = [("W4A8", wparams, None, cfg), ("int4-WO", qparams, None, cfg),
            ("bf16", params, None, cfg), ("int4-WO" + cut_tag, qparams_cut, None, cut),
            ("bf16" + cut_tag, params_cut, None, cut)]
    runs += [(KV_TAG[kv], qparams_cut, kv, cut) for kv in KV_ALL]
    with phase("generate tok/s and profiles"):
        tps = generate_tok_per_s(torch, ao_tpu_torch.generate, runs, prompt, STEPS)
        print(f"generate (B={BATCH}, prompt {PROMPT}, {STEPS} steps, max_seq {MAX_SEQ}; "
              f"{cfg.n_layers} layers, {CUT_LAYERS} where marked {cut_tag} and for the KV paths) "
              f"on {card}: " + ", ".join(f"{tag} {tps[tag]:.1f} tok/s" for tag, *_ in runs),
              flush=True)
        for tag, p, kv, c in runs:
            if not tag.endswith(cut_tag):
                profile_decode(torch, p, c, prompt, tag, kv_quant=kv)

    # -- the int8, fp8, 4-bit float and NF4 weight paths at CUT_LAYERS layers,
    # one quantized model on the card at a time: launch counts and tok/s of
    # one call, tokens, two-layer logits and a profile each, beside the
    # int4-WO and bf16 numbers of the same depth above
    del wparams
    torch.cuda.empty_cache()
    weight_want = {"int8-WO": {"int8_wo_matmul": linears(cut) * STEPS},
                   "W8A8": {"silu_mul_quant": cut.n_layers}, "fp8-row": {},
                   "fp8-block": {"fp8_blockwise_matmul": linears(cut) * STEPS},
                   "MXFP4-WO": {"mxfp4_wo_matmul": linears(cut) * STEPS},
                   "NVFP4-WO": {"nvfp4_wo_matmul": linears(cut) * STEPS},
                   "NVFP4-dyn": {"nvfp4_wo_matmul": linears(cut) * STEPS},
                   "NF4-WO": {"lut4_wo_magic": linears(cut) * STEPS}}
    for tag in WEIGHT_PATHS:
        with phase(f"{tag} ({CUT_LAYERS} layers)"):
            pw = ao_tpu_torch.quantize_(params_cut, weight_config(ao_tpu_torch, tag))
            torch.cuda.synchronize()
            want = {name: 0 for name in counters}
            want.update(weight_want[tag], decode_attention=decode_attn(cut))
            for ctr in counters.values():
                ctr.launches = 0
            t0 = time.perf_counter()
            toks = ao_tpu_torch.generate(pw, prompt, cut, num_steps=STEPS, max_seq=MAX_SEQ)
            torch.cuda.synchronize()
            # tok/s of this call, the model's first: host clock around a call
            # ending in a synchronize, one-time costs (first launches) included
            tps[tag] = BATCH * STEPS / (time.perf_counter() - t0)
            got = {name: ctr.launches for name, ctr in counters.items()}
            launches[tag] = got
            print(f"{tag} ({CUT_LAYERS} layers) main path launches: {got} (want {want})",
                  flush=True)
            fails.check(got == want, f"{tag} launch counts {got} != {want}")
            fails.check(toks.shape == (BATCH, STEPS) and toks.dtype == torch.int32
                        and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
                        f"{tag} tokens {tuple(toks.shape)} {toks.dtype} out of shape or range")
            if tag in ("int8-WO", "MXFP4-WO", "NVFP4-WO", "NF4-WO"):
                check_logits(torch, fails, pw, cut, SEED, tag)
            elif tag == "NVFP4-dyn":
                # fp4 activations: no absolute floor, the kernels held alone
                check_logits(torch, fails, pw, cut, SEED, tag, batch=BATCH, prompt_len=80,
                             floor_margin_db=FLOOR_MARGIN_DB, min_db=0.0, isolate=k14_as_plain)
            else:
                # an activation quantizer on every linear: the calibrated
                # bound; 8 x 80 = 640 prefill rows run W8A8's SwiGLU gate
                # through K12s
                check_logits(torch, fails, pw, cut, SEED, tag, batch=BATCH, prompt_len=80,
                             floor_margin_db=FLOOR_MARGIN_DB)
            print(f"{tag} generate ({CUT_LAYERS} layers, B={BATCH}, prompt {PROMPT}, {STEPS} "
                  f"steps, the launch-count call) on {card}: {tps[tag]:.1f} tok/s (int4-WO"
                  f"{cut_tag} {tps['int4-WO' + cut_tag]:.1f}, bf16{cut_tag} "
                  f"{tps['bf16' + cut_tag]:.1f} in this call)", flush=True)
            profile_decode(torch, pw, cut, prompt, tag)
            linear_scratch(torch, fails, tag, pw["layers"][0]["mlp"]["w1"])
            del pw, toks
            torch.cuda.empty_cache()

    # -- the serving engine: the same requests in both KV layouts, over a
    # bf16 KV and over each quantized KV
    requests = engine_requests(SEED, cfg.vocab_size)
    greedy = [uid for uid, (_, _, kw) in enumerate(requests) if not kw]
    with phase("engine runs"):
        for kv in (None,) + KV_QUANT:
            served = {}
            for paged in (False, True):
                tag = engine_tag(paged, kv)
                launches[tag], served[paged], _ = engine_run(torch, fails, qparams, cfg,
                                                             requests, counters, paged, kv)
            same = sum(a == b for uid in greedy
                       for a, b in zip(served[False].get(uid, []), served[True].get(uid, [])))
            total = sum(len(served[False].get(uid, [])) for uid in greedy)
            print(f"engine, {kv or 'bf16'} KV: the two layouts agree on {same} of {total} "
                  f"greedy tokens ({same / max(total, 1):.1%}; not judged: the routes round "
                  f"differently)", flush=True)
    del params, qparams, params_cut, qparams_cut, paths, runs  # the lists hold the models too
    torch.cuda.empty_cache()

    # -- the vision slice: SAM-B (W8A8, bf16) and ViT-B/16 (int4-WO, bf16)
    ips = {}
    with phase("SAM-B paths"):
        sam_paths(torch, fails, counters, launches, ips)
    with phase("ViT-B/16 paths"):
        vit_paths(torch, fails, counters, launches, ips)
    print(f"vision forwards on {card}: " + ", ".join(f"{tag} {ips[tag]:.2f} images/s"
                                                     for tag in VISION_PATHS), flush=True)

    # -- the sparsity slice: ViT-L/16 with BSR MLPs (K18), 2:4, 2:4-int4, bf16
    with phase("ViT-L/16 sparse paths"):
        vitl_sparse_paths(torch, fails, counters, launches, ips)
    print(f"ViT-L/16 forwards (batch {VITL_BATCH}) on {card}: "
          + ", ".join(f"{tag} {ips[tag]:.2f} images/s" for tag in SPARSE_PATHS), flush=True)

    # -- the MoE slice: Mixtral-8x7B widths, int4-WO, W4A8 and bf16 experts
    mixtral_paths(torch, fails, counters, launches, tps, card)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all", flush=True)

    if fails:
        print(f"chip_smoke: {len(fails)} check(s) failed:", file=sys.stderr)
        for f in fails:
            print(f"  {f}", file=sys.stderr)
        return 1

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    rows = [
        ("int4_wo_magic", "int4_matmul.cu", "int4_matmul.py:372", "int4-WO", k1_rows[K1_REPORTED]),
        ("int4_wo_magic", "int4_matmul.cu", "int4_matmul.py:372", "int4-WO", k1_rows[K1_PREFILL]),
        ("int4_wo_magic", "int4_matmul.cu", "int4_matmul.py:372", "ViT-B/16 int4-WO",
         k1_rows[K1_VIT]),
        ("decode_attention", "decode_attention.cu", "decode_attention.py:234", "int4-WO",
         k2_by_path["generate"]),
        ("int4_w4a8_matmul", "int4_w4a8.cu", "int4_matmul.py:537", "W4A8", k3_rows[KN_REPORTED]),
        ("int4_magic8_requant_int8", "int4_w4a8.cu", "int4_matmul.py:673", "W4A8",
         k4_rows[KN_REPORTED]),
        ("silu_mul_quant", "fused_act.cu", "fused_act.py:171", "W4A8", k12_row),
        ("decode_attention", "decode_attention.cu", "decode_attention.py:234", "engine-slots",
         k2_by_path["engine-slots"]),
        ("decode_attention", "decode_attention.cu", "decode_attention.py:234", "int4-WO",
         k2_by_path["long"]),
    ]
    for kv, ref in zip(KV_ALL, ("decode_attention.py:138", "decode_attention.py:598",
                                "decode_attention.py:471", "decode_attention.py:234")):
        # K2v on the decode mainloop beside K2; K5-K7 in their first design
        src = "decode_attention.cu" if KV_KERNELS[kv][2] == "K2v" else "decode_attention_quant.cu"
        rows += [(KV_KERNELS[kv][0], src, ref, KV_TAG[kv], row)
                 for row in (kv_rows[kv], long_rows[kv])]
    # K2v's int8 form: the same kernel as its e5m2 form, whose path it counts
    rows += [("decode_attention_vec8", "decode_attention.cu", "decode_attention.py:234",
              KV_TAG["float8_e5m2"], row) for row in (kv_rows["k2v-int8"], long_rows["k2v-int8"])]
    rows += [("flash_attention", "flash_attention.cu", "flash_attention.py:94",
              "int4-WO+flash" if shape[0] > 1 else "engine-slots", k8_by_shape[shape])
             for shape in K8_SHAPES]
    rows += [(KV_KERNELS[kv][0], "decode_attention_quant.cu", ref, engine_tag(False, kv),
              engine_kv_rows[kv])
             for kv, ref in zip(KV_QUANT, ("decode_attention.py:138", "decode_attention.py:598",
                                           "decode_attention.py:471"))]
    rows += [("int8_wo_matmul", "int8_matmul.cu", "int8_matmul.py:70", "int8-WO", k10_rows[shape])
             for shape in WEIGHT_REPORTED]
    rows += [("fp8_blockwise_matmul", "fp8_matmul.cu", "fp8_matmul.py:80", "fp8-block",
              k17_rows[shape]) for shape in WEIGHT_REPORTED]
    rows += [(name, "fp4_matmul.cu", "fp4_matmul.py:197", tag, k14_rows[kind][shape])
             for name, kind, tag in (("mxfp4_wo_matmul", "mx", "MXFP4-WO"),
                                     ("nvfp4_wo_matmul", "nv", "NVFP4-WO"))
             for shape in WEIGHT_REPORTED]
    rows += [("lut4_wo_magic", "lut4_matmul.cu", "lut4_matmul.py:186", "NF4-WO", k15_rows[shape])
             for shape in WEIGHT_REPORTED]
    rows += [(POOL_KERNELS[kv], "paged_attention.cu", "paged_attention.py:189",
              engine_tag(True, kv), row) for kv in (None,) + KV_QUANT for row in k9_by_mode[kv]]
    rows += [("int4_wo_matmul", "int4_matmul.cu", "int4_matmul.py:222", "ViT-B/16 int4-WO",
              k11_rows[shape]) for shape in K11_SHAPES]
    rows += [("norm_modulate_quant", "fused_act.cu", "fused_act.py:56", "SAM-B W8A8",
              k12n_rows[shape]) for shape in K12N_SHAPES]
    rows += [("gelu_quant", "fused_act.cu", "fused_act.py:122", "SAM-B W8A8", k12g_rows[shape])
             for shape in K12G_SHAPES]
    rows += [("window_bias_attention", "window_attention.cu", "window_attention.py:126",
              "SAM-B W8A8", k16_by_shape[shape]) for shape in K16_SHAPES]
    rows += [(K13_FORMS[form][0], "grouped_matmul.cu", K13_FORMS[form][1], path,
              k13_rows[(form, t, k, n)]) for form, t, k, n, path in K13_SHAPES]
    rows += [("bsr_matmul", "bsr_matmul.cu", "bsr_matmul.py:25", sh[5], k18_rows[sh[:5]])
             for sh in K18_SHAPES]
    entries = [dict(name=name, route="cuda", source=f"ao_tpu_torch/csrc/{src}",
                    replaces=f"ao_tpu/ops/pallas/{ref}",
                    launches=launches[path][name] if path else 0,
                    **{k: row[k] for k in keys})
               for name, src, ref, path, row in rows]
    print(f"card: {card}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
