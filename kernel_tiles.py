"""Time the decode form of K1 (int4 weight-only), K15 (NF4) or K14 (MXFP4 and
NVFP4) at M = 8 over Llama-3-8B's five widths at every plan of the
weight-stream decode mainloop (warps along N and K and the cluster at four
stages, then the stages of the three fastest); the prefill launches of K10 (int8
weight-only) or K17 (fp8 blockwise) at generate's five M = 1024 shapes over
the same widths, at the tiles each wrapper picks and at every other
unsplit tile it takes; K3 (W4A8) at
decode (M = 8) over the same widths at its plan and every other CTA width
and cluster split; K13's magic form (E = 8, Mixtral's expert widths, a
top-2 routing) at its decode splits (T = 16) and row tiles (T = 256, 1024,
2048); or K2, K2v (over its e5m2 and int8 caches), K5, K6, K7 and K9 (in
each pool mode) on the decode mainloop at every plan (CTAs a stream, positions a
tile, ring stages) at T = 256, 1024 and 4096 with ``chip_smoke.py``'s
lengths there; or K18 (the block-sparse matmul) at ``chip_smoke.py``'s
shapes at each cluster split and CTA count; or K4 (the magic8 -> int8
requantization) at the W4A8 prefill's five (K, N) at its plan; or K12g
(tanh-GELU + int8 row quantize) at SAM-B's rows in each form, with each
form's differences from the plain version over every finite bf16 input;
on one CUDA device; or the host's microseconds a call of K1's, K15's or
K14's public wrappers at M = 8 over the same five widths, in this checkout
or in another one (its ``ao_tpu_torch`` imported in place of this one's), or
K14 there at the plans its wrapper picks (``pick``, trees in turns); or
compare the
SASS of each kernel in two builds, with names and addresses stripped: two
libraries of one source, or two build directories source by source (K3
and K4 in int4_w4a8, K13's two forms in grouped_matmul, K1's prefill and
K11 in int4_matmul, K15's prefill in lut4_matmul, ...).

    python3 kernel_tiles.py time K1  # or K15, K14, K10, K17, K3, K4, K12g, K13, K2, K2v, K5, K6, K7, K9, K18
    python3 kernel_tiles.py host K1 [TREE]  # or K15, K14; TREE another checkout's root
    python3 kernel_tiles.py pick K14 [TREE]  # K14 at M = 8 at its picked plans, TREE's code
    python3 kernel_tiles.py sass LIB_A LIB_B  # two builds' lib<source>-*.so
    python3 kernel_tiles.py sass BUILD_A BUILD_B  # two ao_tpu_torch/_build directories

Run in a copy of the tree with a kernel changed and in this one, in turns
on one card, ``time`` sets the variant beside the kernel; ``sass`` on the
two copies' libraries (``ao_tpu_torch/_build/``) shows whether a change to
a shared header moved another kernel's code.
"""

from __future__ import annotations

import argparse
import difflib
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
M_PREFILL = 1024  # generate's prefill: batch 8 x prompt 128
LLAMA_KN = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256)]


def time_tiles(kernel: str) -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_tiles: no CUDA device; times come only from a card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from ao_tpu_torch.ops.act_quant import quantize_activation
    from ao_tpu_torch.ops.hopper import fp8_matmul as k17
    from ao_tpu_torch.ops.hopper import int8_matmul as k10
    from ao_tpu_torch.quantization.qarrays.common import ActQuantSpec
    from ao_tpu_torch.quantization.qarrays.float8 import Float8Array
    from ao_tpu_torch.quantization.qarrays.int8 import Int8Array
    from ao_tpu_torch.utils.timing import cuda_time_ms

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"card: {torch.cuda.get_device_name(dev)}", flush=True)
    if kernel in ("K2", "K2v", "K5", "K6", "K7", "K9"):
        time_decode(torch, cuda_time_ms, dev, kernel)
        return 0
    if kernel == "K18":
        time_k18(torch, cuda_time_ms, dev, sms)
        return 0
    if kernel in ("K1", "K15", "K14"):
        time_gemv(torch, cuda_time_ms, dev, sms, kernel)
        return 0
    if kernel in ("K3", "K4", "K12g", "K13"):
        {"K3": time_k3, "K4": time_k4, "K12g": time_k12g, "K13": time_k13}[kernel](
            torch, cuda_time_ms, dev, sms)
        return 0
    gen = torch.Generator(device=dev).manual_seed(0)
    mod = k10 if kernel == "K10" else k17
    m = M_PREFILL
    for k, n in LLAMA_KN:
        w = (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5).to(torch.bfloat16)
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        if kernel == "K10":
            qa = Int8Array.from_hp(w, (k, 1))
            args = (x, qa.qdata, qa.scale)
        else:
            qa = Float8Array.from_hp(w, (128, 128))
            qx, sx, _ = quantize_activation(
                x, ActQuantSpec(dtype="float8_e4m3fn", granularity="per_group:128"))
            args = (qx, sx, qa.qdata, qa.scale)
        del w
        picked = tuple(mod.pick_tiles(m, k, n, sms)[:3])
        tiles = [picked] + sorted({t for t in mod.candidate_tiles(m, k, n)
                                   if t[2] == 1 and t != picked}, reverse=True)
        times = []
        for t in tiles:
            us = 1e3 * cuda_time_ms(lambda: mod._launch(*args, tiles=t), iters=20)
            times.append(f"{t} {us:.1f} us" + (" (picked)" if t == picked else ""))
        print(f"{kernel} M={m} K={k} N={n}: " + ", ".join(times), flush=True)
        del qa, args
        torch.cuda.empty_cache()
    return 0


def time_k3(torch, cuda_time_ms, dev, sms) -> None:
    """K3 at M = 8 over LLAMA_KN: the plan ``w4a8_plan`` picks, then the
    others of 1-8 warps along K and clusters of 1-8 CTAs."""
    from ao_tpu_torch.ops.act_quant import quantize_activation
    from ao_tpu_torch.ops.hopper import int4_matmul as k1
    from ao_tpu_torch.quantization.configs import Int8DynamicActivationInt4WeightConfig
    from ao_tpu_torch.quantization.quantize import quantize_

    gen = torch.Generator(device=dev).manual_seed(0)
    g, m = 128, 8
    for k, n in LLAMA_KN:
        w = (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5).to(torch.bfloat16)
        qa = quantize_({"w": w}, Int8DynamicActivationInt4WeightConfig(group_size=g))["w"]
        del w
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        xq, sx, _ = quantize_activation(x, qa.act_quant)
        pairs = k // (2 * g)
        picked = k1.w4a8_plan(m, k, n, g, sms)
        plans = [picked] + [(wk, sp, -(-pairs // (sp * wk)))
                            for wk in k1.W4A8_K_WARPS for sp in range(1, k1.W4A8_MAX_CLUSTER + 1)
                            if sp * wk <= pairs
                            and (sp - 1) * wk * -(-pairs // (sp * wk)) < pairs
                            and (wk, sp, -(-pairs // (sp * wk))) != picked]
        times = []
        for plan in plans:
            us = 1e3 * cuda_time_ms(lambda: k1._launch_w4a8(xq, sx, qa.qdata, qa.scale,
                                                            qa.zero_point, g, plan), iters=20)
            times.append(f"{plan} {us:.1f} us" + (" (picked)" if plan == picked else ""))
        print(f"K3 M={m} K={k} N={n} (warps along K, splits, pairs a warp): "
              + ", ".join(times),
              flush=True)
        del qa
        torch.cuda.empty_cache()


def time_gemv(torch, cuda_time_ms, dev, sms, kernel) -> None:
    """K1 (int4-WO, g = 128, bf16 tinygemm qparams as the main path sends
    them), K15 (NF4, block 64, the shared codebook) or K14 (MXFP4 and NVFP4,
    each a line) at M = 8 over LLAMA_KN on the decode mainloop: every (wn,
    wk, cluster) at four stages, then every stage count of the three
    fastest of those; each line lists the plans fastest first, the one
    ``gemv_plan`` picks marked, and those the profiler dropped and CUDA
    events timed (host gaps counted) marked "events"."""
    from ao_tpu_torch.ops.hopper import int4_matmul as k1

    gen = torch.Generator(device=dev).manual_seed(0)
    m = 8
    for k, n in LLAMA_KN:
        w = (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5).to(torch.bfloat16)
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        for label, run, picked, candidates in gemv_runs(torch, dev, sms, kernel, w, x):
            time_plans(cuda_time_ms, f"{label} M={m} K={k} N={n}", run, picked, candidates)
        del w, x
        torch.cuda.empty_cache()


def gemv_runs(torch, dev, sms, kernel, w, x):
    """(label, run(plan), the picked plan, candidates(stages)) of each
    decode launch ``time_gemv`` sweeps for ``kernel`` at weight w and x."""
    from ao_tpu_torch.ops.hopper import fp4_matmul as k14
    from ao_tpu_torch.ops.hopper import int4_matmul as k1
    from ao_tpu_torch.ops.hopper import lut4_matmul as k15
    from ao_tpu_torch.quantization.qarrays.int4 import Int4Array
    from ao_tpu_torch.quantization.qarrays.mx import MXArray
    from ao_tpu_torch.quantization.qarrays.nf4 import NF4_CODEBOOK, NF4Array
    from ao_tpu_torch.quantization.qarrays.nvfp4 import NVFP4Array

    (m, k), n = x.shape, w.shape[1]
    if kernel == "K14":
        mx = MXArray.from_hp(w, elem_dtype="float4_e2m1fn")
        nv = NVFP4Array.from_hp(w)
        pts = nv.per_tensor_scale.to(torch.float32).reshape(())
        for label, kind, qa, p in (("K14 mx", k14.MX, mx, None), ("K14 nv", k14.NV, nv, pts)):
            yield (label,
                   lambda plan, kind=kind, qa=qa, p=p, label=label: k14._launch(
                       kind, x, qa.qdata, qa.scale, p, label, plan=plan),
                   k14.gemv_plan(m, k, n, sms),
                   lambda stages, kind=kind: k14.gemv_candidates(m, k, n, kind, stages=stages))
        return
    if kernel == "K1":
        g, qa = 128, Int4Array.from_hp(w, group_size=128)
        args, setup = (x, qa.qdata, qa.scale, qa.zero_point, g, True), 0
        launch = k1._launch
    else:
        g, qa = 64, NF4Array.from_hp(w, 64)
        lut = NF4_CODEBOOK.to(dev).to(torch.bfloat16)
        args, setup = (x, qa.qdata, qa._scalers(), lut, g), k15.gemv_tables(0)[1]
        launch = k15._launch
    yield (kernel, lambda plan: launch(*args, plan=plan), k1.gemv_plan(m, k, n, g, sms),
           lambda stages: k1.gemv_candidates(m, k, n, g, setup, stages=stages))


def time_plans(cuda_time_ms, label, run, picked, candidates) -> None:
    """One line of ``time_gemv``: every plan of candidates((4,)), then the
    stage counts of the three fastest, fastest first."""
    from ao_tpu_torch.utils import timing

    times, events = {}, set()

    def timed(plans):
        for plan in plans:
            if plan not in times:
                before = timing.EVENT_FALLBACKS
                times[plan] = 1e3 * cuda_time_ms(lambda: run(plan), iters=20)
                if timing.EVENT_FALLBACKS != before:
                    events.add(plan)

    timed([picked] + candidates((4,)))
    best = sorted(times, key=times.get)[:3]
    timed([p for p in candidates((2, 3, 4, 6)) if p[:3] in {b[:3] for b in best}])
    order = sorted(times, key=times.get)
    print(f"{label} (wn, wk, cluster, stages), {len(order)} plans: "
          + ", ".join(f"{p} {times[p]:.1f} us" + (" (picked)" if p == picked else "")
                      + (" (events)" if p in events else "") for p in order), flush=True)


def host_us(kernel: str, tree: str) -> int:
    """The host's microseconds a call of K1's (int4-WO, g = 128, bf16
    tinygemm qparams), K15's (NF4, block 64) or K14's (MXFP4 and NVFP4, a
    line each) public wrapper at M = 8 over
    LLAMA_KN, with the ``ao_tpu_torch`` of checkout ``tree``: 20 calls to
    warm up, then 40 rounds of 25 calls issued without a synchronize (the
    launch queue does not fill); the median round and the fastest, which a
    host that other work shares inflates least (the process's CPU clock
    ticks too coarsely here to time a round)."""
    import time

    import torch

    if not torch.cuda.is_available():
        print("kernel_tiles: no CUDA device; times come only from a card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(tree).resolve()))
    from ao_tpu_torch.ops.hopper import fp4_matmul as k14
    from ao_tpu_torch.ops.hopper import int4_matmul as k1
    from ao_tpu_torch.ops.hopper import lut4_matmul as k15
    from ao_tpu_torch.quantization.qarrays.int4 import Int4Array
    from ao_tpu_torch.quantization.qarrays.mx import MXArray
    from ao_tpu_torch.quantization.qarrays.nf4 import NF4_CODEBOOK, NF4Array
    from ao_tpu_torch.quantization.qarrays.nvfp4 import NVFP4Array

    dev = torch.device("cuda")
    print(f"card: {torch.cuda.get_device_name(dev)}; tree {Path(k1.__file__).parents[3]}",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    lut = NF4_CODEBOOK.to(dev).to(torch.bfloat16)
    for k, n in LLAMA_KN:
        w = (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5).to(torch.bfloat16)
        x = torch.randn((8, k), generator=gen, device=dev).to(torch.bfloat16)
        calls = []
        if kernel == "K1":
            qa = Int4Array.from_hp(w, group_size=128)
            calls.append((kernel, lambda: k1.int4_wo_magic(x, qa.qdata, qa.scale, qa.zero_point,
                                                           128, qa.zero_point_domain)))
        elif kernel == "K15":
            qa = NF4Array.from_hp(w, 64)
            scalers = qa._scalers()
            calls.append((kernel, lambda: k15.lut4_wo_magic(x, qa.qdata, scalers, lut, 64)))
        else:
            mx = MXArray.from_hp(w, elem_dtype="float4_e2m1fn")
            nv = NVFP4Array.from_hp(w)
            calls.append(("K14 mx", lambda: k14.mxfp4_wo_matmul(x, mx.qdata, mx.scale)))
            calls.append(("K14 nv", lambda: k14.nvfp4_wo_matmul(x, nv.qdata, nv.scale,
                                                                nv.per_tensor_scale)))
        del w
        for label, call in calls:
            for _ in range(20):
                call()
            torch.cuda.synchronize()
            rounds = []
            for _ in range(40):
                t0 = time.perf_counter()
                for _ in range(25):
                    call()
                rounds.append((time.perf_counter() - t0) / 25 * 1e6)
                torch.cuda.synchronize()
            rounds.sort()
            print(f"{label} M=8 K={k} N={n}: host us a call, median {rounds[20]:.2f}, "
                  f"fastest {rounds[0]:.2f}", flush=True)
        del calls
        torch.cuda.empty_cache()
    return 0


def pick_us(tree: str, m: int = 8) -> int:
    """K14 (MX and NV, a random weight from seed 0 quantized as the paths
    do) at M = ``m`` over LLAMA_KN at the plans its wrapper picks, with the
    ``ao_tpu_torch`` of checkout ``tree``: one line of µs a call (50 timed
    calls each), a width marked where the result misses the card's bound
    against the plain version. Run in turns over trees (a parent, variants)
    to compare them on one card."""
    import torch

    if not torch.cuda.is_available():
        print("kernel_tiles: no CUDA device; times come only from a card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(tree).resolve()))
    from ao_tpu_torch.ops.hopper import fp4_matmul as k14
    from ao_tpu_torch.quantization.primitives import compute_error
    from ao_tpu_torch.quantization.qarrays.mx import MXArray
    from ao_tpu_torch.quantization.qarrays.nvfp4 import NVFP4Array
    from ao_tpu_torch.utils.timing import cuda_time_ms

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"mx": [], "nv": []}
    for k, n in LLAMA_KN:
        w = (torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5).to(torch.bfloat16)
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        for kind, qa in (("mx", MXArray.from_hp(w, elem_dtype="float4_e2m1fn")),
                         ("nv", NVFP4Array.from_hp(w))):
            if kind == "mx":
                args = (k14.MX, x, qa.qdata, qa.scale, None, "mx")
                ref = k14.mxfp4_wo_matmul_plain(x, qa.qdata, qa.scale)
            else:
                pts = qa.per_tensor_scale.to(torch.float32).reshape(())
                args = (k14.NV, x, qa.qdata, qa.scale, pts, "nv")
                ref = k14.nvfp4_wo_matmul_plain(x, qa.qdata, qa.scale, qa.per_tensor_scale)
            got = k14._launch(*args)
            torch.cuda.synchronize()
            sqnr = float(compute_error(ref, got))
            us = 1e3 * cuda_time_ms(lambda: k14._launch(*args), iters=50)
            bad = sqnr <= (60 if kind == "mx" else 35)
            out[kind].append(f"{us:.1f}" + (f" (sqnr {sqnr:.1f} dB)" if bad else ""))
        del w, x
        torch.cuda.empty_cache()
    print(f"{Path(k14.__file__).parents[3]} M={m} mx " + " / ".join(out["mx"]) + " | nv "
          + " / ".join(out["nv"]), flush=True)
    return 0


def time_k4(torch, cuda_time_ms, dev, sms) -> None:
    """K4 at g = 128 over LLAMA_KN (a random weight quantized as the W4A8
    linear does it), with ``requant_plan``'s CTAs where the checkout has
    one (not its first design)."""
    from ao_tpu_torch.ops.hopper import int4_matmul as k34
    from ao_tpu_torch.ops.linear import _requant_scale
    from ao_tpu_torch.quantization.configs import Int8DynamicActivationInt4WeightConfig
    from ao_tpu_torch.quantization.quantize import quantize_

    gen = torch.Generator(device=dev).manual_seed(0)
    g = 128
    for k, n in LLAMA_KN:
        w = (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5).to(torch.bfloat16)
        qa = quantize_({"w": w}, Int8DynamicActivationInt4WeightConfig(group_size=g))["w"]
        del w
        a, b = k34.requant_rows(*_requant_scale(qa))
        plan = (f"{k34.requant_plan(k, n)} CTAs" if hasattr(k34, "requant_plan")
                else "no plan")
        us = 1e3 * cuda_time_ms(lambda: k34._launch_requant(qa.qdata, a, b, g), iters=20)
        print(f"K4 K={k} N={n} ({plan}): {us:.1f} us", flush=True)
        del qa, a, b
        torch.cuda.empty_cache()


def bf16_sweep(torch, dev):
    """Every finite bf16 value (65280: NaN and +-inf left out), in the order
    of their bit patterns."""
    x = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    return x[torch.isfinite(x.float())].to(dev)


def time_k12g(torch, cuda_time_ms, dev, sms) -> None:
    """K12g at SAM-B's windowed and global rows (bf16, about 2 * randn +
    0.5) in each form it takes there: the one ``gelu_form`` picks, then the
    block kernel; then, for each form, the codes and scales that differ
    from the plain version over every finite bf16 input, each value in a
    row of its own (the row's scale is max(|GELU(x)|, 1e-8) / 127: the
    kernel's GELU value). In a checkout without forms, its one launch."""
    import chip_smoke as smoke
    from ao_tpu_torch.ops.hopper import fused_act as k12

    forms = list(getattr(k12, "GELU_FORMS", ()))  # ("warps", "block")
    gen = torch.Generator(device=dev).manual_seed(0)
    for shape in smoke.K12G_SHAPES:
        x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(torch.bfloat16)
        if not forms:
            us = 1e3 * cuda_time_ms(lambda: k12._launch_gelu(x), iters=20)
            print(f"K12g {shape} (one form): {us:.1f} us", flush=True)
            continue
        picked = k12.gelu_form(shape[-1])
        times = []
        for form in forms:
            us = 1e3 * cuda_time_ms(lambda: k12._launch_gelu(x, form), iters=20)
            times.append(f"{form} {us:.1f} us" + (" (picked)" if form == picked else ""))
        print(f"K12g {shape}: " + ", ".join(times), flush=True)
    d = smoke.K12G_SHAPES[0][-1]
    x = bf16_sweep(torch, dev)[None, :, None].expand(1, -1, d).contiguous()
    qr, sr = k12.gelu_quant_plain(x)
    for form in forms or [None]:
        q, s = k12._launch_gelu(x, form) if form else k12._launch_gelu(x)
        codes = int((q != qr).sum())
        far = int(((q.int() - qr.int()).abs() > 1).sum())
        rel = ((s - sr).abs() / sr)[:, :, 0]
        worst = int(rel.argmax())
        print(f"K12g {form or 'its one form'} over every finite bf16 value ({x.shape[1]} rows "
              f"of {d}): {codes} codes differ ({far} by more than 1 LSB), "
              f"{int((rel > 0).sum())} scales differ, {int((rel > 1e-6).sum())} by more than "
              f"1e-6, the most {float(rel.max()):.3g} at x = {float(x[0, worst, 0]):.6g}",
              flush=True)


def time_k13(torch, cuda_time_ms, dev, sms) -> None:
    """K13's magic form at Mixtral's expert widths (E = 8) over a top-2
    routing: the decode kernel at T = 16 at every K split up to a cluster of
    8, the row tiles at T = 256, 1024 and 2048 at both tiles."""
    from ao_tpu_torch.ops.hopper import grouped_matmul as k13
    from ao_tpu_torch.quantization.qarrays.int4 import Int4Array

    gen = torch.Generator(device=dev).manual_seed(0)
    g, e = 128, 8
    for k, n in ((4096, 14336), (14336, 4096)):
        w = torch.randn((e, k, n), generator=gen, device=dev, dtype=torch.bfloat16) * k ** -0.5
        qa = Int4Array.from_hp(w, group_size=g)
        del w
        nsg = k // (4 * g)
        for t in (16, 256, 1024, 2048):
            x = torch.randn((t, k), generator=gen, device=dev).to(torch.bfloat16)
            idx = torch.topk(torch.randn((t // 2, e), generator=gen, device=dev), 2).indices
            gs = torch.bincount(idx.reshape(-1), minlength=e).to(torch.int32)
            if t <= k13.DECODE_MAX_T:
                picked = k13.decode_plan(k, n, e, g, sms)
                plans = [picked] + [(sp, -(-nsg // sp)) for sp in range(1, k13.MAX_CLUSTER + 1)
                                    if -(-nsg // -(-nsg // sp)) == sp
                                    and (sp, -(-nsg // sp)) != picked]
            else:
                picked = k13.pick_bm(t, e)
                plans = [picked] + [bm for bm in k13.ROW_TILES if bm != picked]
            times = []
            for plan in plans:
                us = 1e3 * cuda_time_ms(lambda: k13._launch_magic(
                    x, qa.qdata, qa.scale, qa.zero_point, gs, g, True, plan), iters=20)
                times.append(f"{plan} {us:.1f} us" + (" (picked)" if plan == picked else ""))
            print(f"K13 magic T={t} K={k} N={n} (splits, super-groups a split, or the row "
                  f"tile): " + ", ".join(times), flush=True)
        del qa
        torch.cuda.empty_cache()


# K18 beside chip_smoke.py's shapes: few items with runs of 8-32 blocks,
# where ``launch_plan`` splits a run over a cluster, and of 4
K18_SPLIT_SHAPES = [(64, 4096, 1024, 128, None), (64, 4096, 1024, 128, 0.25),
                    (1, 4096, 1024, 128, None), (64, 1024, 1024, 128, 0.5),
                    (16, 4096, 4096, 64, 0.25)]


def time_k18(torch, cuda_time_ms, dev, sms) -> None:
    """K18 at each of ``chip_smoke.py``'s shapes and K18_SPLIT_SHAPES (a
    random bf16 weight made block-sparse from the seed): the plan
    ``launch_plan`` picks, then, unsplit, one CTA an SM, one CTA an item and
    two CTAs an SM, and clusters of 2 and 4 splitting each item's run."""
    import chip_smoke as smoke
    from ao_tpu_torch.ops.hopper import bsr_matmul as k18
    from ao_tpu_torch.sparsity.blocksparse import BlockSparseArray

    gen = torch.Generator(device=dev).manual_seed(0)
    for m, k, n, b, keep in [s[:5] for s in smoke.K18_SHAPES] + K18_SPLIT_SHAPES:
        w = (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5).to(torch.bfloat16)
        bw = BlockSparseArray.from_hp(w, b, keep)
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        picked = k18.launch_plan(m, n, b, bw.nnz_blocks, sms)
        one = k18.launch_plan(m, n, b, bw.nnz_blocks, sms, splits=1)
        plans = [picked, one._replace(ctas=min(one.items, sms)), one._replace(ctas=one.items),
                 one] + [k18.launch_plan(m, n, b, bw.nnz_blocks, sms, splits=s)
                         for s in (2, 4) if s <= k18.MAX_SPLIT[b]]
        times = []
        for plan in dict.fromkeys(plans):
            us = 1e3 * cuda_time_ms(lambda: k18._launch(x, bw, plan), iters=20)
            times.append(f"(splits {plan.splits}, ctas {plan.ctas}) {us:.1f} us"
                         + (" (picked)" if plan == picked else ""))
        print(f"K18 M={m} K={k} N={n} b={b} keep={keep} nnz={bw.nnz_blocks} "
              f"items={picked.items}: " + ", ".join(times), flush=True)
        torch.cuda.empty_cache()


def time_decode(torch, cuda_time_ms, dev, kernel) -> None:
    """K2 (bf16 cache), K2v (its e5m2 and int8 caches), K5 (int8 cache, q
    quantized), K6 (fp8 e4m3 cache), K7 (int4 cache) or K9 (pages of 128
    rows, shuffled, in each pool mode) at Llama-3-8B's decode shape, B = 8,
    H = 32, Hkv = 8, at T = 256 (generate's ragged lengths), 1024 (the
    engine's) and 4096 (all valid): the plan ``launch_plan`` picks, then
    every other one of the mainloop. In a checkout whose K5, K6 or K7 has no
    plan (its first design), its one launch."""
    import chip_smoke as smoke
    from ao_tpu_torch.ops.hopper import decode_attention as k2
    from ao_tpu_torch.ops.hopper import paged_attention as k9
    from ao_tpu_torch.serving.kvcache import QuantKVCache
    from ao_tpu_torch.serving.paged import PagedKVPool

    b, h, hkv, d = (smoke.K2_SHAPE[key] for key in ("b", "h", "hkv", "d"))
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((b, h, d), generator=gen, device=dev).to(torch.bfloat16)
    cases = ((smoke.K2_SHAPE["t"], smoke.K2_LENGTHS),
             (smoke.ENGINE_CFG["max_seq"], smoke.ENGINE_LENGTHS),
             (smoke.T_LONG, [smoke.T_LONG] * b))
    pools = {"K2": ("bf16",), "K2v": ("float8_e5m2", "int8"), "K5": ("int8",),
             "K6": ("float8_e4m3fn",), "K7": ("int4",), "K9": ("bf16",) + smoke.KV_QUANT}[kernel]
    kind = {"K2v": "v8", "K5": "i8", "K6": "f8", "K7": "i4"}.get(kernel)
    planned = kind is None or kind in getattr(k2, "_RING", {})
    for dtype_name in pools:
        for t, lengths in cases:
            lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
            direct = False
            if kernel == "K2":
                kc, vc = (torch.randn((b, t, hkv, d), generator=gen, device=dev)
                          .to(torch.bfloat16) for _ in range(2))
                picked = k2.launch_plan(q.shape, kc.shape)
                plan_of = lambda **kw: k2.launch_plan(q.shape, kc.shape, **kw)  # noqa: E731
                run = lambda plan: k2._launch(q, kc, vc, lens, d ** -0.5, plan)  # noqa: E731
                row_bytes = k2.ROW_BYTES
            elif kind is not None:
                ck, cv = (QuantKVCache.create(b, t, hkv, d, dtype_name, device=dev).update(
                    torch.randn((b, t, hkv, d), generator=gen, device=dev), 0) for _ in range(2))
                args = (q, ck.qdata, ck.scale, cv.qdata, cv.scale, lens, d ** -0.5)
                if not planned:
                    us = 1e3 * cuda_time_ms(lambda: k2._launch_quant(kind, *args), iters=20)
                    print(f"{kernel} {dtype_name} T={t} (no plan): {us:.1f} us", flush=True)
                    continue
                picked = k2.launch_plan_quant(kind, q.shape, ck.qdata.shape)
                plan_of = lambda **kw: k2.launch_plan_quant(  # noqa: E731
                    kind, q.shape, ck.qdata.shape, **kw)
                run = lambda plan: k2._launch_quant(kind, *args, plan)  # noqa: E731
                row_bytes, direct = k2._RING[kind]
            else:
                pages = t // smoke.PAGE
                kp, vp = (PagedKVPool.create(b * pages + 1, smoke.PAGE, hkv, d, dtype_name,
                                             device=dev) for _ in range(2))
                for pool in (kp, vp):
                    pool.write_prompt(torch.randn((pool.pages.shape[0] * smoke.PAGE, hkv, d),
                                                  generator=gen, device=dev),
                                      torch.arange(pool.pages.shape[0], device=dev))
                perm = torch.randperm(b * pages, generator=torch.Generator().manual_seed(t)) + 1
                table = perm.reshape(b, pages).to(torch.int32).to(dev)
                for i, n in enumerate(lengths):
                    table[i, -(-n // smoke.PAGE):] = 0
                args = (q, kp.pages, kp.scale, vp.pages, vp.scale, table, lens, d ** -0.5)
                picked = k9.launch_plan(q.shape, kp.pages.shape, pages, kp.pages.dtype)
                plan_of = lambda **kw: k9.launch_plan(q.shape, kp.pages.shape, pages,  # noqa: E731
                                                      kp.pages.dtype, **kw)
                run = lambda plan: k9._launch(*args, plan)  # noqa: E731
                row_bytes = k9._ROW_BYTES[kp.pages.dtype]
            stages = k2.DIRECT_STAGES if direct else k2.STAGES
            plans = [picked] + [plan_of(splits=sp, rows=rows, stages=st) for sp in k2.SPLITS
                                for rows in k2.TILE_ROWS for st in stages
                                if (sp, rows, st) != picked[:3]
                                and k2.smem_bytes(rows, st, row_bytes, direct) <= k2.SMEM_MAX]
            times = []
            for plan in plans:
                us = 1e3 * cuda_time_ms(lambda: run(plan), iters=20)
                times.append(f"{tuple(plan[:3])} {us:.1f} us" + (" (picked)" if plan == picked
                                                                   else ""))
            print(f"{kernel} {dtype_name} T={t} (splits, rows, stages): " + ", ".join(times),
                  flush=True)
            torch.cuda.empty_cache()


def _sass(lib: str):
    """{kernel name, anonymous-namespace tags stripped: its instructions,
    addresses and encodings stripped} of a built library."""
    sys.path.insert(0, str(ROOT))
    from ao_tpu_torch.ops.hopper import build

    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", lib], capture_output=True, text=True,
                         check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+", "ANON", found.group(1))
            funcs[name] = []
            continue
        ins = re.sub(r"/\*[0-9a-f]{4,}\*/|/\* 0x[0-9a-f]+ \*/", "", line).strip()
        if name is not None and ins:
            funcs[name].append(ins)
    return funcs


def _libs(path: str):
    """{source: library} of a build directory (its newest lib<source>-*.so
    each), or {name: path} of one library."""
    p = Path(path)
    if p.is_file():
        return {p.name.split("-")[0]: p}
    libs = {}
    for lib in sorted(p.glob("lib*-*.so"), key=lambda f: f.stat().st_mtime):
        libs[lib.name[3:].rsplit("-", 1)[0]] = lib
    return libs


def compare_sass(path_a: str, path_b: str) -> int:
    """Each kernel's SASS in two builds: two libraries of one source, or
    every source two build directories both hold."""
    libs_a, libs_b = _libs(path_a), _libs(path_b)
    if Path(path_a).is_file() and Path(path_b).is_file():
        pairs = [(Path(path_a).name, libs_a.popitem()[1], libs_b.popitem()[1])]
    else:
        pairs = [(src, libs_a[src], libs_b[src]) for src in sorted(libs_a.keys() & libs_b.keys())]
    worst = 0
    for src, lib_a, lib_b in pairs:
        a, b = _sass(str(lib_a)), _sass(str(lib_b))
        same = sorted(n for n in a.keys() & b.keys() if a[n] == b[n])
        differ = sorted(n for n in a.keys() & b.keys() if a[n] != b[n])
        only = sorted(a.keys() ^ b.keys())
        print(f"{src}: SASS of {len(same)} kernels identical, {len(differ)} differ, "
              f"{len(only)} in one build only")
        for n in differ:
            changed = [ln for ln in difflib.unified_diff(a[n], b[n], lineterm="", n=0)
                       if ln[:1] in "+-" and ln[:3] not in ("+++", "---")]
            print(f"  differs: {n} ({len(a[n])} against {len(b[n])} instructions, "
                  f"{len(changed)} changed lines)")
        for n in only:
            print(f"  in one build only: {n}")
        worst = max(worst, 1 if differ or only else 0)
    return worst


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("time", help="time a kernel's launch at each tile or plan")
    t.add_argument("kernel", choices=("K1", "K15", "K14", "K10", "K17", "K3", "K4", "K12g", "K13",
                                       "K2", "K2v", "K5", "K6", "K7", "K9", "K18"))
    h = sub.add_parser("host", help="host us a call of K1's, K15's or K14's wrapper at M = 8")
    h.add_argument("kernel", choices=("K1", "K15", "K14"))
    h.add_argument("tree", nargs="?", default=str(ROOT))
    pk = sub.add_parser("pick", help="K14 at M = 8 at its picked plans, in this or another tree")
    pk.add_argument("kernel", choices=("K14",))
    pk.add_argument("tree", nargs="?", default=str(ROOT))
    s = sub.add_parser("sass", help="compare the SASS of two builds: two libraries of one "
                                    "source, or two build directories source by source")
    s.add_argument("lib_a")
    s.add_argument("lib_b")
    args = parser.parse_args()
    if args.cmd == "time":
        return time_tiles(args.kernel)
    if args.cmd == "host":
        return host_us(args.kernel, args.tree)
    if args.cmd == "pick":
        return pick_us(args.tree)
    return compare_sass(args.lib_a, args.lib_b)


if __name__ == "__main__":
    sys.exit(main())
