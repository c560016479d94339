"""Time the prefill launches of K10 (int8 weight-only) or K17 (fp8
blockwise) at generate's five M = 1024 shapes over Llama-3-8B's widths, at
the tiles each wrapper picks and at every other unsplit tile it takes; K3
(W4A8) at decode (M = 8) over the same widths at its plan and every other
CTA width and cluster split; K13's magic form (E = 8, Mixtral's expert
widths, a top-2 routing) at its decode splits (T = 16) and row tiles (T =
256, 1024, 2048); or K2, K2v (over its e5m2 and int8 caches) and K9 (in
each pool mode) on the decode mainloop at every plan (CTAs a stream,
positions a tile, ring stages) at T = 256, 1024 and 4096 with
``chip_smoke.py``'s lengths there; or K18 (the block-sparse matmul) at
``chip_smoke.py``'s shapes at each cluster split and CTA count, on one CUDA
device; or compare the SASS of each kernel in two builds of one source,
with names and addresses stripped.

    python3 kernel_tiles.py time K10          # or K17, K3, K13, K2, K2v, K9, K18
    python3 kernel_tiles.py sass LIB_A LIB_B  # two builds' lib<source>-*.so

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
    if kernel in ("K2", "K2v", "K9"):
        time_decode(torch, cuda_time_ms, dev, kernel)
        return 0
    if kernel == "K18":
        time_k18(torch, cuda_time_ms, dev, sms)
        return 0
    if kernel in ("K3", "K13"):
        (time_k3 if kernel == "K3" else time_k13)(torch, cuda_time_ms, dev, sms)
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
    """K2 (bf16 cache), K2v (its e5m2 and int8 caches) or K9 (pages of 128
    rows, shuffled, in each pool mode) at Llama-3-8B's decode shape, B = 8,
    H = 32, Hkv = 8, at T = 256 (generate's ragged lengths), 1024 (the
    engine's) and 4096 (all valid): the plan ``launch_plan`` picks, then
    every other one of the mainloop."""
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
    pools = {"K2": ("bf16",), "K2v": ("float8_e5m2", "int8"),
             "K9": ("bf16",) + smoke.KV_QUANT}[kernel]
    for dtype_name in pools:
        for t, lengths in cases:
            lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
            if kernel == "K2":
                kc, vc = (torch.randn((b, t, hkv, d), generator=gen, device=dev)
                          .to(torch.bfloat16) for _ in range(2))
                picked = k2.launch_plan(q.shape, kc.shape)
                plan_of = lambda **kw: k2.launch_plan(q.shape, kc.shape, **kw)  # noqa: E731
                run = lambda plan: k2._launch(q, kc, vc, lens, d ** -0.5, plan)  # noqa: E731
                row_bytes = k2.ROW_BYTES
            elif kernel == "K2v":
                ck, cv = (QuantKVCache.create(b, t, hkv, d, dtype_name, device=dev).update(
                    torch.randn((b, t, hkv, d), generator=gen, device=dev), 0) for _ in range(2))
                args = (q, ck.qdata, ck.scale, cv.qdata, cv.scale, lens, d ** -0.5)
                picked = k2.launch_plan_vec8(q.shape, ck.qdata.shape)
                plan_of = lambda **kw: k2.launch_plan_vec8(q.shape, ck.qdata.shape,  # noqa: E731
                                                           **kw)
                run = lambda plan: k2._launch_quant("v8", *args, plan)  # noqa: E731
                row_bytes = k2.HEAD_DIM
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
            plans = [picked] + [plan_of(splits=sp, rows=rows, stages=st) for sp in k2.SPLITS
                                for rows in k2.TILE_ROWS for st in k2.STAGES
                                if (sp, rows, st) != picked[:3]
                                and k2.smem_bytes(rows, st, row_bytes) <= k2.SMEM_MAX]
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


def compare_sass(lib_a: str, lib_b: str) -> int:
    a, b = _sass(lib_a), _sass(lib_b)
    same = sorted(n for n in a.keys() & b.keys() if a[n] == b[n])
    differ = sorted(n for n in a.keys() & b.keys() if a[n] != b[n])
    only = sorted(a.keys() ^ b.keys())
    print(f"SASS: {len(same)} kernels identical, {len(differ)} differ, {len(only)} in one "
          f"build only")
    for n in differ:
        changed = [ln for ln in difflib.unified_diff(a[n], b[n], lineterm="", n=0)
                   if ln[:1] in "+-" and ln[:3] not in ("+++", "---")]
        print(f"  differs: {n} ({len(a[n])} against {len(b[n])} instructions, "
              f"{len(changed)} changed lines)")
    for n in only:
        print(f"  in one build only: {n}")
    return 0 if not differ and not only else 1


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("time", help="time a kernel's launch at each tile or plan")
    t.add_argument("kernel", choices=("K10", "K17", "K3", "K13", "K2", "K2v", "K9", "K18"))
    s = sub.add_parser("sass", help="compare the SASS of two builds of one source")
    s.add_argument("lib_a")
    s.add_argument("lib_b")
    args = parser.parse_args()
    if args.cmd == "time":
        return time_tiles(args.kernel)
    return compare_sass(args.lib_a, args.lib_b)


if __name__ == "__main__":
    sys.exit(main())
