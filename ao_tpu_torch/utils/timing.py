"""Device-time measurement on a CUDA device.

PyTorch counterpart of ``ao_tpu/utils/timing.py``, which reads device busy
time from the JAX profiler; this reads it from ``torch.profiler`` (CUPTI).
A measurement needs a CUDA device and refuses to run without one: a CPU
time is never a device time.
"""

from __future__ import annotations

import sys
from typing import Callable, List

import torch

L2_FLUSH_BYTES = 256 << 20  # five times the H100's 50 MB L2


ATTEMPTS = 3  # a profile whose device records came back incomplete is taken again

_FLUSH_KERNELS = {}  # device index -> kernels one L2 flush launches


def _device_spans(activities, run) -> List[float]:
    """Durations (us) of the device activities a profile of ``run()``
    recorded, in the order the device ran them (may be empty)."""
    from torch.autograd import DeviceType
    from torch.profiler import profile

    with profile(activities=activities) as prof:
        run()
        torch.cuda.synchronize()
    spans = [(e.time_range.start, e.time_range.elapsed_us())
             for e in prof.events() if e.device_type == DeviceType.CUDA]
    return [d for _, d in sorted(spans)]


def cuda_time_ms(fn: Callable[[], object], iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds of the kernels ``fn()`` launches on the
    current device.

    Each kernel's time is the profiler's record of it on the device, and a
    run's time is the sum over its kernels: the host's time to enqueue them
    (a small kernel's Python wrapper takes longer than the kernel) and the
    gaps between them are not counted. A 256 MB buffer is read before every
    run, so ``fn`` finds its inputs in device memory and not in L2, as the
    decode loop does; a read, because a write would leave L2 full of dirty
    lines that ``fn`` would pay to write back. ``fn`` must launch the same
    kernels on every call.

    The profiler now and then returns a profile's device records incomplete
    (seen on the H100: a profile of one flush recorded no kernel, and three
    profiles in a row of ten flush + ``torch.matmul`` runs each held no whole
    number of runs, 27 records in the last), so the flush's kernels are
    counted once per device, and
    a profile whose record count is not a whole number of runs is taken
    again, up to ATTEMPTS times. If none comes back whole, the runs are
    timed with CUDA events around ``fn`` instead (``_event_ms``), and a note
    on stderr says so."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms measures device time and needs a CUDA device")
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    dev = torch.cuda.current_device()
    scratch = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    for _ in range(warmup):
        scratch.max()
        fn()
    torch.cuda.synchronize()

    def runs():
        for _ in range(iters):
            scratch.max()
            fn()

    got = []
    for _ in range(ATTEMPTS):
        if dev not in _FLUSH_KERNELS:
            got = _device_spans(activities, lambda: [scratch.max() for _ in range(4)])
            if not got or len(got) % 4:
                continue
            _FLUSH_KERNELS[dev] = len(got) // 4
        n_flush = _FLUSH_KERNELS[dev]
        got = _device_spans(activities, runs)
        per_run = len(got) // iters
        if per_run * iters == len(got) and per_run > n_flush:
            return sum(d for i, d in enumerate(got) if i % per_run >= n_flush) / iters / 1e3
    print(f"cuda_time_ms: {len(got)} device records over {iters} runs of "
          f"{_FLUSH_KERNELS.get(dev)} flush kernels + fn in each of {ATTEMPTS} profiles; "
          f"timed with CUDA events instead", file=sys.stderr, flush=True)
    return _event_ms(fn, scratch, iters)


def _event_ms(fn: Callable[[], object], scratch: torch.Tensor, iters: int) -> float:
    """Mean milliseconds between two CUDA events recorded around ``fn()``
    after an L2 flush. The flush (a 256 MB read, about 0.1 ms) is queued
    first, so the host enqueues ``fn``'s launches while the device is still
    busy with it, and the span holds ``fn``'s kernels and the device's own
    gaps between them, not the host's launch time, as long as the host
    takes less than the flush to enqueue them."""
    total = 0.0
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        scratch.max()
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def device_kernels(fn: Callable[[], object]) -> int:
    """The device operations (kernels, memsets, copies) one call of ``fn()``
    runs on the current device, after a warm call, as torch.profiler counts
    them. Over long runs of profiles the profiler now and then returns no
    device record at all, several times in a row (seen on the H100), so an
    empty profile is taken again, up to ATTEMPTS times, and then the call is
    counted as the nodes of a CUDA graph captured from it (0 if it cannot
    be captured either)."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_kernels counts device operations and needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
        if n:
            return n
    return _graph_nodes(fn) or 0


def _graph_nodes(fn: Callable[[], object]):
    """The nodes of a CUDA graph captured from one call of ``fn()`` (read
    through libcuda's cuGraphGetNodes), or None where it cannot be had."""
    import ctypes

    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError:
        return None
    try:
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            fn()
        raw = graph.raw_cuda_graph()
        libcuda = ctypes.CDLL("libcuda.so.1")
    except (RuntimeError, OSError):
        return None
    n = ctypes.c_size_t(0)
    err = libcuda.cuGraphGetNodes(ctypes.c_void_p(raw), None, ctypes.byref(n))
    return int(n.value) if err == 0 else None
