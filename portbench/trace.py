"""A profiled stretch of frames: the device's time by kernel, its busy and
idle time, the idle gaps named by the host span they fall in, and the
kernels' launches by shape. Taken after the unprofiled window, since a
profiler session slows the host's issue of every later graph replay."""
from __future__ import annotations

import time
from collections import Counter, defaultdict

from . import port


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile(serve, first: int, n: int, spans, kernels: dict) -> dict:
    """Serve frames first..first+n-1 under torch.profiler. `kernels` maps a
    wrapper name to its module (kernels/)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    before = port.launch_counts()
    spans.profiling = True
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(first, first + n):
            serve(i)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    spans.profiling = False
    after = port.launch_counts()

    device, annotations = [], []
    for e in prof.events():
        span = (e.time_range.start, e.time_range.end, e.name)
        if e.name.startswith("portbench."):
            # the host spans (a record_function range shows on both sides)
            if e.device_type != DeviceType.CUDA:
                annotations.append(span)
        elif e.device_type == DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            device.append(span)
    by_name: dict = defaultdict(float)
    for s, e, name in device:
        by_name[name] += (e - s) * 1e-6
    busy = _merge([(s, e) for s, e, _ in device])
    gaps = []
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        inside = [a for a in annotations if a[0] <= e0 < a[1]]
        # the innermost span the host was in when the device went idle
        label = min(inside, key=lambda a: a[1] - a[0])[2] if inside else "outside spans"
        gaps.append((label, (s1 - e0) * 1e-6))
    kernel_s, kernel_n = defaultdict(float), Counter()
    for s, e, name in device:
        for wrapper, mod in kernels.items():
            if mod.PATTERN.search(name):
                kernel_s[wrapper] += (e - s) * 1e-6
                kernel_n[wrapper] += 1
    launches = {w: (after[w][0] - before[w][0], after[w][1] - before[w][1])
                for w in after}
    return {
        "frames": n,
        "window_s": window_s,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "device_s": sum(by_name.values()),
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(gaps, key=lambda g: -g[1])[:10],
        "kernel_s": dict(kernel_s),
        "kernel_traced": dict(kernel_n),
        "launches": launches,
    }
