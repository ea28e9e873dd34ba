"""The traced window: ``torch.profiler`` over runs of requests, reduced to
what the per-layer metrics and the breakdown read.

Two passes. The first records the device alone over the cell's
``trace_requests``: recording the host's operations costs the host some
microseconds an operation, which would show as device idle time. Every
device operation lies inside the host's window (the card is synchronized
before the profiler starts and before it stops), so the busy time is the
union of their intervals and the window is the host's clock around those
requests. The second pass records host and device over a few more
requests, inside the harness's ``portbench.window`` span, for the longest
idle gaps and what the host was doing in each (its times carry the host
profiler's cost).
"""
from __future__ import annotations

import bisect
import contextlib

import torch

WINDOW = "portbench.window"


def kernel_id(name: str) -> str:
    """A device kernel's function name, without return type, namespace,
    template arguments or parameters."""
    n = name.removeprefix("void ").strip()
    for ch in "<(":
        n = n.split(ch)[0]
    return n.split("::")[-1].strip()


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def merged(intervals: list) -> list:
    """Union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


@contextlib.contextmanager
def profiled(host: bool):
    """Profile the device (and the host's operations, with ``host``)
    around the block; yields a holder whose ``prof`` is the stopped
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    holder = {}
    acts = [ProfilerActivity.CUDA]
    if host or not torch.cuda.is_available():  # (a CPU rehearsal)
        acts.insert(0, ProfilerActivity.CPU)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield holder
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        holder["prof"] = prof


def _device_events(prof) -> list:
    from torch.autograd import DeviceType

    # the harness's spans show on the device's timeline too
    return [(ev.time_range.start, ev.time_range.end, ev.name)
            for ev in prof.events()
            if ev.device_type == DeviceType.CUDA
            and ev.time_range.end > ev.time_range.start
            and not ev.name.startswith("portbench.")]


def device_pass(prof) -> dict:
    """The device-only pass: busy seconds (the union of every device
    operation's interval), each kernel's time by name, the operations that
    took most time."""
    events = _device_events(prof)
    busy = merged([(a, b) for a, b, _ in events])
    by_name = {}
    for a, b, n in events:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    return {
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "kernels": [(kernel_id(n), (b - a) / 1e6) for a, b, n in events
                    if not _is_copy(n)],
        "device_ops": sorted(([n, s / 1e6] for n, s in by_name.items()),
                             key=lambda r: -r[1])[:10],
    }


def idle_gaps(prof, top: int = 10) -> list:
    """The host-and-device pass: the longest gaps inside the window span in
    which no device operation ran, each named by the innermost host
    operation under way at its start (under the harness's span)."""
    from torch.autograd import DeviceType

    host, window = [], None
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            continue
        if ev.name == WINDOW:
            window = (ev.time_range.start, ev.time_range.end)
        else:
            host.append((ev.time_range.start, ev.time_range.end, ev.name))
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    w0, w1 = window
    busy = merged([(max(a, w0), min(b, w1)) for a, b, _ in
                   _device_events(prof) if b > w0 and a < w1])
    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((a - prev, prev))
        prev = b
    if w1 > prev:
        gaps.append((w1 - prev, prev))
    gaps.sort(reverse=True)
    host.sort()
    starts = [h[0] for h in host]

    def doing(t: float) -> str:
        span, inner = "host", None
        for a, b, n in host[:bisect.bisect_right(starts, t)]:
            if a <= t < b:
                if n.startswith("portbench."):
                    span = n
                elif not n.startswith("cuda"):
                    inner = n
        return span if inner is None else f"{span}/{inner}"

    return [[doing(t), us / 1e6] for us, t in gaps[:top]]
