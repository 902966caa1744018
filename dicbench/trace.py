"""The traced slice: torch.profiler over a few sequences, reduced to what
the per-layer metrics and the result's breakdown read.

The profile is written as a Chrome trace into a fresh directory under
TMPDIR, read back and deleted.  Device intervals are the events of the
categories "kernel", "gpu_memcpy" and "gpu_memset"; their union is the
time the device was busy.  The harness's own record_function spans
(names starting "dicbench.") mark the traced window and each call into
the program; an idle gap of the device is labelled by the innermost
harness span and the innermost host operation running at its midpoint,
or where none runs, the host operation that ended last before it.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
WINDOW_SPAN = "dicbench.traced_window"


@contextlib.contextmanager
def profiled(result: dict):
    """Profile the block (host and card); on exit fill `result` with the
    reduced trace (reduce())."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        with torch.profiler.record_function(WINDOW_SPAN):
            yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    finally:
        prof.stop()
    tmp = tempfile.mkdtemp(prefix="dicbench_trace_")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    result.update(reduce(events))


def _union(intervals):
    """Sorted, merged [start, end] intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(events: list) -> dict:
    """From Chrome trace events (times in microseconds): the window's
    length, the device's busy time in it, kernel launches, the device
    operations by total time, the idle gaps by label, and the harness's
    sequence spans."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == WINDOW_SPAN
           and e.get("cat") == "user_annotation"]
    if not win:
        return {}
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS
           and float(e["ts"]) < w1 and float(e["ts"]) + float(e["dur"]) > w0]
    busy = _union([max(float(e["ts"]), w0), min(float(e["ts"])
                   + float(e["dur"]), w1)] for e in dev)
    busy_us = sum(e - s for s, e in busy)
    by_name: dict = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
    tid = win[0].get("tid")
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in xs if e.get("cat") in HOST_CATS
                  and e.get("tid") == tid and e.get("name") != WINDOW_SPAN)
    gaps = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    # A sweep over the gaps' midpoints in time order: host events of the
    # window's thread nest, so a stack of those begun holds the innermost
    # one running on top once those ended are popped.
    spans, ops, nxt, after = [], [], 0, None
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        t = (s + e) / 2
        while nxt < len(host) and host[nxt][0] <= t:
            ev = host[nxt]
            (spans if ev[2].startswith("dicbench.") else ops).append(ev)
            nxt += 1
        last = None  # the host op that ended last before t
        for stack in (spans, ops):
            while stack and stack[-1][1] < t:
                ended = stack.pop()
                if stack is ops and (last is None or ended[1] > last[1]):
                    last = ended
        if last is not None:
            after = last
        parts = [spans[-1][2]] if spans else []
        if ops:
            parts.append(ops[-1][2])
        elif after is not None:
            parts.append(f"after {after[2]}")
        key = " > ".join(parts) or "no span"
        gaps[key] = gaps.get(key, 0.0) + (e - s)
    seqs = [e for e in xs if e.get("name") == "dicbench.run_sequence"
            and e.get("cat") == "user_annotation"]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "kernels": sum(1 for e in dev if e.get("cat") == "kernel"),
        "device_ops": sorted(((k, v * 1e-6) for k, v in by_name.items()),
                             key=lambda kv: -kv[1]),
        "idle_gaps": sorted(((k, v * 1e-6) for k, v in gaps.items()),
                            key=lambda kv: -kv[1]),
        "sequences": len(seqs),
    }
