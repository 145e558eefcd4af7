"""The traced sub-window: ``torch.profiler`` over a steady stretch of the
window, reduced to device busy time, each kernel family's device time and
the breakdown (the device operations that took most time, and the longest
idle gaps by what the host was running then).
"""
from __future__ import annotations

import sys
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

# the port's hand-written kernels by the CUDA function names they launch
FAMILIES = {
    "b1": ("topk_stream", "topk_tiles", "merge_lanes"),
    "b3": ("decode_fwd",),
    "b4": ("flash_fwd",),
    "b5": ("ssd_chunk", "ssd_state_pass"),
}


@dataclass
class Trace:
    window_s: float
    busy_s: float
    family_s: Dict[str, float]
    family_kernels: Dict[str, int]
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


class Profiler:
    """Started and stopped by one thread around the sub-window, recording
    every thread's host operations (the service's work runs on its
    scheduler threads) and every kernel on the card."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        # the profiler's first session sets up CUPTI; do it here, on the
        # thread that imported torch, not on the timer's
        with profile(activities=acts):
            pass
        from torch._C._profiler import _ExperimentalConfig

        self._prof = profile(activities=acts,
                             experimental_config=_ExperimentalConfig(profile_all_threads=True))
        self.t_start = self.t_stop = 0.0

    def start(self):
        self._prof.start()
        self.t_start = time.perf_counter()

    def stop(self):
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t_stop = time.perf_counter()
        self._prof.stop()

    def reduce(self) -> Trace:
        import torch

        # event times are microseconds from the profiler's start
        hi = (self.t_stop - self.t_start) * 1e6
        dev, cpu = [], []
        events = self._prof.events()
        for e in events:
            s, t = max(e.time_range.start, 0.0), min(e.time_range.end, hi)
            if t <= s:
                continue
            if e.device_type == torch.autograd.DeviceType.CUDA:
                dev.append((e.name, s, t))
            elif e.device_type == torch.autograd.DeviceType.CPU:
                cpu.append((e.name, s, t))
        print(f"trace: {len(events)} events, {len(dev)} on the card and {len(cpu)} on the "
              f"host in the sub-window", file=sys.stderr)
        return summarize(dev, cpu, self.t_stop - self.t_start)


def _short(name: str) -> str:
    name = name.replace("void ", "")
    return name.split("<")[0].split("(")[0][:64] or name[:64]


def summarize(dev, cpu, window_s: float) -> Trace:
    """``dev``/``cpu``: (name, start_us, end_us) events."""
    dev = sorted(dev, key=lambda e: e[1])
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for _, s, e in dev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                gaps.append((cur_e, s))
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    fam_s: Dict[str, float] = defaultdict(float)
    fam_n: Dict[str, int] = defaultdict(int)
    by_op: Dict[str, float] = defaultdict(float)
    for name, s, e in dev:
        by_op[_short(name)] += (e - s) / 1e6
        for fam, keys in FAMILIES.items():
            if any(k in name for k in keys):
                fam_s[fam] += (e - s) / 1e6
                fam_n[fam] += 1
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    cpu = sorted(cpu, key=lambda c: c[1])
    idle = []
    for s, e in longest:
        mid = (s + e) / 2
        # the outermost host op running at the gap's middle (the longest one)
        over = [c for c in cpu if c[1] <= mid <= c[2]]
        label = max(over, key=lambda c: c[2] - c[1])[0] if over else "host outside torch ops"
        idle.append((label[:64], (e - s) / 1e6))
    return Trace(window_s, busy / 1e6, dict(fam_s), dict(fam_n), ops, idle)
