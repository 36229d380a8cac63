"""Arithmetic over a profiler trace: the device's busy time as the union
of its operations' intervals, the idle share, device time by operation
name and by the host span that launched it, and the idle gaps named by
what the host was doing.

A trace here is plain data (``Trace``): device operations with the host
time and thread of their launch, host operations with their thread, and
the window the trace covers, all in microseconds on one clock. Building
one from ``torch.profiler`` is the harness's job; nothing here imports
the program or the profiler.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")


@dataclasses.dataclass
class Trace:
    # (name, start, end, launch time, launch thread)
    device_ops: List[Tuple[str, float, float, float, int]]
    # (name, start, end, thread)
    host_ops: List[Tuple[str, float, float, int]]
    window: Tuple[float, float]
    main_thread: int
    steps: int

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def merged(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals inside the
        window, as disjoint sorted intervals."""
        lo, hi = self.window
        out: List[List[float]] = []
        for _, a, b, _, _ in sorted(self.device_ops, key=lambda o: o[1]):
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_us(self) -> float:
        return sum(b - a for a, b in self.merged())

    def idle_share(self) -> Optional[float]:
        if not self.device_ops or self.window_us <= 0:
            return None
        return 1.0 - self.busy_us() / self.window_us

    def kernels(self) -> list:
        """Device operations that are kernels (not copies or fills)."""
        return [o for o in self.device_ops
                if not o[0].startswith(COPY_PREFIXES)]

    def device_us_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, a, b, _, _ in self.device_ops:
            out[name] = out.get(name, 0.0) + (b - a)
        return out

    def spans(self, name: str) -> List[Tuple[float, float, int]]:
        return [(a, b, th) for n, a, b, th in self.host_ops if n == name]

    def device_us_in(self, span: str) -> float:
        """Device time of the operations launched inside any host span
        ``span`` (on the launching thread)."""
        by_thread: Dict[int, List[Tuple[float, float]]] = {}
        for a, b, th in self.spans(span):
            by_thread.setdefault(th, []).append((a, b))
        merged: Dict[int, Tuple[list, list]] = {}
        for th, ivs in by_thread.items():
            ivs.sort()
            starts, ends = [], []
            for a, b in ivs:
                if ends and a <= ends[-1]:
                    ends[-1] = max(ends[-1], b)
                else:
                    starts.append(a)
                    ends.append(b)
            merged[th] = (starts, ends)
        total = 0.0
        for _, a, b, launch, th in self.device_ops:
            if th not in merged:
                continue
            starts, ends = merged[th]
            i = bisect.bisect_right(starts, launch) - 1
            if i >= 0 and launch <= ends[i]:
                total += b - a
        return total

    def idle_gaps(self) -> Dict[str, float]:
        """Idle device time inside the window, summed by the innermost
        host operation or span on the main thread that was running at
        each gap's midpoint ("host" where none but the window's own span
        was: Python between operations)."""
        lo, hi = self.window
        busy = self.merged()
        gaps, cur = [], lo
        for a, b in busy:
            if a > cur:
                gaps.append((cur, a))
            cur = max(cur, b)
        if hi > cur:
            gaps.append((cur, hi))
        ops = sorted(((a, b, n) for n, a, b, th in self.host_ops
                      if th == self.main_thread
                      and (a, b) != tuple(self.window)),
                     key=lambda o: (o[0], -o[1]))
        out: Dict[str, float] = {}
        stack: List[Tuple[float, float, str]] = []
        j = 0
        for g0, g1 in gaps:     # gaps are in time order
            mid = 0.5 * (g0 + g1)
            while j < len(ops) and ops[j][0] <= mid:
                while stack and stack[-1][1] < ops[j][0]:
                    stack.pop()
                stack.append(ops[j])
                j += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            name = stack[-1][2] if stack else "host"
            out[name] = out.get(name, 0.0) + (g1 - g0)
        return out


def top(d: Dict[str, float], n: int = 10) -> List[Tuple[str, float]]:
    return sorted(d.items(), key=lambda kv: -kv[1])[:n]
