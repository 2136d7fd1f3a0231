"""Reading a `torch.profiler` trace of the measured window: the device's
busy intervals, kernel time by name, and the host span open during each
idle gap.

Host spans are host-clock ranges the harness records around the calls into
each layer (traced runs only), placed on the profiler's clock by the
window's range, which both clocks see.
"""

from __future__ import annotations

import bisect
import dataclasses
import fnmatch
from pathlib import Path

# Host span names the harness records, innermost first when nested.
SPANS = ("env.set_input", "env.candidates", "env.score",
         "recognizer.localize")
OUTSIDE = "http.json"   # no span open: HTTP, JSON decode and encode
# Characters of a device operation's name kept in the breakdown.
NAME_CHARS = 96


@dataclasses.dataclass
class Trace:
    kernels: list[tuple[str, float, float]]   # (name, start_us, end_us)
    spans: list[tuple[str, float, float]]     # host spans
    window: tuple[float, float]               # the window, profiler us

    def busy_seconds(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def busy_intervals(self) -> list[tuple[float, float]]:
        lo, hi = self.window
        ivs = sorted((max(s, lo), min(e, hi)) for _, s, e in self.kernels
                     if e > lo and s < hi)
        out: list[list[float]] = []
        for s, e in ivs:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def kernel_seconds(self, patterns: list[str]) -> float | None:
        """Summed device time of kernels whose name matches a pattern
        (fnmatch, case-sensitive); None when none ran."""
        total, hit = 0.0, False
        for name, s, e in self.kernels:
            if any(fnmatch.fnmatchcase(name, p) for p in patterns):
                total += e - s
                hit = True
        return total / 1e6 if hit else None

    def top_ops(self, n: int = 10) -> list[list]:
        """Device seconds by operation, the longest first; names cut to
        NAME_CHARS."""
        by: dict[str, float] = {}
        for name, s, e in self.kernels:
            key = name[:NAME_CHARS]
            by[key] = by.get(key, 0.0) + (e - s) / 1e6
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """Idle device time inside the window by the host span open at each
        gap's midpoint (the innermost of SPANS)."""
        lo, hi = self.window
        busy = self.busy_intervals()
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        # Per span name its ranges by start (ranges of one name do not
        # nest: the server thread enters each layer once at a time).
        ranges = {n: sorted((a, b) for m, a, b in self.spans if m == n)
                  for n in SPANS}
        starts = {n: [a for a, _ in r] for n, r in ranges.items()}

        def inside(n, t):
            i = bisect.bisect_right(starts[n], t) - 1
            return i >= 0 and ranges[n][i][1] > t

        by: dict[str, float] = {}
        for s, e in zip(edges[::2], edges[1::2]):
            if e <= s:
                continue
            mid = (s + e) / 2
            name = next((n for n in SPANS if inside(n, mid)), OUTSIDE)
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:n]]


def from_profiler(prof, window_marker: str, host_spans, host_window) -> Trace:
    """The device events (kernels, copies, sets) of a finished profiler, the
    window (the `window_marker` range) and the host spans, moved from the
    host clock (seconds; `host_window` is the window on it) onto the
    trace's."""
    from torch.autograd import DeviceType

    kernels, window = [], None
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            kernels.append((e.name, float(s), float(t)))
        elif e.name == window_marker:
            window = (float(s), float(t))
    if window is None:
        raise RuntimeError(f"no {window_marker!r} range in the trace")
    offset = window[0] - host_window[0] * 1e6
    spans = [(n, a * 1e6 + offset, b * 1e6 + offset) for n, a, b in host_spans]
    return Trace(kernels=kernels, spans=spans, window=window)


def patterns(directory: Path) -> list[str]:
    """Kernel-name patterns of a stage: one per line of every *.txt file in
    the stage's directory (a later kernel adds a file)."""
    out = []
    for f in sorted(directory.glob("*.txt")):
        out += [ln.strip() for ln in f.read_text().splitlines()
                if ln.strip() and not ln.startswith("#")]
    return out
