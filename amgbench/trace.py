"""Reading a ``torch.profiler`` trace of the traced stretch.

The profiler's Chrome trace holds the device's kernels, copies and sets
(each with its launch's correlation id), the host's runtime calls that
launched them, and the benchmark's own host spans (``record_function``
ranges named ``amgbench.<span>``).  Host and device times share one
clock.  :class:`Trace` keeps those and answers what the metric readers
ask: which device work lies in the stretch, which kernels a span
launched, and what the host was doing while the device idled.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

PREFIX = "amgbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def short_name(name: str, limit: int = 160) -> str:
    """A kernel's name without ``void`` and its parameter list (the
    parentheses at template depth 0), at most ``limit`` characters."""
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:limit]


class Trace:
    """``kernels``: ``(start, end, name, correlation)`` in microseconds;
    ``device``: the same for every kernel, copy and set; ``spans``: the
    benchmark's host spans by name (prefix dropped) as ``(start, end)``;
    ``launch_at``: a correlation id's host launch time."""

    def __init__(self, events):
        self.kernels, self.device = [], []
        self.spans = defaultdict(list)
        self.launch_at = {}
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts = float(e.get("ts", 0))
            end = ts + float(e.get("dur", 0))
            args = e.get("args") or {}
            if cat in DEVICE_CATS:
                item = (ts, end, e.get("name", ""), args.get("correlation"))
                self.device.append(item)
                if cat == "kernel":
                    self.kernels.append(item)
            elif cat in LAUNCH_CATS:
                if "correlation" in args:
                    self.launch_at[args["correlation"]] = ts
            elif cat == "user_annotation" and \
                    e.get("name", "").startswith(PREFIX):
                self.spans[e["name"][len(PREFIX):]].append((ts, end))
        self.kernels.sort()
        self.device.sort()
        for v in self.spans.values():
            v.sort()

    @classmethod
    def load(cls, path) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    # -- the stretch ----------------------------------------------------------
    def stretch(self):
        """``(start, end)`` of the traced stretch, or None."""
        s = self.spans.get("stretch")
        return s[0] if s else None

    def in_stretch(self, items):
        st = self.stretch()
        if st is None:
            return []
        return [it for it in items if it[0] >= st[0] and it[1] <= st[1]]

    def busy_us(self) -> float:
        """Microseconds of the stretch in which some kernel, copy or set
        ran (the union of their intervals, clipped to the stretch)."""
        st = self.stretch()
        if st is None:
            return 0.0
        total, cur_s, cur_e = 0.0, None, None
        for s, e, *_ in self.device:
            s, e = max(s, st[0]), min(e, st[1])
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total

    def idle_gaps(self):
        """``(start, end)`` of each stretch of the stretch with no device
        work, longest first."""
        st = self.stretch()
        if st is None:
            return []
        gaps, t = [], st[0]
        for s, e, *_ in self.device:
            if e <= st[0] or s >= st[1]:
                continue
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if st[1] > t:
            gaps.append((t, st[1]))
        return sorted(gaps, key=lambda g: g[0] - g[1])

    # -- spans ----------------------------------------------------------------
    def span_at(self, t: float) -> str:
        """The innermost benchmark span (other than the stretch) that holds
        host time ``t``, or ``"other"``."""
        best, width = "other", None
        for name, ivs in self.spans.items():
            if name == "stretch":
                continue
            i = bisect.bisect_right(ivs, (t, float("inf"))) - 1
            if i >= 0 and ivs[i][0] <= t <= ivs[i][1]:
                w = ivs[i][1] - ivs[i][0]
                if width is None or w < width:
                    best, width = name, w
        return best

    def kernels_during(self, span: str):
        """Kernels that started on the device within a ``span`` (for spans
        that end in a synchronize, so that their device work ends inside
        them)."""
        ivs = self.spans.get(span, [])
        starts = [s for s, _ in ivs]
        out = []
        for k in self.kernels:
            i = bisect.bisect_right(starts, k[0]) - 1
            if i >= 0 and k[0] <= ivs[i][1]:
                out.append(k)
        return out

    def kernels_launched_in(self, span: str):
        """Kernels whose launch on the host lay within a ``span``, by the
        correlation of launch and kernel; None when the trace holds no
        launch times."""
        if not self.launch_at:
            return None
        ivs = self.spans.get(span, [])
        starts = [s for s, _ in ivs]
        out = []
        for k in self.kernels:
            t = self.launch_at.get(k[3])
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= ivs[i][1]:
                out.append(k)
        return out

    # -- breakdown --------------------------------------------------------------
    def breakdown(self, top: int = 10) -> dict:
        """The device operations of the stretch that took most time, by
        name, and its longest idle gaps, each named by the span the host
        was in at the gap's middle; in seconds."""
        by_name = defaultdict(float)
        for s, e, name, _ in self.in_stretch(self.device):
            by_name[short_name(name)] += e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = [(self.span_at((s + e) / 2), (e - s) * 1e-6)
                for s, e in self.idle_gaps()[:top]]
        return {"device_ops": [[n, t * 1e-6] for n, t in ops],
                "idle_gaps": [[n, t] for n, t in gaps]}
