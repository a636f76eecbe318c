"""Reading a ``torch.profiler`` trace, exported as Chrome trace JSON.

Device operations (kernels, copies, memsets) are tied to the benchmark's
host spans (``record_function`` ranges named ``portbench.<phase>``) by the
host event that launched them: the CUDA runtime or driver-API call with the same
``correlation`` id. An operation whose launch is missing from the trace
takes the span of the operation before it on its stream. Times are in
microseconds, as the trace has them.
"""
import bisect
import json
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
HOST_OP_CATEGORIES = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")
SPAN_PREFIX = "portbench."


def load(path) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


class Trace:
    """The device operations of one process's trace, each with the
    benchmark span (``update``, ``compute``, ``reset``, ...) it was
    launched in, or None."""

    def __init__(self, events: List[dict]):
        self.spans: Dict[str, List[Tuple[float, float]]] = {}
        self.host_ops: List[Tuple[float, float, str]] = []
        launches: Dict[int, float] = {}
        device = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts, dur = e.get("cat", ""), float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            args = e.get("args") or {}
            if cat in DEVICE_CATEGORIES:
                device.append((ts, ts + dur, e.get("name", ""), cat, args.get("correlation"), args.get("stream")))
            elif cat == "user_annotation" and e.get("name", "").startswith(SPAN_PREFIX):
                self.spans.setdefault(e["name"][len(SPAN_PREFIX):], []).append((ts, ts + dur))
            if cat in LAUNCH_CATEGORIES and args.get("correlation") is not None:
                launches[args["correlation"]] = ts
            if cat in HOST_OP_CATEGORIES and not e.get("name", "").startswith(SPAN_PREFIX):
                self.host_ops.append((ts, ts + dur, e.get("name", "")))
        for intervals in self.spans.values():
            intervals.sort()
        device.sort()
        self.ops: List[dict] = []
        previous: Dict[object, Optional[str]] = {}
        for start, end, name, cat, corr, stream in device:
            launched = launches.get(corr)
            if launched is not None:
                span = self.span_at(launched, phases_only=True)
            else:
                span = previous.get(stream)
            previous[stream] = span
            self.ops.append({"name": name, "cat": cat, "start": start, "end": end, "span": span})

    def span_at(self, t: float, phases_only: bool = False) -> Optional[str]:
        """The innermost benchmark span holding host time ``t``; with
        ``phases_only`` the ``stretch`` around the whole trace is skipped."""
        best, width = None, float("inf")
        for name, intervals in self.spans.items():
            if phases_only and name == "stretch":
                continue
            i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
            if i >= 0 and intervals[i][0] <= t <= intervals[i][1] and intervals[i][1] - intervals[i][0] < width:
                best, width = name, intervals[i][1] - intervals[i][0]
        return best

    def host_op_at(self, t: float) -> Optional[str]:
        """The name of the innermost host operation running at ``t``."""
        best, width = None, float("inf")
        for start, end, name in self.host_ops:
            if start <= t <= end and end - start < width:
                best, width = name, end - start
        return best

    def window(self) -> Optional[Tuple[float, float]]:
        """The traced stretch (the ``stretch`` span), or None."""
        return self.spans["stretch"][0] if self.spans.get("stretch") else None

    def count(self, span: str) -> int:
        return len(self.spans.get(span, []))

    def device_us(self, span: Optional[str] = None, name_has: Optional[Tuple[str, ...]] = None) -> float:
        """Summed device time of the operations launched in ``span`` (every
        span when None) whose lowered name holds one of ``name_has``."""
        total = 0.0
        for op in self.ops:
            if span is not None and op["span"] != span:
                continue
            if name_has is not None and not any(s in op["name"].lower() for s in name_has):
                continue
            total += op["end"] - op["start"]
        return total

    def launches(self, name_has: str, span: Optional[str] = None) -> List[float]:
        """Device µs of each operation whose name holds ``name_has``."""
        return [op["end"] - op["start"] for op in self.ops
                if name_has in op["name"] and (span is None or op["span"] == span)]

    def busy(self, t0: float, t1: float) -> List[Tuple[float, float]]:
        """The union of device operations' intervals, cut to ``[t0, t1]``."""
        return _union((max(op["start"], t0), min(op["end"], t1)) for op in self.ops
                      if op["end"] > t0 and op["start"] < t1)

    def busy_us(self, t0: float, t1: float) -> float:
        return sum(b - a for a, b in self.busy(t0, t1))

    def idle_gaps(self, t0: float, t1: float) -> List[Tuple[float, float]]:
        gaps, cursor = [], t0
        for a, b in self.busy(t0, t1):
            if a > cursor:
                gaps.append((cursor, a))
            cursor = max(cursor, b)
        if cursor < t1:
            gaps.append((cursor, t1))
        return gaps

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, by name, and the
        longest idle gaps of the stretch, each named by the benchmark span
        and the host operation at its middle; seconds."""
        by_name: Dict[str, float] = {}
        for op in self.ops:
            by_name[op["name"]] = by_name.get(op["name"], 0.0) + op["end"] - op["start"]
        device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        window = self.window()
        gaps = []
        if window is not None:
            for a, b in sorted(self.idle_gaps(*window), key=lambda g: g[0] - g[1])[:top]:
                mid = (a + b) / 2.0
                span = self.span_at(mid, phases_only=True) or "between epochs"
                gaps.append([f"{span}: {self.host_op_at(mid) or 'no host op'}", (b - a) * 1e-6])
        return {
            "device_ops": [[name[:120], us * 1e-6] for name, us in device_ops],
            "idle_gaps": gaps,
        }
