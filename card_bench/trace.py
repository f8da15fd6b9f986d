"""Reading a torch.profiler trace of the card.

`Trace` takes a finished `torch.profiler.profile` and keeps what the
per-layer readers need: every device activity (kernels, copies, sets)
with its interval and the host range that launched it, the host ranges
on the main thread, and the traced window. Kernel names are grouped by
`GROUPS`, a frozen copy of `tpu_yolo_torch/profile_serve.py`'s.
"""
from __future__ import annotations

import bisect
import re

GROUPS = (  # first match wins; matched against the lowercased kernel name
    ("psa_attention", r"attention_\w*kernel"),
    ("nms_greedy_keep", r"nms_keep_kernel"),
    ("sort", r"sort|radix"),
    ("layout", r"nchwtonhwc|nhwctonchw|transpose"),
    ("conv", r"conv|xmma|implicit|cudnn|gemm|fprop|cutlass"),
    ("cat", r"catarray"),
    ("reduce", r"reduce"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
    ("copy", r"memcpy|memset|copy"),
)


def group_of(name: str, groups=GROUPS) -> str:
    low = name.lower()
    for group, pattern in groups:
        if re.search(pattern, low):
            return group
    return "other"


class DeviceOp:
    __slots__ = ("name", "start", "end")

    def __init__(self, name, start, end):
        self.name, self.start, self.end = name, start, end

    @property
    def seconds(self):
        return (self.end - self.start) / 1e6


class Trace:
    """Device activities of a profile, in microseconds of one clock.

    `ops`: DeviceOp list (kernels, memcpy, memset) in order of start.
    `launched`: (name, seconds, ranges) of each device activity as the
    host op that launched it records it, with the names of that op and
    of the ranges around it, innermost first. `host`: (start, end, depth, name) of the
    benchmark's own ranges, the `record_function`s whose names start
    with one of `labels`. `start`, `end`: the traced window, from the
    first to the last event of either side."""

    def __init__(self, prof, labels=("bench.", "layer.")):
        from torch.autograd import DeviceType

        self.ops: list[DeviceOp] = []
        self.launched = []
        self.host = []
        lo, hi = float("inf"), float("-inf")
        for e in prof.events():
            tr = e.time_range
            if e.device_type == DeviceType.CPU:
                lo, hi = min(lo, tr.start), max(hi, tr.end)
                chain, p = [], e
                while p is not None:
                    chain.append(p.name)
                    p = p.cpu_parent
                if e.name.startswith(labels):
                    self.host.append((tr.start, tr.end, len(chain), e.name))
                for k in e.kernels:
                    if not k.name.startswith(("ProfilerStep", *labels)):
                        self.launched.append((k.name, k.duration / 1e6, chain))
                continue
            # the ranges' own spans on the device timeline are no device work
            if (e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False)
                    or e.name.startswith(("Activity Buffer", "ProfilerStep", *labels))):
                continue
            self.ops.append(DeviceOp(e.name, tr.start, tr.end))
            lo, hi = min(lo, tr.start), max(hi, tr.end)
        self.ops.sort(key=lambda o: o.start)
        self.start, self.end = lo, hi

    @property
    def window_s(self) -> float:
        return max(self.end - self.start, 0.0) / 1e6

    def busy_intervals(self):
        """The union of the device activities' intervals, in order."""
        out = []
        for o in self.ops:
            if out and o.start <= out[-1][1]:
                out[-1][1] = max(out[-1][1], o.end)
            else:
                out.append([o.start, o.end])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def ops_named(self, pattern: str):
        rx = re.compile(pattern)
        return [o for o in self.ops if rx.search(o.name.lower())]

    def seconds_in_range(self, tag: str) -> float | None:
        """Device seconds of the activities launched inside the host range
        `tag`; None where no range of that name launched any."""
        hits = [s for name, s, chain in self.launched if tag in chain and name != tag]
        return sum(hits) if hits else None

    def by_group(self) -> dict:
        """{group: device seconds}."""
        out: dict = {}
        for o in self.ops:
            g = group_of(o.name)
            out[g] = out.get(g, 0.0) + o.seconds
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps by what the host's innermost range was at the gap's middle."""
        per_op: dict = {}
        for o in self.ops:
            per_op[o.name] = per_op.get(o.name, 0.0) + o.seconds
        ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
        gaps: dict = {}
        busy = self.busy_intervals()
        edges = [(self.start, self.start)] + busy + [(self.end, self.end)]
        host = sorted(self.host)
        starts = [h[0] for h in host]
        for (_, a), (b, _) in zip(edges, edges[1:]):
            if b <= a:
                continue
            mid = (a + b) / 2
            inner = [h for h in host[:bisect.bisect_right(starts, mid)] if h[1] >= mid]
            label = max(inner, key=lambda h: h[2])[3] if inner else "(outside the benchmark's ranges)"
            gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e6
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [[n[:120], s] for n, s in idle]}
