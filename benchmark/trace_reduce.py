"""From a torch.profiler trace of the measured window to what the per-layer
readers take: the device's intervals by name and group, its busy union,
and the idle gaps by the host range open when each began.

The kernel groups are a frozen copy of the entries of
``tools/profile_torch_slice.py``'s ``GROUPS`` (the port's hand-written
kernels by the fragments of their names) for the kernels that the cells
launch; its busy-union arithmetic is copied too. Imports nothing of the
program.
"""

from __future__ import annotations

import bisect

# a kernel counts in the first group one of whose fragments its name holds:
# the kernels that the cells launch
GROUPS = (("K3 reconstruct", ("reconstruct_kernel",)),
          ("K4 mk_start_chained", ("mk_start_chained_kernel",)),
          ("K1 mk_start", ("mk_start_kernel",)), ("K2 mk_resume", ("mk_resume_kernel",)),
          ("K2's tail mode mk_resume_tail", ("mk_resume_tail_kernel",)),
          ("K2's survivor scan mk_resume_scan", ("mk_resume_scan_kernel",)))
# the mega trace: the camera launches and K2 in both modes
TRACE_GROUPS = ("K4 mk_start_chained", "K1 mk_start", "K2 mk_resume",
                "K2's tail mode mk_resume_tail", "K2's survivor scan mk_resume_scan")
# the profiler's names of copies and fills (not kernels)
COPY_PREFIXES = ("Memcpy", "Memset")


def group_of(name: str):
    """The hand-written kernel group of a device event's name, or None
    (a torch op, a copy or a fill)."""
    return next((label for label, frags in GROUPS if any(f in name for f in frags)), None)


def is_copy(name: str) -> bool:
    """A copy (host to device, device to host, on the device) or a fill."""
    return name.startswith(COPY_PREFIXES)


def _ns(e, what):
    f = getattr(e, f"{what}_ns", None)
    return f() if f is not None else getattr(e, f"{what}_us")() * 1000


class Trace:
    """The device intervals and host ranges of one profiled window, in ns
    on the profiler's clock."""

    def __init__(self, device: list, host: list, start_ns: int, end_ns: int):
        self.device = sorted(device, key=lambda x: x[1])  # (name, start, end)
        self.host = sorted(host, key=lambda x: x[1])
        self._host_starts = [h[1] for h in self.host]
        self.start_ns, self.end_ns = start_ns, end_ns

    @classmethod
    def from_profile(cls, prof, host_names, window: str) -> "Trace":
        """The device events and the host ranges named ``host_names`` of a
        finished profile; the window is the host range named ``window``."""
        device, host, span = [], [], None
        for e in prof.profiler.kineto_results.events():
            name, s, d = e.name(), _ns(e, "start"), _ns(e, "duration")
            if e.is_user_annotation():
                # a range opened on the host; its device-side copy (the
                # span of the kernels it launched) is not device work
                if str(e.device_type()).endswith("CPU"):
                    if name in host_names:
                        host.append((name, s, s + d))
                    elif name == window:
                        span = (s, s + d)
            elif str(e.device_type()).endswith("CUDA"):
                device.append((name, s, s + d))
        if span is None:
            raise RuntimeError(f"the profile holds no range {window!r}")
        return cls(device, host, *span)

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def busy_ns(self) -> int:
        """The union of the device intervals inside the window: work on two
        streams at once counts once."""
        union, end = 0, None
        for _, a, b in self.device:
            a, b = max(a, self.start_ns), min(b, self.end_ns)
            if b <= a:
                continue
            if end is None or a >= end:
                union += b - a
                end = b
            elif b > end:
                union += b - end
                end = b
        return union

    def seconds_by(self, key) -> dict:
        """Device seconds summed by ``key(name)`` (None keys dropped)."""
        out: dict = {}
        for name, a, b in self.device:
            k = key(name)
            if k is not None:
                out[k] = out.get(k, 0.0) + (b - a) / 1e9
        return out

    def count(self, pred) -> int:
        return sum(1 for name, _, _ in self.device if pred(name))

    def gaps(self):
        """(start, length) of each idle stretch of the device in the window."""
        out, t = [], self.start_ns
        for _, a, b in self.device:
            if a > t:
                out.append((t, a - t))
            t = max(t, b)
        if self.end_ns > t:
            out.append((t, self.end_ns - t))
        return out

    def host_at(self, t: int) -> str:
        """The innermost kept host range open at ``t`` (the latest started
        of those that have not ended), or "between ranges"."""
        i = bisect.bisect_right(self._host_starts, t)
        best = None
        for name, a, b in reversed(self.host[max(0, i - 64):i]):
            if a <= t < b and (best is None or a > best[1]):
                best = (name, a)
        return best[0] if best else "between ranges"

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.seconds_by(lambda n: n).items(), key=lambda kv: -kv[1])[:top]
        idle: dict = {}
        for t, n in self.gaps():
            k = self.host_at(t)
            idle[k] = idle.get(k, 0.0) + n / 1e9
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}
