"""What a profiled step spent on the card -- the port's counterpart of
``repro.analysis.hlo``.

The reference parses the optimized HLO text of a compiled step for its
FLOPs, bytes and collectives (``repro.analysis.hlo``, which has no
counterpart: the port compiles no whole step).  The port's record of a
step is ``torch.profiler``'s, and ``summarize`` aggregates the raw kineto
events of ``steps`` profiled steps taken in ``wall_us`` microseconds of
the host's clock:

* the device's kernels (events on the CUDA device): time and launches per
  step, the device's busy share of the wall time, the top kernels, and
  each of the port's hand-written kernels by its device symbol
  (``PORT_KERNEL_SYMBOLS``);
* the host's time in CUDA runtime calls (launches, copies, waits; events on
  the host whose name starts with ``cuda``).

Where the profiler saw no device time the busy share is "not measured".
``device_ms`` reads a profiled run's device time from the same events.
Neither goes through ``key_averages()``, which builds a Python object an
event (~15 s for the ~150,000 kernels of an rwkv6-7b training step).
"""
from __future__ import annotations

import collections
from typing import Iterable

# device-kernel names of the port's kernels in a profiler trace
PORT_KERNEL_SYMBOLS = ("w4a8_kernel", "paged_decode_kernel", "paged_prefill_kernel",
                       "rmsnorm_kernel", "grouped_kernel", "dense_decode_kernel",
                       "flash_prefill_kernel")


def _events(prof):
    """The raw kineto events of a finished ``torch.profiler`` run."""
    return prof.profiler.kineto_results.events()


def summarize(prof, steps: int, wall_us: float) -> dict:
    """Per-step device time, launches, busy share, the port's kernels and
    the runtime calls of ``steps`` profiled steps (``prof``: the finished
    ``torch.profiler`` run; ``wall_us``: the steps' wall time), summed by
    event name."""
    from torch.autograd import DeviceType
    dev_ns = collections.defaultdict(lambda: [0, 0])     # name -> [ns, count]
    api_ns = collections.defaultdict(lambda: [0, 0])
    for e in _events(prof):
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            acc = dev_ns[name]
        elif name.startswith("cuda"):
            acc = api_ns[name]
        else:
            continue
        acc[0] += e.duration_ns()
        acc[1] += 1
    # device kernels only (host ops would count them twice)
    kern = sorted(((ns / 1e3, c, n) for n, (ns, c) in dev_ns.items() if ns > 0),
                  reverse=True)
    api = sorted(((ns / 1e3, c, n) for n, (ns, c) in api_ns.items() if ns > 0),
                 reverse=True)
    busy = sum(k[0] for k in kern)
    if busy <= 0:
        return {"device_busy_share": "not measured"}
    ours = sum(us for us, _c, n in kern if any(k in n for k in PORT_KERNEL_SYMBOLS))
    return {
        "device_busy_share": busy / wall_us,
        "profiled_step_ms": wall_us / steps / 1e3,
        "device_ms_per_step": busy / steps / 1e3,
        "port_kernel_ms_per_step": ours / steps / 1e3,
        "device_launches_per_step": sum(c for _u, c, _n in kern) / steps,
        "top_kernels": [{"name": n[:80], "ms_per_step": us / steps / 1e3,
                         "launches_per_step": c / steps} for us, c, n in kern[:10]],
        "port_kernels": {
            sym: {"ms_per_step": sum(us for us, _c, n in kern if sym in n) / steps / 1e3,
                  "launches_per_step": sum(c for _u, c, n in kern if sym in n) / steps}
            for sym in PORT_KERNEL_SYMBOLS if any(sym in n for _u, _c, n in kern)},
        "runtime_calls": {n: {"host_ms_per_step": us / steps / 1e3,
                              "calls_per_step": c / steps} for us, c, n in api[:6]},
    }


def device_ms(prof, syms: Iterable[str] = ()) -> tuple:
    """(the device time of every CUDA event of a finished ``torch.profiler``
    run, {sym: the device time of the events whose name holds sym}), in
    ms, from the raw kineto events."""
    from torch.autograd import DeviceType
    total, by = 0, {sym: 0 for sym in syms}
    for e in _events(prof):
        if e.device_type() != DeviceType.CUDA:
            continue
        total += e.duration_ns()
        for sym in by:
            if sym in e.name():
                by[sym] += e.duration_ns()
    return total / 1e6, {sym: ns / 1e6 for sym, ns in by.items()}
