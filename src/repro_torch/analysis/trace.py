"""What a profiled step spent on the card -- the port's counterpart of
``repro.analysis.hlo``.

The reference parses the optimized HLO text of a compiled step for its
FLOPs, bytes and collectives.  The port compiles no whole step: its record
of a step is ``torch.profiler``'s, and ``summarize`` aggregates its
``key_averages()`` over ``steps`` profiled steps taken in ``wall_us``
microseconds of the host's clock:

* the device's kernels (events on the CUDA device with self device time):
  time and launches per step, the device's busy share of the wall time, the
  top kernels, and each of the port's hand-written kernels by its device
  symbol (``PORT_KERNEL_SYMBOLS``);
* the host's time in CUDA runtime calls (launches, copies, waits; events on
  the host whose name starts with ``cuda``).

Where the profiler saw no device time the busy share is "not measured".

``device_ms`` reads a profiled run's device time from the raw kineto
events, for runs with too many kernels for ``key_averages()``, which builds
a Python object an event (~15 s for the ~150,000 kernels of an rwkv6-7b
training step).
"""
from __future__ import annotations

from typing import Iterable

# device-kernel names of the port's kernels in a profiler trace
PORT_KERNEL_SYMBOLS = ("w4a8_kernel", "paged_decode_kernel", "paged_prefill_kernel",
                       "rmsnorm_kernel", "grouped_kernel", "dense_decode_kernel",
                       "flash_prefill_kernel")


def _device_us(event) -> float:
    us = getattr(event, "self_device_time_total", None)
    return getattr(event, "self_cuda_time_total", 0) if us is None else us


def summarize(averages: Iterable, steps: int, wall_us: float) -> dict:
    """Per-step device time, launches, busy share, the port's kernels and
    the runtime calls of ``steps`` profiled steps (``averages``: the
    profiler's ``key_averages()``; ``wall_us``: the steps' wall time)."""
    kern = []          # device kernels only (host ops would count them twice)
    api = []           # the host's time in CUDA runtime calls
    for e in averages:
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            if e.key.startswith("cuda") and e.cpu_time_total > 0:
                api.append((e.cpu_time_total, e.count, e.key))
            continue
        dev_us = _device_us(e)
        if dev_us > 0:
            kern.append((dev_us, e.count, e.key))
    kern.sort(reverse=True)
    busy = sum(k[0] for k in kern)
    if busy <= 0:
        return {"device_busy_share": "not measured"}
    ours = sum(us for us, _c, n in kern if any(k in n for k in PORT_KERNEL_SYMBOLS))
    api.sort(reverse=True)
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
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        total += e.duration_ns()
        for sym in by:
            if sym in e.name():
                by[sym] += e.duration_ns()
    return total / 1e6, {sym: ns / 1e6 for sym, ns in by.items()}
