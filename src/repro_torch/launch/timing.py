"""Device timing for the port's measurement scripts (``chip_smoke.py``,
``repro_torch.launch.tile_sweep``).  CUDA only: nothing here runs on the CPU.
"""
from __future__ import annotations

import sys

import torch


TRACE_ATTEMPTS = 3


def device_ms(fn, reps: int, names: tuple | None = None) -> float:
    """Device time of one call of ``fn``: the summed duration of the GPU
    kernels it launches (only those whose name contains one of ``names``,
    when given), from a profiler trace over ``reps`` calls after one warm-up
    call.  A trace that holds no matching device event is taken again, up to
    :data:`TRACE_ATTEMPTS` traces in all; then this raises: a wall time is never passed
    off as a device time."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        us, seen, other = _trace(fn, reps, names)
        if seen:
            return us / reps / 1e3
        print(f"device_ms: trace {attempt} of {TRACE_ATTEMPTS} holds no device "
              f"event{'' if names is None else f' named {names}'} "
              f"({other} other device events)", file=sys.stderr, flush=True)
    raise RuntimeError(f"{TRACE_ATTEMPTS} profiler traces held no device event"
                       f"{'' if names is None else f' named {names}'}")


def _trace(fn, reps: int, names: tuple | None) -> tuple[float, int, int]:
    """Profile ``reps`` calls of ``fn``: the summed microseconds and the
    count of the device events matching ``names``, and the count of the
    other device events."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, seen, other = 0.0, 0, 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if names is None or any(n in e.name for n in names):
            seen += 1
            us += e.time_range.elapsed_us()
        else:
            other += 1
    return us, seen, other


def wall_ms(fn, reps: int) -> float:
    """CUDA-event time per call of ``fn`` run back to back, host included."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


KERNEL_NAMES = {"packet": ("packet_partial", "packet_reduce"),
                "matvec": ("matvec_partial", "matvec_reduce"),
                "rows_apply": ("rows_apply",), "cols_apply": ("cols_apply",)}
