"""Device timing for the port's measurement scripts (``chip_smoke.py``,
``repro_torch.launch.tile_sweep``).  CUDA only: nothing here runs on the CPU.
"""
from __future__ import annotations

import sys

import torch


TRACE_ATTEMPTS = 8
# An L2-cold timing writes this many bytes before each call: 5x the H100's
# 50 MB L2.
FLUSH_BYTES = 256 * 2**20


def l2_flush(device):
    """A function that evicts the L2 cache by rewriting a FLUSH_BYTES
    buffer on ``device`` (one elementwise kernel)."""
    buf = torch.zeros(FLUSH_BYTES // 4, dtype=torch.int32, device=device)
    return buf.bitwise_not_


def device_ms(fn, reps: int, names: tuple | None = None) -> float:
    """Device time of one call of ``fn``: the summed duration of the GPU
    kernels it launches (only those whose name contains one of ``names``,
    when given), from a profiler trace over ``reps`` calls after one warm-up
    call.  A trace that holds no matching device event, or a count of them
    that is no multiple of ``reps`` (the profiler lost some: every call
    launches the same kernels), is taken again, up to
    :data:`TRACE_ATTEMPTS` traces in all; then this raises: a wall time is
    never passed off as a device time."""
    fn()
    torch.cuda.synchronize()
    named = "" if names is None else f" named {names}"
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        us, seen, other = _trace(fn, reps, names)
        if seen and seen % reps == 0:
            return us / reps / 1e3
        print(f"device_ms: trace {attempt} of {TRACE_ATTEMPTS} holds {seen} "
              f"device events{named} for {reps} calls ({other} other device "
              f"events)", file=sys.stderr, flush=True)
    raise RuntimeError(f"{TRACE_ATTEMPTS} profiler traces held no whole count "
                       f"of device events{named} for {reps} calls")


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


def event_ms(fn, reps: int, before=None) -> float:
    """Device time of one call of ``fn``, from CUDA events recorded right
    before and after each call, after one warm-up call; ``before`` (an
    :func:`l2_flush`, for an L2-cold time) runs ahead of each call, outside
    the events.  ``fn`` must launch its kernels without waiting on the
    device, so that they queue behind what came before and the events
    bracket them alone, or run so long (seconds) that its host work does
    not count.  The profiler is not involved: it loses every device event
    of some traces on the card, most often around long kernels."""
    if before is not None:
        before()
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in pairs:
        if before is not None:
            before()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in pairs) / reps


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


KERNEL_NAMES = {"rows_packet": ("dense_tile", "dense_reduce"),
                "cols_packet": ("dense_tile", "dense_reduce"),
                "dense": ("dense_tile", "dense_reduce"),
                "matvec": ("matvec_ring",),
                "rows_apply": ("rows_apply",), "cols_apply": ("cols_apply",)}
