"""What the port's timing scripts share: the card's line, device and host
time of a call, and the least time a function could take on an H100.

``chip_smoke.py``, ``launch/gemm_tiles.py``, ``launch/quant_tiles.py``
and ``launch/ssd_tiles.py`` time with these, so their numbers are taken
one way.  Needs the card (``torch.cuda``) only when a timer is called.
"""

from __future__ import annotations

import subprocess
import time

import torch

#: H100 SXM data-sheet peaks (dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12,
              "tfloat32": 495e12}


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.splitlines()[0] if out else "nvidia-smi printed nothing"


def time_ms(fn, iters: int, flush=None, sleep_cycles: int = 1_000_000
            ) -> float:
    """Median device time of one call: CUDA events around each call, the
    L2-flush write (when given) between calls outside the events, and a
    device-side sleep of ``sleep_cycles`` before the start event so that
    the device is still busy while the host enqueues the call -- host
    launch overhead then falls outside the measured interval (a call of
    many small launches needs a longer sleep)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for s, e in ev:
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(sleep_cycles)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    ts = sorted(s.elapsed_time(e) for s, e in ev)
    return ts[len(ts) // 2]


def host_us(fn, calls: int = 200, repeats: int = 5) -> float:
    """Wall time a call of ``calls`` back-to-back calls (us), the least of
    ``repeats`` such runs: for calls whose device time is shorter than
    their enqueue, the host's cost (the least, since other work on a
    shared host only adds to it)."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / calls * 1e6)
    return best


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    """The least time (ms) for work that moves ``nbytes`` and does
    ``flops`` operations of ``dtype``, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_ms(prof, name: str | None = None) -> tuple[float, int]:
    """Device time (ms) and launches of the kernels in a
    ``torch.profiler`` profile, or of those whose name holds ``name``."""
    from torch.autograd import DeviceType
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA
          and (name is None or name in e.key)]
    return (sum(e.self_device_time_total for e in ev) / 1e3,
            sum(e.count for e in ev))


def top_ops(prof, n: int) -> list[tuple[str, float, int]]:
    """The ``n`` host-side ops (aten names) whose own kernels took the most
    device time in a ``torch.profiler`` profile: (name, ms, calls)."""
    from torch.autograd import DeviceType
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CPU and e.self_device_time_total > 0]
    ev.sort(key=lambda e: -e.self_device_time_total)
    return [(e.key, e.self_device_time_total / 1e3, e.count) for e in ev[:n]]
