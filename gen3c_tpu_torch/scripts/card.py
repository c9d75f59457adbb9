"""What the card scripts and ``chip_smoke.py`` share: the card's name and
power limit as nvidia-smi gives them, the seeded DiT's gates, and a short
call's device time and host time."""

from __future__ import annotations

import subprocess
import time

import torch

L2_FLUSH_BYTES = 128 << 20  # read before each timed call: over twice the H100's 50 MB L2
HOST_SLEEP_CYCLES = 200_000_000  # ~0.1 s of the card asleep while host time is taken


def nvidia_smi_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``'s
    first line, e.g. "NVIDIA H100 80GB HBM3, 700.00 W"."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def randomize_gates(net: torch.nn.Module, gen: torch.Generator) -> None:
    """Random AdaLN output layers and final linear of a DiT (a fresh init has
    them zero, which makes the network's output identically zero)."""
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("adaLN_modulation.2.weight") or name == "final_layer.linear.weight":
                p.copy_(0.1 * torch.randn(p.shape, generator=gen, device=p.device))


def device_ms(fn, calls: int = 20, tries: int = 5) -> dict:
    """The device's time for one call of fn, from torch.profiler: the sum of
    the durations of the kernels (and copies) fn launches, over ``calls``
    calls, each after a read of L2_FLUSH_BYTES, so that fn reads its inputs
    from HBM as a caller between other work does (a read, since a write
    would leave the L2 dirty and fn's reads would pay for its write-back);
    the read's own kernels are known by name from a profile of the read
    alone and left out. The host's time between launches does not count,
    so a call whose host work exceeds its kernels is timed by its kernels.
    A profile now and then holds no kernel or loses some (seen on an H100),
    and a sum of durations then reads short, so a reading counts only where
    the read's profile holds kernels and the profile of the calls holds
    ``calls`` times the kernels of a profile of one call; it is taken again
    up to ``tries`` times, and raises RuntimeError after that.
    {"ms", "kernels" a call, "names", "tries": per try the counts above}."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")

    def device_events(n, with_fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                flush.sum()
                if with_fn:
                    fn()
            torch.cuda.synchronize()
        return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]

    fn()
    seen = []
    for _ in range(tries):
        flush_names = {e.name for e in device_events(1, False)}
        one, events = ([[e for e in device_events(n, True) if e.name not in flush_names]
                        for n in (1, calls)] if flush_names else ([], []))
        seen.append([len(flush_names), len(one), len(events)])
        if one and len(events) == calls * len(one):
            break
    else:
        raise RuntimeError(f"device_ms: (read's kernel names, kernels of one call, kernels of "
                           f"{calls} calls) a try {seen}: the profiles lost kernels")
    del flush
    us = sum(e.time_range.end - e.time_range.start for e in events)
    return {"ms": us / calls / 1e3, "kernels": len(one),
            "names": sorted({e.name for e in events}), "tries": seen}


def host_us(fn, calls: int = 20) -> float:
    """Microseconds of the host's time a call of fn takes to return, with
    the card kept busy (a device sleep queued first) so that no call waits
    on it: the wrapper's checks, allocations and launch."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(HOST_SLEEP_CYCLES)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6
