"""What the card scripts and ``chip_smoke.py`` share: the card's name and
power limit as nvidia-smi gives them, the seeded DiT's gates, and a short
call's device time and host time."""

from __future__ import annotations

import subprocess
import time

import torch

L2_FLUSH_BYTES = 128 << 20  # read before each timed call: over twice the H100's 50 MB L2
HOST_SLEEP_CYCLES = 200_000_000  # ~0.1 s of the card asleep while host time is taken
# the host's pause at each end of a device_ms profile: before its first launch
# and after the card has finished its last kernel
PROFILE_MARGIN_S = 0.1
# the records of one kernel name a device_ms try may lose and still count
LOST_RECORDS = 2


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


def records_by_name(profiles: list, calls: int):
    """From fn's (name, µs) records in profiles of ``calls`` and 2 x
    ``calls`` calls: ({name: (its count a call, its µs a call)}, the
    records lost), or None where a profile lacks a name, a count is not
    whole or a name lost more than LOST_RECORDS records. A name's count a
    call is its records over 3 x ``calls`` rounded; its time the count
    times the mean of its kept durations."""
    names = {n for p in profiles for n, _ in p}
    if not names or any({n for n, _ in p} != names for p in profiles):
        return None
    durations = {n: [us for p in profiles for m, us in p if m == n] for n in names}
    per_call = {n: round(len(d) / (3 * calls)) for n, d in durations.items()}
    lost = {n: per_call[n] * 3 * calls - len(d) for n, d in durations.items()}
    if any(per_call[n] < 1 or not 0 <= lost[n] <= LOST_RECORDS for n in names):
        return None
    return ({n: (per_call[n], per_call[n] * sum(d) / len(d)) for n, d in durations.items()},
            sum(lost.values()))


def records_known(profiles: list, calls: int, counts: dict):
    """``records_by_name`` where the program counts its own launches: from
    fn's (name, µs) records in profiles of ``calls`` and 2 x ``calls``
    calls and each name's launches a call (``counts``), ({name: its µs a
    call, the count times the mean of its kept durations}, the records
    lost), or None where a name has no record, more records than its count
    allows, or lost more than LOST_RECORDS."""
    out, lost = {}, 0
    for n, c in counts.items():
        d = [us for p in profiles for m, us in p if m == n]
        miss = 3 * calls * c - len(d)
        if not d or not 0 <= miss <= LOST_RECORDS:
            return None
        out[n] = c * sum(d) / len(d)
        lost += miss
    return out, lost


def records_a_call(profiles: list, calls: int):
    """``records_by_name`` summed: (µs a call, each name's count a call,
    the records lost), or None."""
    got = records_by_name(profiles, calls)
    if got is None:
        return None
    by_name, lost = got
    return (sum(us for _, us in by_name.values()), {n: c for n, (c, _) in by_name.items()},
            lost)


# the L2 read's kernel names seen so far in this process (the same reduction of
# the same size at every call): a profile that lost all of one name's records
# must not let that name count as fn's
_flush_names: set = set()


def device_ms(fn, calls: int = 20, tries: int = 10) -> dict:
    """The device's time for one call of fn, from torch.profiler's kernel
    (and copy) records, over ``calls`` calls, each after a read of
    L2_FLUSH_BYTES, so that fn reads its inputs from HBM as a caller between
    other work does (a read, since a write would leave the L2 dirty and fn's
    reads would pay for its write-back); the read's own kernels are known by
    name from a profile of ``calls`` reads alone (with every name such a
    profile showed earlier in the process) and left out. The host's
    time between launches does not count, so a call whose host work exceeds
    its kernels is timed by its kernels.

    The profiler can lose records (seen on an H100: one or two of a
    profile's, now and then all of them, more often the longer the process
    has run; one was still lost behind a 10 ms device sleep at a profile's
    start; late in a long run the reads' profile of every try of one call
    lost one of the read's two kernel names, which then counted as fn's,
    hence the names kept across the process; in two long runs every try of
    one reading lost 2 of fn's records in each profile without
    PROFILE_MARGIN_S of the host idle at each end of a profile, and read
    on the first try with it). The cause is not established. So a reading
    does not need every record: ``records_a_call`` over two profiles, of
    ``calls`` and 2 x ``calls`` calls. A try that it refuses is taken again,
    up to ``tries`` times, and RuntimeError is raised after that.
    {"ms", "kernels" a call, "names", "tries": per try (the read's names,
    fn's records in each profile, the records lost or None)}."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")

    def device_events(n, with_fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_MARGIN_S)
            for _ in range(n):
                flush.sum()
                if with_fn:
                    fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_MARGIN_S)
        return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]

    fn()
    seen = []
    for _ in range(tries):
        flush_names = {e.name for e in device_events(calls, False)}
        _flush_names.update(flush_names)
        profiles = [[(e.name, e.time_range.end - e.time_range.start)
                     for e in device_events(n, True) if e.name not in _flush_names]
                    for n in (calls, 2 * calls)] if flush_names else [[], []]
        got = records_a_call(profiles, calls)
        seen.append([len(flush_names), [len(p) for p in profiles], got and got[2]])
        if got:
            break
    else:
        raise RuntimeError(f"device_ms: (read's kernel names, fn's records in profiles of "
                           f"{calls} and {2 * calls} calls, records lost) a try {seen}: the "
                           "profiles lost too many records")
    del flush
    us, per_call, _ = got
    return {"ms": us / 1e3, "kernels": sum(per_call.values()), "names": sorted(per_call),
            "tries": seen}


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
