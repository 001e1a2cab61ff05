"""Which device events ``torch.profiler`` loses, and what keeps them: a probe.

    python3 tools/profiler_window_probe.py [--seconds S] [--after-kernels]

from the repo root, on one card.  ``--after-kernels`` first runs
``chip_smoke.check_kernels`` in the same process, the history the smoke
run's ``prefill_copies`` window has behind it.

It builds the port's kernels and profiles windows of ten ``_flash_prefill``
calls at ``chip_smoke.py``'s ``prefill_copies`` shape (qwen3-0.6b: 8 x 2048
tokens, 16 query heads, 8 KV heads of 128, bf16), as ``chip_smoke.profiled``
does (host and CUDA activity).  The cases: a host sleep of ``PAD_S`` after
the profiler starts (``start``), before it stops (``end``), at both or at
neither; and ``lead``, both sleeps and then ``LEAD`` launches of
``torch.cuda._sleep(0)`` (``spin_kernel``) before the calls.  A call
launches one flash kernel and its layout copies; the wrapper's counter says
how many flash launches each window made.  Each case prints one JSON line:
for each window, the launches counted, the flash kernels, the other device
events and the spin kernels profiled, the window's events in start order as
a pattern (``s`` a spin kernel, ``c`` a copy, ``F`` a flash kernel;
``cccccF`` a call: the two KV heads' repeats and the three layout copies
come first), and the gap from the window's first host operation to its
first device event.  The cases repeat in rounds, each round after one long
window of ``LONG_CALLS`` calls, for ``--seconds`` of the process's life.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLASH_SM90 = "flash_attention_kernel_sm90"
SPIN = "spin_kernel"
CALLS = 10
WINDOWS = 3
LONG_CALLS = 200
DURATION_S = 180.0
PAD_S = 0.02
LEAD = 16
# (name, sleep after start, sleep before stop, spin launches first)
CASES = (("none", False, False, 0), ("start", True, False, 0),
         ("end", False, True, 0), ("both", True, True, 0),
         ("lead", True, True, LEAD))


def window(fn, pad_start: bool, pad_end: bool, lead: int):
    """The device events of one profiled window, in start order, and the
    µs from its first host operation to its first device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA,
                             ProfilerActivity.CPU]) as prof:
        if pad_start:
            time.sleep(PAD_S)
        for _ in range(lead):
            torch.cuda._sleep(0)
        fn()
        torch.cuda.synchronize()
        if pad_end:
            time.sleep(PAD_S)
    evs = prof.events()
    dev = sorted((ev for ev in evs if ev.device_type == DeviceType.CUDA
                  and not getattr(ev, "is_user_annotation", False)),
                 key=lambda ev: ev.time_range.start)
    host = [ev.time_range.start for ev in evs
            if ev.device_type == DeviceType.CPU]
    gap = dev[0].time_range.start - min(host) if dev and host else None
    return dev, gap


def kind(name: str) -> str:
    return "F" if FLASH_SM90 in name else "s" if SPIN in name else "c"


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=DURATION_S)
    ap.add_argument("--after-kernels", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profiler_window_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.attention import _flash_prefill

    _build.build()
    dev = torch.device("cuda")
    if args.after_kernels:
        sys.path.insert(0, ROOT)
        import chip_smoke

        chip_smoke.check_kernels(dev)
    rng = np.random.default_rng(0)
    b, s, h, kvh, hd = 8, 2048, 16, 8, 128
    q = torch.as_tensor(rng.normal(size=(b, s, h, hd)), dtype=torch.bfloat16,
                        device=dev)
    k, v = (torch.as_tensor(rng.normal(size=(b, s, kvh, hd)),
                            dtype=torch.bfloat16, device=dev)
            for _ in range(2))

    def calls():
        for _ in range(CALLS):
            _flash_prefill(q, k, v, -1, True)

    calls()
    torch.cuda.synchronize()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__}), flush=True)
    t0 = time.monotonic()
    while time.monotonic() - t0 < args.seconds:
        window(lambda: [calls() for _ in range(LONG_CALLS // CALLS)],
               False, False, 0)
        for name, pad_start, pad_end, lead in CASES:
            rows = []
            for _ in range(WINDOWS):
                flash_attention.launches = 0
                evs, gap = window(calls, pad_start, pad_end, lead)
                pattern = "".join(kind(ev.name) for ev in evs)
                rows.append(dict(counted=flash_attention.launches,
                                 flash=pattern.count("F"),
                                 other=pattern.count("c"),
                                 spin=pattern.count("s"), pattern=pattern,
                                 gap_us=gap))
            print(json.dumps(dict(
                after_kernels=args.after_kernels,
                at_s=round(time.monotonic() - t0, 1), case=name,
                pad_s=PAD_S, lead=lead, calls=CALLS, windows=rows,
                short_flash=sum(r["flash"] < r["counted"] for r in rows))),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
