"""Where ``gf2_serial_reduce``'s time goes on the card: a probe.

    python3 tools/serial_phases_probe.py      # from the repo root; one card

It copies ``src/repro_torch/kernels/csrc/gf2.cu`` into the build directory,
inserts ``clock64()`` stamps (first thread of block 0) at five points of
``gf2_serial_reduce_kernel`` (start, rows loaded, first lows, walk done, rows
written back), builds that copy with the port's nvcc flags and runs it on
serial blocks of 128 rows at 256, 896 and 2176 words.  Each case prints one
JSON line: its route, reductions, the cycles of the load, the first lows,
the walk and the write-back, the instrumented build's device time and the
SM clock under it.  Each result is held exact against
``gf2_serial_reduce_plain``.  The shipped kernel is not built this way; the
stamps cost a few cycles each, so the split, not the total, is the reading.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (cap, planted rows, seed) for chip_smoke.serial_block at 128 rows: 256,
# 896 and 2176 words.
CASES = ((128, 0, 8), (128, 16, 8), (128, 96, 8), (860, 16, 9),
         (2048, 0, 8), (2048, 16, 8), (2048, 96, 8))

# Each stamp goes before the first line that starts with its anchor (after
# it, for stamp 0); every anchor must occur once in the kernel's source.
STAMPS = ((0, "  uint32_t* rows = ONCHIP ? blk : dst;", True),
          (1, "  // 1. Every row's initial low", False),
          (2, "  // 2. The walk.", False),
          (3, "  // The rows (this rank's slice) back, once", False),
          (4, "  // No rank may leave while another", False))

HEADER = """
__device__ unsigned long long gf2_serial_stamps[5];
#define SERIAL_STAMP(i) \\
  if (blockIdx.x == 0 && threadIdx.x == 0) gf2_serial_stamps[i] = clock64()
"""
READER = """
extern "C" int gf2_serial_stamps_read(void* out) {
  return (int)cudaMemcpyFromSymbol(out, gf2_serial_stamps,
                                   sizeof(gf2_serial_stamps));
}
"""


def instrumented(source: str) -> str:
    """``source`` with the stamps, their array and a reader inserted."""
    lines = source.splitlines()
    for i, anchor, after in reversed(STAMPS):
        at = [n for n, ln in enumerate(lines) if ln.startswith(anchor)]
        if len(at) != 1:
            raise AssertionError(f"anchor {anchor!r} found {len(at)} times")
        lines.insert(at[0] + int(after), f"  SERIAL_STAMP({i});")
    first = next(n for n, ln in enumerate(lines)
                 if ln.startswith("constexpr uint16_t kNoRow"))
    lines.insert(first, HEADER)
    return "\n".join(lines) + "\n" + READER


def build(_build) -> ctypes.CDLL:
    out = _build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "gf2_phases.cu"
    src.write_text(instrumented((_build.CSRC / "gf2.cu").read_text()))
    lib_path = out / "libgf2_phases.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                    str(lib_path), str(src)], check=True, capture_output=True,
                   text=True, timeout=600)
    return ctypes.CDLL(str(lib_path))


def main() -> int:
    if not torch.cuda.is_available():
        print("serial_phases_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build, gf2

    dev = torch.device("cuda")
    print(cs.nvidia_smi(), flush=True)
    lib = build(_build)
    lib.gf2_serial_reduce.argtypes = list(gf2._SIGNATURES["gf2_serial_reduce"])
    lib.gf2_serial_reduce.restype = ctypes.c_int
    lib.gf2_serial_stamps_read.argtypes = [ctypes.c_void_p]
    lib.gf2_serial_stamps_read.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    for cap, planted, seed in CASES:
        rng = np.random.default_rng(seed)
        t = gf2.to_tensor(cs.serial_block(rng, 128, cap, planted)[None], dev)
        G, C, W = t.shape
        plan = gf2.serial_plan(C, W)
        got = (torch.empty_like(t),
               torch.empty((G, C), dtype=torch.int32, device=dev),
               torch.empty(G, dtype=torch.int32, device=dev))

        def call():
            err = lib.gf2_serial_reduce(t.data_ptr(), got[0].data_ptr(),
                                        got[1].data_ptr(), got[2].data_ptr(),
                                        G, C, W, plan.k, plan.S, plan.threads,
                                        stream)
            _build.check_launch(err, "gf2_serial_reduce (instrumented)")

        call()
        torch.cuda.synchronize()
        want = gf2.gf2_serial_reduce_plain(t)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"instrumented build differs at 128x{W}, "
                                 f"{planted} planted")
        stamps = (ctypes.c_ulonglong * 5)()
        if lib.gf2_serial_stamps_read(stamps) != 0:
            raise AssertionError("reading the phase stamps failed")
        cyc = [int(stamps[i + 1] - stamps[i]) for i in range(4)]
        cs.emit("serial_phases", shape=[G, C, W], route=plan.route, k=plan.k,
                planted=planted, n_reductions=int(want[2].sum()),
                cycles=dict(load=cyc[0], first_lows=cyc[1], walk=cyc[2],
                            write_back=cyc[3]),
                kernel_ms=cs.device_ms(call, 50, cs.SERIAL_SYMBOL),
                clocks=cs.clocks_under(call, 1.0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
