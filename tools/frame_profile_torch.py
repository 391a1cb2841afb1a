"""Where a stage-6 frame's time goes on a CUDA GPU (rayito_tpu_torch).

Renders chip_smoke.py's stage-6 frame (n=64 bumpy stand-in, 512x512,
sample 0 over both 256-row bands) once to warm up, times three frames on
the host clock, then profiles one frame with torch.profiler and prints:

  * the card (nvidia-smi name and power limit) and the frame time;
  * device time summed over kernels, and the busy share of the frame;
  * the number of kernel launches per frame;
  * the twelve kernels that take the most device time.

Run from the repo root on a machine with a GPU:
``python3 tools/frame_profile_torch.py``.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import stage6_setup

    if not torch.cuda.is_available():
        print("no CUDA device: nothing to profile", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    _, _, _, frame = stage6_setup(torch.device("cuda", 0))
    frame()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        frame()
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) / 3 * 1e3

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    # kernel rows only: an operator row repeats its kernels' device time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    launches = sum(e.count for e in prof.key_averages()
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC"))
    print(f"card: {card}")
    print(f"frame: {frame_ms:.1f} ms (host clock, mean of 3); "
          f"{prof_ms:.1f} ms under the profiler")
    print(f"device time: {device_ms:.1f} ms over kernels: "
          f"{100 * device_ms / frame_ms:.1f}% of the unprofiled frame, "
          f"{100 * device_ms / prof_ms:.1f}% of the profiled one")
    print(f"kernel launches per frame: {launches}")
    events.sort(key=lambda e: -e.self_device_time_total)
    for e in events[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  "
              f"{e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
