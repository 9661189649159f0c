#!/usr/bin/env python3
"""Which of kernel I's launches does torch.profiler record?

    python3 tools/kernel_i_records.py

Run from the root of a checkout, on one CUDA card. In one fresh process:
cloth_wind40_seq (chip_smoke's sequential-wind sheet) captured, then one
profiler window each over run(1), run(2), one eager step (_run_eager(1)),
the wind's project() alone (one eager launch of kernel I) and run(1) again.
Prints each window's device events by name and the port's kernels as
chip_smoke.port_kernel_counts counts them from the records (not kernel I's
own device counter).
"""

import collections
import os
import sys

os.environ["TEARDOWN_CUPTI"] = "0"  # as chip_smoke.main sets it

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402


def window(fn, label):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    print("==", label, len(ev), "device events")
    for name, n in collections.Counter(e.name[:140] for e in ev).most_common():
        print("   ", n, name)
    print("   counted", cs.port_kernel_counts(prof.events()))


def main():
    if not torch.cuda.is_available():
        print("kernel_i_records: needs a CUDA card", file=sys.stderr)
        return 2
    print(cs.environment(torch)["gpu"])
    cs.profiler_warmup(torch)
    s = cs.make_cloth_solver(cs.WIND_SEQ_PATH)[0]
    s.run(0)
    window(lambda: s.run(1), "run(1)")
    window(lambda: s.run(2), "run(2)")
    window(lambda: s._run_eager(1), "eager 1")
    wind = s.ext_forces[0]
    window(lambda: wind.project(1 / 24, s.state.x, s.state.v, None), "wrapper alone")
    window(lambda: s.run(1), "run(1) again")
    return 0


if __name__ == "__main__":
    sys.exit(main())
