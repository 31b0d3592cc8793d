"""The device kernels each bf16 3x3 convolution call launches, by torch.profiler.

    python -m michigan_tpu_torch.tools.kernel_launches '[["in_act", [1, 256, 256, 64, 64, 2, "relu", false]], ["lowch", [16, 64, 64, 512, 512]]]'

Each case is ``["lowch", [n, c, co, h, w]]`` (conv3x3_same_lowch on a bf16
x with a bf16 weight) or ``["in_act", [n, c, co, h, w, dilation, act,
residual]]`` (conv3x3_in_act on a bf16 x_pad with the float32 weight and
bias the bf16 policy hands it).  After one warm-up call of every case, one
call per case runs under a single profiler session; the script prints one
JSON object: {device kernel: launches} over all the cases.  It runs in a
process of its own, with one session, because in a process that has held
many profiler sessions (a test run, chip_smoke.py, a dozen calls' own
sessions) the later sessions were seen to list no device kernels at all.
Needs a CUDA card.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from pathlib import Path


def measure(cases) -> dict:
    """Run `cases` in this process (see the module docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from michigan_tpu_torch.ops.cuda import epilogue as E
    from michigan_tpu_torch.ops.cuda import lowch as L

    gen = torch.Generator().manual_seed(0)
    rand = lambda *shape: torch.randn(shape, generator=gen)
    calls = []
    for kind, shape in cases:
        if kind == "lowch":
            n, c, co, h, w = shape
            x = rand(n, c, h, w).relu().cuda().bfloat16()
            wt = (rand(co, c, 3, 3) * math.sqrt(2 / (9 * c))).cuda().bfloat16()
            fn = lambda x=x, wt=wt: L.conv3x3_same_lowch(x, wt)
        else:
            n, c, co, h, w, d, act, res = shape
            x = rand(n, c, h + 2 * d, w + 2 * d).cuda().bfloat16()
            wt = (rand(co, c, 3, 3) * 0.05).cuda()
            b = rand(co).cuda()
            r = rand(n, co, h, w).cuda().bfloat16() if res else None
            fn = lambda x=x, wt=wt, b=b, d=d, act=act, r=r: E.conv3x3_in_act(
                x, wt, b, dilation=d, act=act, residual=r)
        fn()
        calls.append(fn)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in calls:
            fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages() if e.device_time_total > 0}


def run(cases, timeout=600) -> dict:
    """`measure(cases)` in a fresh Python process; raises if it fails."""
    root = Path(__file__).resolve().parents[2]
    proc = subprocess.run([sys.executable, "-m", "michigan_tpu_torch.tools.kernel_launches",
                           json.dumps(cases)], cwd=root, capture_output=True, text=True,
                          timeout=timeout, env={**os.environ, "PYTHONPATH": str(root)})
    if proc.returncode != 0:
        raise RuntimeError(f"kernel_launches failed:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    print(json.dumps(measure(json.loads(argv[0]))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
