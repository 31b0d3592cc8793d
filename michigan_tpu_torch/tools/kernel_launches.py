"""The device kernels each call of a bf16 kernel launches, by torch.profiler.

    python -m michigan_tpu_torch.tools.kernel_launches '[["in_act", [1, 256, 256, 64, 64, 2, "relu", false]], ["lowch", [16, 64, 64, 512, 512]]]'

Each case is ``["lowch", [n, c, co, h, w]]`` (conv3x3_same_lowch on a bf16
x with a bf16 weight), ``["in_act", [n, c, co, h, w, dilation, act,
residual]]`` (conv3x3_in_act on a bf16 x_pad with the float32 weight and
bias the bf16 policy hands it) or ``["bank16", [n, h, w]]`` (the filter
bank's forward on bf16 operands, Gabor bank, on a float32 gray plane).  After one warm-up call of every case, one
call per case runs under a single profiler session; the script prints one
JSON object: {device kernel: launches} over all the cases.  It runs in a
process of its own, with one session, because in a process that has held
many profiler sessions (a test run, chip_smoke.py, a dozen calls' own
sessions) the later sessions were seen to list no device kernels at all.
Needs a CUDA card.

``short_name`` shortens the profiler's kernel names; ``sass_mma`` lists the
tensor-core instructions of one kernel of a built library (cuobjdump
-sass), the check that a kernel runs on bf16 tensor-core products.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path


def measure(cases) -> dict:
    """Run `cases` in this process (see the module docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from michigan_tpu_torch.ops import filters
    from michigan_tpu_torch.ops.cuda import epilogue as E
    from michigan_tpu_torch.ops.cuda import lowch as L
    from michigan_tpu_torch.ops.cuda import orient as O

    gen = torch.Generator().manual_seed(0)
    rand = lambda *shape: torch.randn(shape, generator=gen)
    calls = []
    for kind, shape in cases:
        if kind == "lowch":
            n, c, co, h, w = shape
            x = rand(n, c, h, w).relu().cuda().bfloat16()
            wt = (rand(co, c, 3, 3) * math.sqrt(2 / (9 * c))).cuda().bfloat16()
            fn = lambda x=x, wt=wt: L.conv3x3_same_lowch(x, wt)
        elif kind == "bank16":
            n, h, w = shape
            gray = (torch.rand((n, 1, h, w), generator=gen) * 255).cuda()
            bank = filters.bank("gabor", gray.device)
            fn = lambda gray=gray, bank=bank: O.filterbank_orientation(gray, bank, True)
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


def short_name(key: str) -> str:
    """A profiler kernel name without its namespaces, template arguments
    and parameters."""
    return key.split("::", 1)[-1].split("<")[0].split("(")[0].rsplit("::", 1)[-1]


def mma_opcodes(sass: str, kernel: str) -> dict:
    """{tensor-core opcode: count} in the SASS listing `sass` (cuobjdump
    -sass) of the one function whose name contains `kernel`:
    HMMA.16816.F32.BF16 for mma.sync m16n8k16 bf16, HGMMA.* for wgmma,
    HMMA.1688.F32.TF32 for mma.sync m16n8k8 TF32."""
    sections = [sec for sec in sass.split("Function : ")[1:] if kernel in sec.splitlines()[0]]
    if len(sections) != 1:
        raise RuntimeError(f"{len(sections)} functions named like {kernel!r}")
    return dict(Counter(re.findall(r"\b(HG?MMA\.[0-9A-Za-z.]+)", sections[0])))


def sass_mma(path, kernel: str) -> dict:
    """mma_opcodes of `kernel` in the library at `path`."""
    from michigan_tpu_torch.ops.cuda import build

    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(path)], capture_output=True, text=True,
                         check=True).stdout
    return mma_opcodes(out, kernel)


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
