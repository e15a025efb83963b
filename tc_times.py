"""Device time of the three TC kernels of a checkout, by kernel name.

    python3 tc_times.py [--root DIR] [--shapes 64x64 64x128 512x512 2048x2048]

Calls the public wrappers (``ops/tc_cuda.py::tc_logsumexp_cuda``, and
``tc_logsumexp_cuda_gathered`` where the rows are fewer than the bank)
forward and backward on seeded inputs at Z = 128 and reads each kernel's
device time from ``torch.profiler`` (mean over the profiled calls), so it
depends on nothing but the wrappers' signatures: ``--root`` names another
checkout of this repository (an older commit unpacked with ``git archive``)
whose kernels are built and timed instead, which is how two versions of a
kernel are compared on one card in one call (old, new, new, old). A shape is
ROWSxBANK: 64x128 is a rank's 64 rows against a gathered bank of 128. Needs
one CUDA card and ``nvcc``; prints the card's name and power limit, then one
JSON object per shape, in ms per launch.
"""

import argparse
import json
import os
import subprocess
import sys


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    parser.add_argument("--shapes", nargs="+",
                        default=["64x64", "64x128", "512x512", "2048x2048"])
    parser.add_argument("--calls", type=int, default=20)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from intro_tc_vae_tpu_torch.ops import tc_cuda

    if not torch.cuda.is_available():
        sys.exit("tc_times: needs a CUDA GPU")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(f"tc_times: kernels of {os.path.abspath(args.root)} on {card}")
    zdim = 128
    for shape in args.shapes:
        b, gb = (int(v) for v in shape.split("x"))
        rng = np.random.RandomState(gb)
        z, mu, logvar = (torch.tensor(a.astype(np.float32), device=dev, requires_grad=True)
                         for a in (rng.randn(b, zdim), rng.randn(gb, zdim),
                                   rng.randn(b, zdim) * 2.8))
        n = max(1280, 20 * gb)  # the stratified weights need N >= the bank

        def call():
            if b == gb:
                pm, qz = tc_cuda.tc_logsumexp_cuda(z, mu, logvar, n)
            else:  # the rows are the bank's last b
                pm, qz = tc_cuda.tc_logsumexp_cuda_gathered(z, mu, logvar, gb - b, n, gb)
            loss = (qz - pm).sum() / gb + 0.5e-3 * pm.sum()
            torch.autograd.grad(loss, (z, mu, logvar))

        for _ in range(3):
            call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.calls):
                call()
            torch.cuda.synchronize()
        times = {}
        for event in prof.key_averages():
            for name in tc_cuda.KERNELS:
                if name in event.key:
                    times[name] = event.self_device_time_total / event.count / 1e3
        if set(times) != set(tc_cuda.KERNELS):
            sys.exit(f"tc_times: the profiler saw {sorted(times)} of {tc_cuda.KERNELS}")
        print(json.dumps({"rows": b, "bank": gb, "Z": zdim,
                          **{k: round(v, 5) for k, v in times.items()}}), flush=True)


if __name__ == "__main__":
    main()
