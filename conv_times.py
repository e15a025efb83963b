"""Device time of the bf16 3x3 conv kernels of a checkout, by kernel.

    python3 conv_times.py [--root DIR] [--shapes 128x64x64 64x64x36 ...]

Calls the public wrappers (``ops/conv_cuda.py::conv3x3_fwd`` and
``conv3x3_dw``) on seeded bf16 activations [N, 64, H, W] (a shape is
NxHxW) and reads each kernel's device time from ``torch.profiler`` (mean
over the profiled calls), so it depends on nothing but the wrappers'
signatures: ``--root`` names another checkout of this repository (an older
commit unpacked with ``git archive``) whose kernels are built and timed
instead, which is how two versions of a body are compared on one card in
one call (old, new, new, old). The forward is every kernel whose name
holds ``conv3x3_fwd``, dW every ``conv3x3_dw`` but the reduce, so
whichever body a checkout routes the shape to is the one timed (its name
is printed). Needs one CUDA card and ``nvcc``; prints the card's name and
power limit, then one JSON object per shape, in ms per launch.
"""

import argparse
import json
import os
import subprocess
import sys

SHAPES = ["128x64x64", "128x32x32", "8x128x128", "128x48x48", "64x64x36", "8x64x96",
          "1x16x1016", "2x16x6", "3x20x36"]


def kernel_of(name: str):
    """The column a profiled kernel's name is counted in, or None."""
    for col, part in (("reduce", "conv3x3_dw_reduce"), ("pack", "conv3x3_pack_w"),
                      ("fwd", "conv3x3_fwd"), ("dw", "conv3x3_dw")):
        if part in name:
            return col
    return None


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    parser.add_argument("--shapes", nargs="+", default=SHAPES)
    parser.add_argument("--calls", type=int, default=20)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from intro_tc_vae_tpu_torch.ops import conv_cuda

    if not torch.cuda.is_available():
        sys.exit("conv_times: needs a CUDA GPU")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(f"conv_times: kernels of {os.path.abspath(args.root)} on {card}")
    for shape in args.shapes:
        n, h, w = (int(v) for v in shape.split("x"))
        gen = torch.Generator(device=dev).manual_seed(n * h * w)
        x = torch.randn((n, 64, h, w), device=dev, generator=gen).bfloat16()
        gy = torch.randn((n, 64, h, w), device=dev, generator=gen).bfloat16()
        wt = (torch.randn((64, 64, 3, 3), device=dev, generator=gen) * 0.05).bfloat16()

        def call():
            conv_cuda.conv3x3_fwd(x, wt)
            conv_cuda.conv3x3_dw(x, gy)

        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=2, warmup=1, active=args.calls)) as prof:
            for _ in range(args.calls + 3):
                call()
                torch.cuda.synchronize()
                prof.step()
        times, names = {}, {}
        for event in prof.key_averages():
            col = kernel_of(event.key)
            if col is not None and event.self_device_time_total > 0:
                times[col] = times.get(col, 0.0) + event.self_device_time_total / args.calls / 1e3
                names.setdefault(col, []).append(event.key[:90])
        if set(times) - {"pack"} != {"fwd", "dw", "reduce"}:
            sys.exit(f"conv_times: {shape}: the profiler saw {sorted(names.values())}")
        print(json.dumps({"shape": [n, 64, h, w], **{k: round(v, 5) for k, v in times.items()},
                          "kernels": names}), flush=True)


if __name__ == "__main__":
    main()
