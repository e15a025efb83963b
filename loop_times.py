"""Host-clock img/s and device ms per step of the flagship's four arms.

    python3 loop_times.py [--root DIR] [--reps 2]

For each (tc_impl, conv_impl) arm of ``chip_smoke.py`` phase 4 (the
flagship recipe on the synthetic dataset, one epoch of 20 steps through the
CLI), ``--reps`` times: one run read by the host clock, as phase 4 reads it
(``train.images_per_second``, the steps after the first 3), and one run
profiled by this checkout's ``chip_smoke.profiled_steps``, as
``chip_smoke.py --device-time`` profiles it (the device time of 5 steady
steps). Their difference is what the host adds to a step. ``--root`` names
another checkout of this repository (an older commit unpacked with
``git archive``), whose ``chip_smoke.py`` builds and runs its own package
instead, so two versions of the train loop are compared on one card in one
call (old, new, new, old), each profiled the same way. Needs one CUDA card
and ``nvcc``; prints the card's name and power limit and, last, one JSON
object.
"""

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=HERE)
    parser.add_argument("--reps", type=int, default=2)
    args = parser.parse_args()
    root = os.path.abspath(args.root)

    import chip_smoke as here  # this checkout's: the profiled step both sides use

    cs = here
    if root != HERE:  # the other checkout's script, which imports its own package
        spec = importlib.util.spec_from_file_location(
            "chip_smoke_root", os.path.join(root, "chip_smoke.py"))
        cs = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(cs)
    sys.path.insert(0, root)
    os.chdir(root)

    _, card = cs.start()  # builds the checkout's kernels; prints the card and its limit
    from intro_tc_vae_tpu_torch.train import images_per_second

    arms = {}
    for _ in range(args.reps):
        for tc_impl, conv_impl in cs.INTRO_ARMS:
            arm = f"tc {tc_impl}, conv {conv_impl}"
            update = {"dataset": "synthetic", "tc_impl": tc_impl, "conv_impl": conv_impl,
                      "num_epochs": 1, "use_tensorboard": False}
            rate = images_per_second(cs.run_cli(cs.FLAGSHIP, update, arm), cs.MAIN_B)
            device_us = sum(here.profiled_steps(
                lambda: cs.run_cli(cs.FLAGSHIP, update, arm)).values())
            arms.setdefault(arm, []).append({
                "img_s": rate, "host_ms_step": 1e3 * cs.MAIN_B / rate,
                "device_ms_step": device_us / here.PROFILED_STEPS / 1e3})
    print(json.dumps({"root": root, "card": card, "arms": arms}))


if __name__ == "__main__":
    main()
