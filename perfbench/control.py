"""The readings the comparison's limits are set from, for one cell over
many seeds in one process (no measured window for training; a short one
of ``--requests`` requests for sampling):

* ``program``: the numbers sound runs of the program give;
* ``fp8``: the control, the reference in float8 in the program's place;
* ``half_batch`` (training): the reference with half of the batch left
  out, the mean taken over the rest, in the program's place;
* ``altered`` (sampling): the program with one image of every answer
  inverted where the serving pass produces it;
* ``--faults`` (training), each on the seeds ``--fault-seeds``: the
  program built and run again with a fault planted (``planted``), and
  checked as a run is.

A step that returns its state unchanged reads 1 on ``change_gap`` by its
definition and needs no run.

    python3 perfbench/control.py --workload itc64.train --seeds 101-112 --out chiprun_out/c.jsonl \
        --faults stale_batch --fault-seeds 101-103

Prints one JSON line per seed and kind, then a summary: the largest
program reading and the smallest of each control and fault per number.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def seed_list(text: str) -> list:
    out = []
    for part in text.split(","):
        if "-" in part:
            a, b = part.split("-")
            out.extend(range(int(a), int(b) + 1))
        else:
            out.append(int(part))
    return out


def invert_one(serve):
    """The serving pass with its first image's values inverted."""
    def altered(z):
        out = serve(z).clone()
        out[0] = 255 - out[0]
        return out
    return altered


@contextlib.contextmanager
def planted(kind: str):
    """The program's train step, broken underneath the harness:
    ``unchanged`` returns the state as it found it (parameters and
    optimizer moments); ``half_batch`` steps on the first half of the
    batch, the mean over the rest (both in the step's body, so its eager
    steps and its replays alike); ``stale_batch`` leaves the graphed
    step's static batch as the capture filled it, so that every replay
    reads that batch again (eager steps are not touched)."""
    from intro_tc_vae_tpu_torch.solvers import intro
    from intro_tc_vae_tpu_torch.solvers.graph import GraphedStep

    build_step, fill = intro.build_intro_step, GraphedStep.fill

    def build(*args, **kwargs):
        step = build_step(*args, **kwargs)

        def unchanged(state, batch, noise=None):
            saved = [p.detach().clone() for p in state.model.parameters()]
            moments = [(st, {k: v.clone() for k, v in st.items() if torch.is_tensor(v)})
                       for opt in (state.opt_e, state.opt_d) for st in opt.state.values()]
            out = step(state, batch, noise)
            with torch.no_grad():
                for p, v in zip(state.model.parameters(), saved):
                    p.copy_(v)
                for st, kept in moments:
                    for k, v in kept.items():
                        st[k].copy_(torch.zeros_like(v) if k.startswith("exp_avg") else v)
            return out

        def half_batch(state, batch, noise=None):
            return step(state, batch[: batch.shape[0] // 2], noise)

        return {"unchanged": unchanged, "half_batch": half_batch}[kind]

    def stale_fill(self, state, batch, noise=None):
        if self.graph is not None:
            batch = self._batch.clone()
        return fill(self, state, batch, noise)

    if kind == "stale_batch":
        GraphedStep.fill = stale_fill
    elif kind in ("unchanged", "half_batch"):
        intro.build_intro_step = build
    else:
        raise ValueError(f"no fault {kind!r}")
    try:
        yield
    finally:
        intro.build_intro_step, GraphedStep.fill = build_step, fill


def readings(cell, seed: int, device, requests: int = 24, faults=()) -> dict:
    """{kind: the comparison's numbers} for one seed; ``faults``: the
    planted faults to run the program with as well (training)."""
    from perfbench.core import spec

    driver = spec.mode_driver(cell.mode)
    out = {}
    with contextlib.redirect_stdout(sys.stderr):
        for fault in faults:
            with planted(fault):
                broken = driver.build(cell, seed, device)
            driver.free(broken)
            out[fault] = driver.check(broken)
            del broken
        s = driver.build(cell, seed, device)
        if cell.mode == "sample":
            for _ in range(requests):
                driver.request(s)
            kept = list(s.kept)
            s.serve = invert_one(s.serve)
            s.kept, s.seen = [], 0
            for _ in range(requests):
                driver.request(s)
            altered, s.kept = s.kept, kept
        driver.free(s)
        out["program"] = driver.check(s)
        out["fp8"] = driver.check(s, "fp8")
        if cell.mode == "train":
            out["half_batch"] = driver.check(s, "half_batch")
        else:
            s.kept = altered
            out["altered"] = driver.check(s)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="e.g. 101-112 or 5,9,200")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--faults", default="", help="planted faults, e.g. stale_batch")
    ap.add_argument("--fault-seeds", default="", help="the seeds the faults run on")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench.core import guard, spec
    from perfbench.run import set_environment

    set_environment(ROOT)
    guard.import_program(ROOT)
    cell = spec.cell(args.workload, ROOT)
    device = torch.device("cuda:0")
    names = list(cell.limits["checks"])
    worst = {}
    sink = open(args.out, "a") if args.out else None
    faults = [f for f in args.faults.split(",") if f]
    fault_seeds = set(seed_list(args.fault_seeds)) if args.fault_seeds else set()
    try:
        for seed in seed_list(args.seeds):
            t0 = time.perf_counter()
            got = readings(cell, seed, device, args.requests,
                           faults if seed in fault_seeds else ())
            for kind, nums in got.items():
                line = json.dumps({"workload": cell.name, "seed": seed, "kind": kind, **nums},
                                  default=str)
                print(line, flush=True)
                if sink:
                    sink.write(line + "\n")
                    sink.flush()
                for n in names:
                    prev = worst.get((kind, n))
                    pick = max if kind == "program" else min
                    worst[(kind, n)] = nums[n] if prev is None else pick(prev, nums[n])
            print(f"seed {seed}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    finally:
        if sink:
            sink.close()
    summary = {f"{kind}.{n}": v for (kind, n), v in sorted(worst.items())}
    print(json.dumps({"workload": cell.name, "summary": summary,
                      "card": torch.cuda.get_device_name(device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
