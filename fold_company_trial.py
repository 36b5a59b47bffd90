#!/usr/bin/env python3
"""Phase 18 (b)'s time with and without phase 22 beside it, on one CUDA card.

    python3 fold_company_trial.py [arm ...]    arms: with, without
                                               (default: without with without with)

chip_smoke.py runs phase 17 with phase 18 (b) beside it on a thread and,
from the end of phase 17 on, phases 19 (a), 20, 21 and 22, each in a
process of its own, beside the rest of 18 (b).  This script builds what
chip_smoke.py's phase 1 builds (the kernel library and the BLS12-381 C
tier), then runs that part of the schedule once per arm, each arm in a
fresh process, in the order given: `with` starts the four children at the
end of phase 17, `without` the same children but phase 22.  The phases
keep their checks.  Prints one line "TRIAL {json}" per arm: the arm, the
seconds of 17 (a), 17 (b), 18 (b) and of the whole arm, and each child's
seconds (host clock), with the card's name and power limit; then the same
lines again, together, at the end.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ARMS = {"with": ("19 a", "20", "21", "22"), "without": ("19 a", "20", "21")}


def run_arm(arm: str) -> dict:
    import torch

    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from tendermint_tpu_torch.ops import _build

    card = cs.card_line()
    t0 = time.perf_counter()
    _build.lib()
    cs.bls_tier_built(t0, card)
    report = {k: {"launches": 0} for k in cs.launch_counts()}
    kids = {}

    def start_kids():
        kids.update((tag, cs.PhaseChild(tag, "child_phase", tag, card)) for tag in ARMS[arm])

    t0 = time.perf_counter()
    try:
        out = cs.run_chaos_rotation(card, torch.device("cuda"), "ed25519_ladder", report,
                                    after_17=start_kids)
    finally:
        _, failed = cs.join_kids(kids)
    if failed:
        raise failed[0]
    return {"arm": arm, **out, "whole": time.perf_counter() - t0,
            "children": {tag: kid.s for tag, kid in kids.items()}, "card": card}


def main(argv) -> int:
    try:
        import torch
    except ImportError:
        print("fold_company_trial: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("fold_company_trial: no CUDA device", file=sys.stderr)
        return 2
    if argv[:1] == ["--arm"]:
        print("TRIAL " + json.dumps(run_arm(argv[1])), flush=True)
        return 0
    arms = argv or ["without", "with", "without", "with"]
    if any(a not in ARMS for a in arms):
        print(f"fold_company_trial: arms are {sorted(ARMS)}", file=sys.stderr)
        return 2
    trials = []
    for arm in arms:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--arm", arm],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                cwd=HERE)
        for line in proc.stdout:
            print(line, end="", flush=True)
            if line.startswith("TRIAL "):
                trials.append(line)
        if proc.wait() != 0:
            print(f"fold_company_trial: arm {arm} exited {proc.returncode}", file=sys.stderr)
            return 1
    print("".join(trials), end="")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
