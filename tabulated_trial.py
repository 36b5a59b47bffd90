#!/usr/bin/env python3
"""Design trial of kernel 3 (the tabulated sum) on one CUDA card.

    python3 tabulated_trial.py [variant ...]      (default: every variant)

Each variant is the committed tendermint_tpu_torch/csrc/ed25519_table.cu with
a few lines replaced, built from a copy of the package under build/trial/
(all builds at once).  Then, one variant after another in the order given
(a name may repeat, to interleave), each is held against the plain version
on chip_smoke.py's input mix at B = 1, 7 and 1021 (tolerance 0; the run
fails on any difference) and timed by CUDA events at B = V = 10,000, with
the ladder (kernel 1) timed beside it as a yardstick within the run.  The
timing inputs are random limbs: the kernels do the same work for any data.
Prints one line "TRIAL {json}" per run: ms of three means of 10 launches,
registers, stack and spill bytes, threads and resident warps per SM, card.

Variants:
  committed    two quads per signature, 128-thread blocks, finish on one
               thread per signature
  quad_finish  the finish on every lane of both quads (quad_finish), as the
               ladder finishes, 64-thread blocks
  quad_finish_128   the same with 128-thread blocks
  one_quad     one quad per signature (kSumQuads = 1)
  one_quad_finish   one quad per signature finishing on its four lanes,
               64-thread blocks
  four_quads   four quads per signature, 256-thread blocks
  threads_64, threads_256   other block sizes
  l1_carveout  the L1-heavy shared-memory carveout
  regs_128, regs_102        register caps by __launch_bounds__ minimum blocks
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
TRIAL_DIR = os.path.join(HERE, "build", "trial")
SOURCE = os.path.join("tendermint_tpu_torch", "csrc", "ed25519_table.cu")

_FINISH_START = "  // The finish runs once per signature"
_FINISH_END = "r_out != nullptr ? r_out + 32 * (size_t)f : nullptr);\n"
_QUAD_FINISH = """  quad_finish(acc, j, live && quad == 0, r_y + 20 * (size_t)ic, r_sign[ic], ok + ic,
              r_out != nullptr ? r_out + 32 * (size_t)ic : nullptr);
"""
_THREADS = "constexpr int kSumThreads = 128;"
_QUADS = "constexpr int kSumQuads = 2;"
_BOUNDS = "__global__ void __launch_bounds__(kSumThreads)\n    tabulated_kernel"
_LAUNCH = "  const Grid g = grid(2, batch);\n  tabulated_kernel<<<"
_CARVEOUT = """  static const cudaError_t carveout = cudaFuncSetAttribute(
      tabulated_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxL1);
  if (carveout != cudaSuccess) return (int)carveout;
"""

VARIANTS = {
    "committed": [],
    "quad_finish": [("finish", _QUAD_FINISH), (_THREADS, "constexpr int kSumThreads = 64;")],
    "quad_finish_128": [("finish", _QUAD_FINISH)],
    "one_quad": [(_QUADS, "constexpr int kSumQuads = 1;")],
    "one_quad_finish": [(_QUADS, "constexpr int kSumQuads = 1;"), ("finish", _QUAD_FINISH),
                        (_THREADS, "constexpr int kSumThreads = 64;")],
    "four_quads": [(_QUADS, "constexpr int kSumQuads = 4;"),
                   (_THREADS, "constexpr int kSumThreads = 256;")],
    "threads_64": [(_THREADS, "constexpr int kSumThreads = 64;")],
    "threads_256": [(_THREADS, "constexpr int kSumThreads = 256;")],
    "l1_carveout": [(_LAUNCH, _CARVEOUT + _LAUNCH)],
    "regs_128": [(_BOUNDS, _BOUNDS.replace("(kSumThreads)", "(kSumThreads, 4)"))],
    "regs_102": [(_BOUNDS, _BOUNDS.replace("(kSumThreads)", "(kSumThreads, 5)"))],
}


def make_variant(name: str) -> str:
    """A copy of the package whose kernel 3 source carries the variant's
    edits; returns the directory to put first on sys.path."""
    root = os.path.join(TRIAL_DIR, name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "tendermint_tpu_torch"),
                    os.path.join(root, "tendermint_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = os.path.join(root, SOURCE)
    with open(path) as f:
        src = f.read()
    for old, new in VARIANTS[name]:
        if old == "finish":
            a, b = src.index(_FINISH_START), src.index(_FINISH_END) + len(_FINISH_END)
            src = src[:a] + new + src[b:]
        else:
            if old not in src:
                raise KeyError(f"{name}: {old!r} not in {SOURCE}")
            src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)
    return root


def run_variant(root: str, name: str) -> None:
    """In a child process whose sys.path starts at the variant's copy."""
    sys.path.insert(0, root)
    sys.path.insert(1, HERE)
    import numpy as np
    import torch

    import chip_smoke as cs
    from tendermint_tpu_torch.ops import _build, ed25519_cuda, ed25519_table

    lib = _build.lib()
    with open(_build.ptxas_log_path()) as f:
        res = _build.resources_of("tabulated_kernel", f.read())
    report = {n: {"name": n} for n in ("ed25519_ladder", "ed25519_tabulated",
                                       "ed25519_window_tables")}
    dev = torch.device("cuda")
    cs.phase_kernels(np.random.default_rng(2024), cs.make_keys(cs.TABLE_VALIDATORS), report, dev)
    v = b = cs.N_VALIDATORS
    g = torch.Generator(device=dev).manual_seed(0)
    tables = torch.randint(0, 8192, (v * 1024, 4, 20), dtype=torch.int16, device=dev, generator=g)
    rows = torch.randint(0, 8192, (v, 4, 20), dtype=torch.int16, device=dev, generator=g)
    idx = (torch.randperm(b, device=dev, generator=g) % v).to(torch.int32)
    h, s = (torch.randint(0, 256, (b, 32), dtype=torch.uint8, device=dev, generator=g)
            for _ in range(2))
    ry = torch.randint(0, 8192, (b, 20), dtype=torch.int16, device=dev, generator=g)
    rs = torch.zeros(b, dtype=torch.uint8, device=dev)
    tab_ms = [cs.cuda_ms(lambda: ed25519_table.verify_tabulated(tables, idx, h, s, ry, rs), reps=10)
              for _ in range(3)]
    ladder_ms = cs.cuda_ms(lambda: ed25519_cuda.verify_indexed(rows, idx, h, s, ry, rs), reps=10)
    print("TRIAL " + json.dumps({
        "variant": name, "tab_ms": tab_ms, "ladder_ms": ladder_ms, **res,
        "threads": lib.ed25519_table_threads(2, b),
        "resident_warps_per_sm": lib.ed25519_table_resident_warps(2), "card": cs.card_line(),
    }), flush=True)


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--run":
        run_variant(sys.argv[2], sys.argv[3])
        return 0
    names = sys.argv[1:] or list(VARIANTS)
    roots = {n: make_variant(n) for n in dict.fromkeys(names)}
    build = "from tendermint_tpu_torch.ops import _build; _build.lib()"
    procs = {n: subprocess.Popen([sys.executable, "-c", build], cwd=r) for n, r in roots.items()}
    for n, p in procs.items():
        if p.wait() != 0:
            raise RuntimeError(f"variant {n} did not build")
    for n in names:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--run", roots[n], n], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
