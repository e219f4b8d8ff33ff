#!/usr/bin/env python
"""Phase 7a's recipe on one card, interleaved between checkouts.

Runs ``chip_smoke.py``'s phase 7a recipe (``launch_hips
geomx_tpu_torch.examples.cnn_bsc_device``, 12 processes, 200 rounds and
5 ``step_timed`` rounds) once per variant per round, the variants in
order on even rounds and reversed on odd ones, and prints for each pass
the four workers' ``step_timed`` wire and compute medians (ms) and their
parameter digest. A variant is ``NAME=DIR``: a checkout holding
``chip_smoke.py`` (unpack one with ``git archive``), or ``NAME=DIR:ephemeral``
to draw the recipe's scheduler ports with ``bind(0)`` instead of
``chip_smoke.free_ports``. Needs the card:

  python3 geomx_tpu_torch/scripts/recipe_wire_ab.py [--rounds 3] \\
      new=path/to/checkout old=path/to/parent
"""

import argparse
import subprocess
import sys

PASS = r'''
import os, sys
sys.path.insert(0, os.getcwd())
import chip_smoke as c
if sys.argv[2] == "ephemeral":
    from geomx_tpu_torch.simulate import free_port
    c.free_ports = lambda n: [free_port() for _ in range(n)]
P = c.PHASE7
argv = ["-bs", str(c.LENET["batch"]), "-ep", "1000", "--max-iters",
        str(P["lenet_rounds"]), "--timed", str(P["timed"])]
logs = c.launch("7a", ["bash", "-c", c.HIPS_ENV + ' && launch_hips "$@"',
                       "launch_hips", "geomx_tpu_torch.examples.cnn_bsc_device",
                       *argv], "cuda", P["timeout_7a"])
ws, _m = c.workers_of(logs)
reps = [c.report(w, "7a", f"worker {i}", "cuda") for i, w in enumerate(ws)]
print("AB", sys.argv[1], [c.medians(r["step_timed"])["wire_ms"] for r in reps],
      [c.medians(r["step_timed"])["compute_ms"] for r in reps],
      reps[0]["digest"], flush=True)
'''


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("variants", nargs="+", help="NAME=DIR[:ephemeral]")
    args = ap.parse_args(argv)
    variants = []
    for v in args.variants:
        name, _, where = v.partition("=")
        path, _, mode = where.partition(":")
        variants.append((name, path, mode))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    failed = False
    for i in range(args.rounds):
        for name, path, mode in (variants if i % 2 == 0
                                 else variants[::-1]):
            r = subprocess.run([sys.executable, "-c", PASS, name, mode],
                               cwd=path, text=True, capture_output=True,
                               timeout=400)
            print("\n".join(l for l in r.stdout.splitlines()
                            if l.startswith(("AB", "FAIL"))), flush=True)
            if r.returncode:
                failed = True
                print(r.stdout[-2000:], r.stderr[-2000:], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
