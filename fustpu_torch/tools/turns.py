"""Run one command in two checkouts in turns (A, B, B, A), so that a change
is timed against its parent on the same card in one session.

    python -m fustpu_torch.tools.turns --a DIR --b DIR [--out DIR]
        [--grep REGEX] -- <command> [arguments]

Each run starts the command as a fresh process from the root of its
checkout (so ``python -m fustpu_torch...`` imports that checkout's
package and builds its kernels there), writes its output to
``<out>/<label>_<turn>.log`` (default ``_scratch/turns``, which git
ignores) and prints the lines that match --grep,
each prefixed by the checkout's label and turn.  Fails on the first run
that exits non-zero.  Typical use, the parent commit unpacked beside the
working tree:

    git archive HEAD | tar -x -C _scratch/parent
    python -m fustpu_torch.tools.turns --a _scratch/parent --b . \\
        --grep 'pencil' -- python -m fustpu_torch.demos.exp_pencil
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
import time
from pathlib import Path


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    if "--" not in argv:
        raise SystemExit("turns: give the command after --")
    cut = argv.index("--")
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--a", type=Path, required=True)
    p.add_argument("--b", type=Path, required=True)
    p.add_argument("--labels", default="a,b")
    p.add_argument("--out", type=Path, default=Path("_scratch/turns"))
    p.add_argument("--grep", default=".")
    args = p.parse_args(argv[:cut])
    command = argv[cut + 1:]
    labels = dict(zip("ab", args.labels.split(",")))
    pattern = re.compile(args.grep)
    args.out.mkdir(parents=True, exist_ok=True)
    stem = re.sub(r"\W+", "_", " ".join(command[-3:]))[-40:]
    logs = {}
    for turn, which in enumerate("abba"):
        root = (args.a if which == "a" else args.b).resolve()
        label = labels[which]
        t0 = time.perf_counter()
        run = subprocess.run(command, cwd=root, capture_output=True,
                             text=True)
        secs = time.perf_counter() - t0
        log = args.out / f"{stem}_{label}_{turn}.log"
        log.write_text(run.stdout + run.stderr)
        logs[(label, turn)] = run.stdout
        for line in run.stdout.splitlines():
            if pattern.search(line):
                print(f"[{label} {turn}] {line}", flush=True)
        print(f"[{label} {turn}] rc {run.returncode} in {secs:.1f} s "
              f"({log})", flush=True)
        if run.returncode != 0:
            print(run.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"turns: {label} run {turn} failed")
    return logs


if __name__ == "__main__":
    main()
