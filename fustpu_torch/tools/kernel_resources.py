"""Registers and spills of the kernels in CUDA sources, as ptxas reports
them, for some degrees.

    python -m fustpu_torch.tools.kernel_resources [--csrc DIR]
        [--degree 4 [6 ...]] [--match pencil_kernel,corner_kernel] [--sass]
        [source.cu ...]

Compiles each source (default: every ``*.cu`` of --csrc, this package's
``csrc`` unless given) with the build's own flags plus ``-Xptxas -v``,
one nvcc a source, all started together, and prints for every kernel
instantiated at N = degree + 1 for a --degree (or with no degree among
its template arguments, none of its integer arguments 3 or more, as the
engine's gathers and scatter) whose name holds one of the --match words:
its source, its demangled name, registers a thread, spill stores and
loads, and stack frame bytes; with --sass also the count of each memory
instruction in its machine code (`cuobjdump -sass`, beside nvcc: shared
loads and stores LDS / STS, global LDG / STG, constant LDC, bulk copies
UBLKCP, barriers BAR; static counts, one per instruction in the code, not
per execution); then one JSON object of the same rows.
--csrc may name the sources of another checkout (for instance the parent
commit unpacked with ``git archive``), so that two trees are compared
under one toolkit.  Needs nvcc; the objects go to a temporary directory
and are removed.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

from fustpu_torch import _build

_ENTRY = re.compile(r"Compiling entry function '(\w+)' for")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")
_FUNCTION = re.compile(r"Function : (\S+)")
_OPCODE = re.compile(r"^\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_]*)")
SASS_OPS = ("LDS", "STS", "LDG", "STG", "LDC", "UBLKCP", "BAR")


def parse(text: str) -> list[dict]:
    """The ptxas -v report of one compilation: one row per entry
    function, its mangled name, registers, spills, stack frame and static
    shared bytes (0 where ptxas reports none)."""
    rows, cur = [], None
    for line in text.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = dict(mangled=m.group(1), registers=None, stack=None,
                       spill_stores=None, spill_loads=None, smem=0)
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = _FRAME.search(line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = _USED.search(line)
        if m:
            cur["registers"] = int(m.group(1))
            m = _SMEM.search(line)
            if m:
                cur["smem"] = int(m.group(1))
    return rows


def parse_sass(text: str) -> dict[str, dict[str, int]]:
    """`cuobjdump -sass` of one object: for each function (mangled name)
    the count of each of SASS_OPS among its instructions."""
    out, cur = {}, None
    for line in text.splitlines():
        m = _FUNCTION.search(line)
        if m:
            cur = out.setdefault(m.group(1), dict.fromkeys(SASS_OPS, 0))
            continue
        m = _OPCODE.match(line)
        if cur is not None and m and m.group(1) in cur:
            cur[m.group(1)] += 1
    return out


def _cuobjdump(nvcc: str) -> str | None:
    tool = Path(nvcc).with_name("cuobjdump")
    return str(tool) if tool.exists() else shutil.which("cuobjdump")


def demangle(names: list[str], nvcc: str) -> list[str]:
    """cu++filt (beside nvcc) on the names, or the names unchanged."""
    tool = Path(nvcc).with_name("cu++filt")
    if not tool.exists():
        found = shutil.which("cu++filt")
        if not found:
            return names
        tool = Path(found)
    out = subprocess.run([str(tool)], input="\n".join(names),
                         capture_output=True, text=True)
    got = out.stdout.splitlines()
    return got if out.returncode == 0 and len(got) == len(names) else names


def report(sources: list[Path], sass: bool = False) -> list[dict]:
    """Every kernel of the sources with its resources, by source (with
    `sass`, each row's memory instruction counts under "sass", None where
    cuobjdump is missing)."""
    nvcc = _build._nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        cmds = [[nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                 str(Path(tmp) / f"{src.stem}.o"), str(src)]
                for src in sources]
        jobs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
                for cmd in cmds]
        rows = []
        for src, job in zip(sources, jobs):
            text, _ = job.communicate()
            if job.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{text}")
            ops, dump = {}, _cuobjdump(nvcc) if sass else None
            if dump:
                ops = parse_sass(subprocess.run(
                    [dump, "-sass", str(Path(tmp) / f"{src.stem}.o")],
                    capture_output=True, text=True, check=True).stdout)
            for row in parse(text):
                if sass:
                    row["sass"] = ops.get(row["mangled"])
                rows.append(dict(source=src.name, **row))
    names = demangle([r["mangled"] for r in rows], nvcc)
    for row, name in zip(rows, names):
        row["name"] = name
    return rows


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("sources", nargs="*",
                   help="source file names in --csrc (default: all)")
    p.add_argument("--csrc", type=Path, default=_build.CSRC)
    p.add_argument("--degree", type=int, nargs="+", default=[4],
                   help="the degrees whose instances to report")
    p.add_argument("--match", default="pencil_kernel,corner_kernel",
                   help="comma list of words, one of which a kernel's "
                        "name must hold")
    p.add_argument("--sass", action="store_true",
                   help="also count each kernel's memory instructions")
    args = p.parse_args(argv)
    sources = ([args.csrc / s for s in args.sources] if args.sources
               else sorted(args.csrc.glob("*.cu")))
    words = [w for w in args.match.split(",") if w]
    rows = [r for r in report(sources, args.sass)
            if (any(f"Li{d + 1}E" in r["mangled"] for d in args.degree)
                or all(int(v) < 3 for v in re.findall(r"Li(\d+)E",
                                                      r["mangled"])))
            and any(w in r["name"] for w in words)]
    for r in rows:
        print(f"{r['source']:22s} {r['registers']:4d} registers, "
              f"{r['spill_stores']} B spill stores, {r['spill_loads']} B "
              f"spill loads, {r['stack']} B stack, {r['smem']} B static "
              f"shared: {r['name']}", flush=True)
        if args.sass:
            print(f"{'':22s} sass: {r['sass']}", flush=True)
    keys = ("source", "name", "registers", "spill_stores", "spill_loads",
            "stack", "smem") + (("sass",) if args.sass else ())
    print(json.dumps({"csrc": str(args.csrc), "degree": args.degree,
                      "kernels": [{k: r[k] for k in keys} for r in rows]}))
    return rows


if __name__ == "__main__":
    main()
