#!/usr/bin/env python3
"""Build seconds of this tree's kernel libraries against another
checkout's, on the machine with the card.

    python3 scripts/torch_build_seconds.py --other DIR [--order ORDER]
        [--json PATH]

DIR is the root of another checkout of this repository (the parent commit
unpacked by ``git archive`` into a directory that ``.gitignore`` lists).
Each turn builds one tree's every kernel library as ``chip_smoke.py``
does (``ops/_build.py`` ``build_all``: one ``nvcc`` per library, all
started together) into a fresh directory under ``build/build_seconds/``,
and reports the whole build's wall seconds and each library's ``nvcc``
seconds. The turns go in ORDER (default ``other,this,this,other``), so
both trees build on the same machine in one process. A tree's libraries
are its ``csrc/*.cu`` sources, and for this tree also the head dim 64
builds of its ``ops/_build.py`` (``<source>:d64``). Prints one JSON line
per turn, then the card's name and power limit; with ``--json`` also
writes the lines to PATH.
"""

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from long_context_attention_tpu_torch.ops import _build  # noqa: E402


def tree_libs(root: Path):
    """(csrc directory, library names) of a checkout."""
    csrc = root / "long_context_attention_tpu_torch" / "csrc"
    libs = sorted(p.name for p in csrc.glob("*.cu"))
    if root == ROOT:
        libs = sorted({k.lib for k in _build.KERNELS.values()} | set(libs))
    return csrc, libs


def build_turn(tag: str, root: Path, turn: int):
    csrc, libs = tree_libs(root)
    out = ROOT / "build" / "build_seconds" / f"{turn}-{tag}"
    shutil.rmtree(out, ignore_errors=True)
    saved = _build.CSRC, _build.BUILD_DIR
    _build.CSRC, _build.BUILD_DIR = csrc, out
    _build._build_seconds.clear()
    try:
        t0 = time.perf_counter()
        _build.build_all(libs)
        wall = time.perf_counter() - t0
    finally:
        _build.CSRC, _build.BUILD_DIR = saved
    return {"turn": turn, "tree": tag, "root": str(root), "wall_s": wall,
            "lib_seconds": dict(_build._build_seconds)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="root of the other checkout")
    ap.add_argument("--order", default="other,this,this,other",
                    help="the turns, comma-separated trees")
    ap.add_argument("--json", type=Path, help="also write the lines here")
    args = ap.parse_args()
    roots = {"other": args.other.resolve(), "this": ROOT}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    lines = []
    for turn, tag in enumerate(args.order.split(",")):
        line = {"card": smi, **build_turn(tag, roots[tag], turn)}
        lines.append(line)
        print(json.dumps(line), flush=True)
    summary = {"card": smi, "summary": {
        tag: {"wall_s": [ln["wall_s"] for ln in lines if ln["tree"] == tag],
              "flash_fwd_sm90.cu": [ln["lib_seconds"].get("flash_fwd_sm90.cu")
                                    for ln in lines if ln["tree"] == tag]}
        for tag in roots}}
    lines.append(summary)
    print(json.dumps(summary), flush=True)
    print(smi, flush=True)
    if args.json:
        args.json.write_text("".join(json.dumps(ln) + "\n" for ln in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
