"""Compare the machine code of two builds of the port's kernel libraries,
kernel by kernel, to show that a change left other kernels as they were.

Run on a machine with the CUDA toolkit, after both trees have built their
libraries (``_build.build_all()`` from each root):

    python -m vbz_compression_tpu_torch.tools.sass_diff PARENT_ROOT \\
        CHANGE_ROOT [w2 w4 v1 copy probe]

For each library it disassembles ``build/torch_kernels/*/libvbz_<name>.so``
of both roots with ``cuobjdump -sass`` and compares each kernel's
instructions, blank lines and runs of blanks aside. The hash that names a
source's anonymous namespace follows the source's content, so it is dropped
from the names.
Prints, per library, the kernels whose instructions are identical (and how
many instructions they hold), those that differ (with their first
differing lines), and those only one build has.
"""

from __future__ import annotations

import argparse
import difflib
import glob
import os
import re
import subprocess

from vbz_compression_tpu_torch.ops import _build


def kernels(root: str, name: str) -> dict:
    """{kernel: its SASS lines, blank lines dropped and runs of blanks
    made one} of one library."""
    paths = glob.glob(os.path.join(root, "build", "torch_kernels", "*",
                                   f"libvbz_{name}.so"))
    if len(paths) != 1:
        raise SystemExit(f"{root}: want one built libvbz_{name}.so, found "
                         f"{paths}")
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", paths[0]], capture_output=True,
                          text=True, check=True).stdout
    text = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", text)
    parts = re.split(r"\n\s*Function : (\S+)\n", text)
    return {parts[i]: [" ".join(line.split())
                       for line in parts[i + 1].splitlines() if line.strip()]
            for i in range(1, len(parts) - 1, 2)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("names", nargs="*", default=list(_build.NAMES))
    args = ap.parse_args()
    for name in args.names:
        a, b = kernels(args.parent, name), kernels(args.change, name)
        same = [k for k in a if b.get(k) == a[k]]
        differ = [k for k in a if k in b and b[k] != a[k]]
        count = sum(sum(";" in line for line in a[k]) for k in same)
        print(f"{name}: {len(same)} of {len(a)} kernels identical ({count} "
              f"instructions); differ: {differ}; only in the parent: "
              f"{sorted(set(a) - set(b))}; only in the change: "
              f"{sorted(set(b) - set(a))}")
        for k in differ:
            lines = [d for d in difflib.unified_diff(a[k], b[k], lineterm="",
                                                     n=0)
                     if d[:1] in "+-" and d[:3] not in ("+++", "---")]
            print(f"  {k}: {len(lines)} lines differ")
            for d in lines[:12]:
                print("    " + " ".join(d.split())[:150])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
