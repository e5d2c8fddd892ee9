"""What the compiler made of a kernel: its SASS instructions by opcode.

    python /path/to/pointnet2_tpu_torch/tools/sass_probe.py LIBRARY [NAME_PART]

Runs ``cuobjdump -sass`` on a built library of ``pointnet2_tpu_torch/build/``
(any tree's: the script reads only the file it is given) and prints one JSON
line a function whose name holds ``NAME_PART``: its mangled name, its
instruction count, its ``CALL`` instructions (a 64-bit integer division, for
one, is a call to a routine) and its 12 most frequent opcodes. Counts are
static, not what a launch issues. Needs the CUDA toolkit's ``cuobjdump``.
"""

from __future__ import annotations

import json
import pathlib
import re
import shutil
import subprocess
import sys
from collections import Counter

FUNCTION = re.compile(r"^\s*Function : (\S+)")
INSTRUCTION = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)(\.[\w.]+)?")


def cuobjdump() -> str:
    found = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(found).exists():
        raise RuntimeError("cuobjdump not found: reading SASS needs the CUDA toolkit")
    return found


def functions(sass: str) -> dict[str, Counter]:
    """Mangled function name -> its opcodes (without modifiers), counted."""
    out: dict[str, Counter] = {}
    current = None
    for line in sass.splitlines():
        head = FUNCTION.match(line)
        if head:
            current = out.setdefault(head.group(1), Counter())
        elif current is not None:
            op = INSTRUCTION.search(line)
            if op:
                current[op.group(1)] += 1
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    part = argv[1] if len(argv) > 1 else ""
    sass = subprocess.run([cuobjdump(), "-sass", argv[0]], capture_output=True, text=True, check=True).stdout
    for name, ops in functions(sass).items():
        if part in name:
            print(json.dumps({"library": pathlib.Path(argv[0]).name, "function": name,
                              "instructions": sum(ops.values()), "calls": ops["CALL"],
                              "top": ops.most_common(12)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
