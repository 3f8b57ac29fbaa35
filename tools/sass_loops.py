#!/usr/bin/env python3
"""Summarise the compiled loops of one CUDA kernel from its SASS.

    python3 tools/sass_loops.py LIB.so KERNEL [START:END]

Runs ``cuobjdump -sass`` on a library the port built (``build/...``),
takes the first function whose mangled name contains ``KERNEL``, and for
every loop (a branch back to an earlier address) prints its address
range, its instruction count by opcode, the sum of the stall cycles the
compiler encoded in the control bits, and how many of its instructions
wait on a scoreboard (a load, a MUFU or a shared-memory result not yet
there). With ``START:END`` (hexadecimal addresses) it summarises that
range instead. A static view: what the scheduler meets at run time comes
on top. Needs the CUDA toolkit's ``cuobjdump``.
"""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from collections import Counter

INSN = re.compile(r"/\*([0-9a-f]{4,6})\*/\s+(.*?)\s*;\s*/\* (0x[0-9a-f]{16}) \*/")
CTRL = re.compile(r"^\s*/\* (0x[0-9a-f]{16}) \*/")


def instructions(sass: str, kernel: str) -> list[tuple[int, str, int, int]]:
    """(address, text, stall cycles, scoreboard wait mask) of the kernel."""
    lines, out, inside = sass.splitlines(), [], False
    for i, line in enumerate(lines):
        if "Function :" in line:
            if inside:
                break
            inside = kernel in line
            continue
        m = INSN.search(line) if inside else None
        if m and i + 1 < len(lines) and CTRL.match(lines[i + 1]):
            hi = int(CTRL.match(lines[i + 1]).group(1), 16)
            out.append((int(m.group(1), 16), m.group(2),
                        (hi >> 41) & 0xF, (hi >> 52) & 0x3F))
    return out


def summary(body) -> dict:
    ops = Counter()
    for _, text, _, _ in body:
        words = text.split()
        ops[words[1] if words[0].startswith("@") else words[0]] += 1
    return {"instructions": len(body), "stall_cycles": sum(b[2] for b in body),
            "scoreboard_waits": sum(1 for b in body if b[3]),
            "opcodes": dict(ops.most_common(12))}


def main(argv: list[str]) -> int:
    if len(argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", argv[0]], capture_output=True,
                          text=True, check=True).stdout
    ins = instructions(sass, argv[1])
    if not ins:
        print(f"no function matching {argv[1]!r}", file=sys.stderr)
        return 1
    if len(argv) == 3:
        lo, hi = (int(x, 16) for x in argv[2].split(":"))
        print(json.dumps({"range": argv[2], **summary(
            [b for b in ins if lo <= b[0] < hi])}))
        return 0
    for addr, text, _, _ in ins:
        m = re.search(r"BRA (0x[0-9a-f]+)", text)
        if m and int(m.group(1), 16) < addr:
            lo = int(m.group(1), 16)
            print(json.dumps({"range": f"{lo:#x}:{addr:#x}", **summary(
                [b for b in ins if lo <= b[0] <= addr])}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
