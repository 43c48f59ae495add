"""Count the machine instructions of a kernel in one or more checkouts'
built kernel libraries, loop by loop: for each function whose name holds
``--kernel``, its instruction total, its local-memory loads and stores
(``LDL``/``STL``: spilled registers), shared loads and FMAs, each loop
that holds no other loop (a backward branch's span) with at least 4 FMAs,
and the innermost loop around every local-memory access.

Reads ``<root>/autompc_torch/_build/libautompc_kernels_*.so`` (the main
library, built by a first call of ``autompc_torch.ops._build.library()``
in that checkout) through ``cuobjdump -sass`` of the CUDA toolkit, so it
runs where the toolkit is; nothing is launched.

    python3 tools/sass_loops.py [--kernel riccati_big] ROOT [ROOT ...]
"""

import argparse
import glob
import os
import re
import shutil
import subprocess

_INSTR = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);")
_BRANCH = re.compile(r"\bBRA\b.*?0x([0-9a-f]+)")


def cuobjdump():
    found = shutil.which("cuobjdump")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")


def functions(lib):
    """(name, [(address, instruction)]) of every function in ``lib``."""
    out = subprocess.run([cuobjdump(), "-sass", lib], capture_output=True, text=True,
                         check=True).stdout
    for part in re.split(r"\n\s*Function : ", out)[1:]:
        name = part.split("\n", 1)[0].strip()
        ins = [(int(m.group(1), 16), m.group(2).strip())
               for m in map(_INSTR.match, part.splitlines()) if m]
        yield name, ins


def count(body, op):
    return sum(bool(re.search(r"\b" + op + r"\b", t)) for t in body)


def report(name, ins):
    loops = []
    for a, t in ins:
        m = _BRANCH.search(t)
        if m and int(m.group(1), 16) < a:
            loops.append((int(m.group(1), 16), a))
    inner = sorted(lo for lo in loops
                   if not any(o != lo and lo[0] <= o[0] and o[1] <= lo[1] for o in loops))
    body = [t for _, t in ins]
    print(f"  {name}: {len(ins)} instructions, LDL {count(body, 'LDL')}, STL "
          f"{count(body, 'STL')}, LDS {count(body, 'LDS')}, FFMA {count(body, 'FFMA')}, "
          f"{len(loops)} loops")
    for lo, hi in inner:
        span = [t for a, t in ins if lo <= a <= hi]
        if count(span, "FFMA") >= 4:
            print(f"    loop {lo:#06x}-{hi:#06x}: {len(span)} instructions, FFMA "
                  f"{count(span, 'FFMA')}, LDS {count(span, 'LDS')}, LDL {count(span, 'LDL')}, "
                  f"STL {count(span, 'STL')}")
    for a, t in ins:
        if re.search(r"\b(LDL|STL)\b", t):
            around = [lo for lo in loops if lo[0] <= a <= lo[1]]
            where = "in no loop"
            if around:
                lo, hi = min(around, key=lambda x: x[1] - x[0])
                span = [u for b, u in ins if lo <= b <= hi]
                where = (f"innermost loop {lo:#06x}-{hi:#06x} ({len(span)} instructions, "
                         f"{count(span, 'FFMA')} FFMA), {len(around)} loops around it")
            print(f"    {a:#06x} {t.split()[0]}: {where}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", default="riccati_big")
    ap.add_argument("roots", nargs="+")
    args = ap.parse_args(argv)
    for root in args.roots:
        libs = sorted(glob.glob(os.path.join(root, "autompc_torch", "_build",
                                             "libautompc_kernels_*.so")),
                      key=os.path.getmtime)
        if not libs:
            print(f"{root}: no built main library")
            continue
        print(f"{root}: {os.path.basename(libs[-1])}")
        for name, ins in functions(libs[-1]):
            if args.kernel in name:
                report(name, ins)


if __name__ == "__main__":
    main()
