#!/usr/bin/env python3
"""Static instruction counts of the port's CUDA kernels, from the SASS
that ``cuobjdump -sass`` prints for the built kernel library.

Run from the root of a checkout, on a machine with the CUDA toolkit:

    python3 scripts/sass_count.py [--match REGEX]

Builds the library as the port does (``ops.cuda_build.kernel_library``),
disassembles it, and for every kernel whose mangled name matches REGEX
(default: K2, K3, K4, the row medians, the histogram and the blend)
prints one line: its instruction count by class (FP32 arithmetic,
special-function unit, integer, shared- and device-memory loads and
stores, asynchronous copies, control) and its most frequent opcodes. The counts are static: a loop
whose trip count is a run-time argument (K4's K taps, K2's and K3's rows
of a run and copies of its span, the medians' passes, the histogram's
grid-stride loop, the blend's runs of 17 rows) is counted once.
The last line is all of it as JSON.
"""

import argparse
import collections
import json
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CLASSES = {
    "fp32": ("FFMA", "FADD", "FMUL", "FMNMX", "FSETP", "FSEL", "FCHK",
             "FSET", "FRND"),
    "sfu": ("MUFU",),
    "convert": ("F2I", "I2F", "F2F", "I2I", "F2IP", "I2FP"),
    "int": ("IMAD", "IADD3", "LOP3", "SHF", "ISETP", "LEA", "IMNMX",
            "SEL", "PRMT", "IABS", "POPC", "FLO", "BREV", "IMUL"),
    "lds/sts": ("LDS", "STS", "ATOMS"),
    "ldg/stg": ("LDG", "STG", "LD", "ST", "ATOMG", "RED"),
    "async": ("LDGSTS", "LDGDEPBAR", "DEPBAR"),
    "control": ("BRA", "BSSY", "BSYNC", "BAR", "EXIT", "CALL", "RET",
                "WARPSYNC", "VOTE", "MATCH", "SHFL", "REDUX", "NOP"),
}


def classify(op: str) -> str:
    base = op.split(".")[0]
    for name, ops in CLASSES.items():
        if base in ops:
            return name
    return "other"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--match",
                    default=r"k[2-4]_kernel|row_median|hist_kernel|blend")
    args = ap.parse_args(argv)

    from aind_smartspim_destripe_torch.ops import cuda_build

    lib = cuda_build.kernel_library()
    nvcc = cuda_build.find_nvcc()
    if nvcc is None:
        print("sass_count: no CUDA toolkit", file=sys.stderr)
        return 2
    cuobjdump = Path(nvcc).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", lib._name],
                          capture_output=True, text=True, check=True,
                          timeout=600).stdout
    out = {}
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        name = block.split("\n", 1)[0].strip()
        if not re.search(args.match, name):
            continue
        ops = collections.Counter()
        for line in block.split("\n"):
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_.]+)", line)
            if m:
                ops[m.group(1)] += 1
        by_class = collections.Counter()
        for op, c in ops.items():
            by_class[classify(op)] += c
        out[name] = {"total": sum(ops.values()), **dict(by_class),
                     "top": dict(ops.most_common(12))}
        print(f"[sass] {name}: {out[name]['total']} instructions; "
              + ", ".join(f"{k} {v}" for k, v in sorted(by_class.items()))
              + "; top " + " ".join(f"{k}={v}" for k, v in
                                    ops.most_common(12)))
    print(json.dumps(out))
    return 0 if out else 1


if __name__ == "__main__":
    sys.exit(main())
