#!/usr/bin/env python3
"""Count the SASS instructions of the port's CUDA kernels by pipe, on the
machine with the CUDA toolkit (no card needed, but the build needs nvcc).

    python3 chip_sass.py [NAME=path/to/source.cu[,-DFLAG...] ...] [--dump DIR]

Every source (with no arguments the sources of
avrecode_tpu_torch/csrc) is built with the package's nvcc flags, and
`cuobjdump -sass` of the library is split into kernels and basic blocks (a
block starts at a label and ends after a branch).  For each kernel it
prints the counts of the whole function and of every block of at least 40
instructions, by pipe:

  alu    integer ALU: IADD3, LOP3, SHF, SEL, ISETP, LEA, PRMT, IMNMX, ...
         (16 lanes a scheduler: a warp's instruction holds it 2 cycles)
  flo    find-leading-one and population count (FLO, POPC, BREV)
  fma    the multiply-add pipe: IMAD in all its forms (also used for moves),
         IMUL, FFMA, HFMA2 (16 lanes for IMAD: 2 cycles a warp)
  mem    shared and global memory, cp.async, shuffles (LDS, STS, LDG, STG,
         LDGSTS, SHFL, ...)
  ctrl   branches and barriers (BRA, BSSY, BSYNC, WARPSYNC, BAR, EXIT, ...)
  uni    the uniform datapath (U*, R2UR, S2UR)
  other  the rest (S2R, CS2R, MOV, VOTE, REDUX, ...)

The range coders do one find-leading-bit a bin (FLO), so `flo` counts the
bins of a block of their chain; the issue floor a bin is then
(alu + flo + fma) x 2 cycles over those bins.  --dump DIR writes each
kernel's SASS there.  A tool for kernel work: what it counts is the
compiler's output, not the card's time.
"""

import os
import re
import subprocess
import sys
from collections import Counter

from avrecode_tpu_torch.ops import _build

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "sass")
PIPES = ("alu", "flo", "fma", "mem", "ctrl", "uni", "other")
ALU = {"IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "SEL", "FSEL",
       "ISETP", "IMNMX", "VIMNMX", "VIMNMX3", "LEA", "PRMT", "BMSK", "SGXT",
       "PLOP3", "P2R", "R2P", "IABS", "ICMP", "ISCADD", "VIADD", "VIADDMNMX",
       "IDP", "BFE", "BFI"}
FLO = {"FLO", "POPC", "BREV"}
FMA = {"IMAD", "IMUL", "IMADSP", "FFMA", "FADD", "FMUL", "FMNMX", "HFMA2",
       "HADD2", "HMUL2", "DFMA"}
MEM = {"LDS", "STS", "LDG", "STG", "LD", "ST", "LDL", "STL", "LDGSTS",
       "LDGDEPBAR", "DEPBAR", "ATOM", "ATOMS", "ATOMG", "RED", "SHFL", "LDSM",
       "LDC", "MEMBAR", "CCTL", "UBLKCP", "SYNCS"}
CTRL = {"BRA", "BRX", "JMP", "JMX", "EXIT", "RET", "CALL", "BSSY", "BSYNC",
        "WARPSYNC", "BAR", "BPT", "YIELD", "BMOV", "NOP", "KILL", "NANOSLEEP",
        "ELECT", "WARPGROUP"}
INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
LABEL = re.compile(r"^\s*(\.L_x_\d+):")
ENDS_BLOCK = {"BRA", "BRX", "JMP", "JMX", "EXIT", "RET", "CALL"}


def pipe(op):
    base = op.split(".")[0]
    if base in ALU:
        return "alu"
    if base in FLO:
        return "flo"
    if base in FMA:
        return "fma"
    if base in MEM:
        return "mem"
    if base in CTRL:
        return "ctrl"
    if base.startswith("U") or base in ("R2UR", "S2UR"):
        return "uni"
    return "other"


def opcode(text):
    """The instruction's opcode with its modifiers, predicate dropped."""
    words = text.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0] if words else ""


def parse(sass):
    """cuobjdump -sass text -> {kernel: [blocks]}, a block a list of
    (address, opcode, text)."""
    kernels, name, block = {}, None, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernels[name] = [[]]
            continue
        if name is None:
            continue
        if LABEL.match(line):
            if kernels[name][-1]:
                kernels[name].append([])
            continue
        m = INSN.search(line)
        if not m:
            continue
        op = opcode(m.group(2))
        kernels[name][-1].append((int(m.group(1), 16), op, m.group(2)))
        if op.split(".")[0] in ENDS_BLOCK:
            kernels[name].append([])
    return {k: [b for b in v if b] for k, v in kernels.items()}


def counts(insns):
    c = Counter(pipe(op) for _, op, _ in insns)
    return {p: c.get(p, 0) for p in PIPES}


def fmt(c, n):
    parts = " ".join(f"{p} {c[p]}" for p in PIPES if c[p])
    line = f"{n} instructions: {parts}"
    if c["flo"]:
        per = (c["alu"] + c["flo"] + c["fma"]) / c["flo"]
        line += (f"; a bin (one FLO each): {n / c['flo']:.2f} instructions, "
                 f"integer {per:.2f}, issue floor {2 * per:.1f} cycles")
    return line


def report(label, sass, dump):
    for kernel, blocks in parse(sass).items():
        every = [i for b in blocks for i in b]
        print(f"{label} {kernel}: {fmt(counts(every), len(every))}")
        if dump:
            with open(os.path.join(dump, f"{label}.{kernel[:80]}.sass"),
                      "w") as f:
                for b in blocks:
                    f.write("\n".join(f"/*{a:04x}*/ {t}" for a, _, t in b))
                    f.write("\n--\n")
        for b in blocks:
            if len(b) >= 40:
                ops = Counter(op.split(".")[0] for _, op, _ in b)
                top = ", ".join(f"{o} {n}" for o, n in ops.most_common(12))
                print(f"  block {b[0][0]:#06x}-{b[-1][0]:#06x}: "
                      f"{fmt(counts(b), len(b))}\n    {top}")


def main(argv):
    dump = None
    if "--dump" in argv:
        i = argv.index("--dump")
        dump = argv[i + 1]
        del argv[i:i + 2]
        os.makedirs(dump, exist_ok=True)
    csrc = os.path.join(ROOT, "avrecode_tpu_torch", "csrc")
    sources = {os.path.splitext(f)[0]: (os.path.join(csrc, f), [])
               for f in sorted(os.listdir(csrc)) if f.endswith(".cu")}
    if argv:
        sources = {}
        for arg in argv:
            name, spec = arg.split("=", 1)
            src, *flags = spec.split(",")
            sources[name] = (src, flags)
    os.makedirs(OUT_DIR, exist_ok=True)
    nvcc = _build._nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    procs = {}
    for name, (src, flags) in sources.items():
        out = os.path.join(OUT_DIR, name + ".so")
        cmd = _build.nvcc_command(out, [src], flags)
        procs[name] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (out, proc) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        for ln in text.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"{name}: {ln.strip()}")
        sass = subprocess.run([cuobjdump, "-sass", out], capture_output=True,
                              text=True, check=True).stdout
        report(name, sass, dump)


if __name__ == "__main__":
    main(sys.argv[1:])
