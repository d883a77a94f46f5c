"""Issue slots a pair in the force kernels, read from their SASS.

    python -m nbody_streams_tpu_torch.benchmarks.sass

Builds the kernel library if needed (``ops/_build``), disassembles it
with the toolkit's ``cuobjdump -sass`` and, in each kernel of ``KERNELS``,
finds the innermost loop that holds the rsqrt: the loop over a staged
tile's sources, one ``MUFU.RSQ`` a pair.  Its instructions over its
``MUFU.RSQ`` count are the issue slots a pair, the instruction-level
speed of light of the pair arithmetic (4 slots a clock per SM).  Also
reads each kernel's registers and spills from the build's ``build.log``
(``-Xptxas=-v``).  Needs the CUDA toolkit, not a card; prints one JSON
line per kernel.
"""
from __future__ import annotations

import json
import re
import subprocess
from collections import Counter
from pathlib import Path

#: Kernels read, by a fragment of their mangled name: KIND 0 = newtonian,
#: 1 = plummer, 4 = spline; MODE 0 = acc, 1 = pot; Kahan on; SKIP on for
#: the base pass.  A potential form holds two pair loops, the diagonal
#: tile's masked one and the unmasked one; the reader takes the shorter,
#: the unmasked loop that every other tile runs.  moment_tile_kernel's
#: arguments are <MODE, FOLD, KAHAN, SKIP, FAST> (fold / unfold: G m in
#: the moments or in the factor; exact / fast: r^2 from dx or expanded):
#: each lane computes four pair factors a step of 8 sources, one MUFU.RSQ
#: each, so its loop's slots over its rsqrts are slots a pair as well.
KERNELS = {
    "direct_tile_kernel<NEWTONIAN,ACC,Kahan,skip> (base pass)":
        "direct_tile_kernelILi0ELi0ELb1ELb1E",
    "band_kernel<ACC,Kahan> (band pass)": "band_kernelILi0ELb1E",
    "direct_tile_kernel<SPLINE,ACC,Kahan> (single pass)":
        "direct_tile_kernelILi4ELi0ELb1ELb0E",
    "direct_tile_kernel<PLUMMER,POT,Kahan> (two-set, fit)":
        "direct_tile_kernelILi1ELi1ELb1ELb0E",
    "direct_tile_kernel<SPLINE,POT,Kahan> (single pass)":
        "direct_tile_kernelILi4ELi1ELb1ELb0E",
    "direct_tile_kernel<NEWTONIAN,POT,Kahan,skip> (base pass)":
        "direct_tile_kernelILi0ELi1ELb1ELb1E",
    "band_kernel<POT,Kahan> (band pass)": "band_kernelILi1ELb1E",
    "combine_kernel<Kahan>": "combine_kernelILb1E",
    "tile_sol_kernel<NEWTONIAN>": "tile_sol_kernelILi0E",
    "tile_sol_kernel<SPLINE>": "tile_sol_kernelILi4E",
    "moment_tile_kernel<ACC,fold,Kahan,skip,exact> (M, base pass)":
        "moment_tile_kernelILi0ELb1ELb1ELb1ELb0E",
    "moment_tile_kernel<ACC,unfold,Kahan,skip,exact> (M unfolded)":
        "moment_tile_kernelILi0ELb0ELb1ELb1ELb0E",
    "moment_tile_kernel<ACC,fold,Kahan,skip,fast> (F, base pass)":
        "moment_tile_kernelILi0ELb1ELb1ELb1ELb1E",
    "moment_tile_kernel<POT,fold,Kahan,skip,fast> (F potential)":
        "moment_tile_kernelILi1ELb1ELb1ELb1ELb1E",
    "moment_tile_kernel<ACC,fold,Kahan,noskip,exact> (M two-set)":
        "moment_tile_kernelILi0ELb1ELb1ELb0ELb0E",
    "tile_sol_moment_kernel": "tile_sol_moment_kernel",
}

_FUNC = re.compile(r"Function : (\S+)")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
# a branch target: a label (`(.L_x_3)) or an address (0x0a80)
_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b(0x[0-9a-f]+)\s*$")


def parse(text):
    """``{mangled name: (instructions, labels)}`` from ``cuobjdump -sass``
    output: each function's instruction texts in order, and the index of
    each label and instruction address into them."""
    funcs = {}
    instrs = labels = None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            instrs, labels = [], {}
            funcs[m.group(1)] = (instrs, labels)
        elif instrs is not None:
            m = _LABEL.match(line)
            if m:
                labels[m.group(1)] = len(instrs)
                continue
            m = _INSTR.match(line)
            if m:
                labels[hex(int(m.group(1), 16))] = len(instrs)
                instrs.append(m.group(2))
    return funcs


def opcode(instr):
    """The opcode of one instruction, its predicate dropped; MUFU keeps
    its function (MUFU.RSQ), everything else its base (FSETP.GEU.AND ->
    FSETP)."""
    words = instr.split()
    op = words[1] if words[0].startswith("@") else words[0]
    return op if op.startswith("MUFU") else op.split(".")[0]


def inner_loop(instrs, labels):
    """Opcode counts of the shortest backward-branch loop that holds a
    MUFU.RSQ, or None where no loop does."""
    best = None
    for end, instr in enumerate(instrs):
        m = _TARGET.search(instr)
        if not m or not opcode(instr).startswith("BRA"):
            continue
        begin = labels.get(m.group(1) or hex(int(m.group(2), 16)))
        if begin is None or begin > end:
            continue
        body = [opcode(x) for x in instrs[begin:end + 1]]
        if "MUFU.RSQ" in body and (best is None or len(body) < len(best)):
            best = body
    if best is None:
        return None
    return Counter(op for op in best if op != "NOP")


def registers(log_text):
    """``{mangled name: (registers, spill store bytes, spill load bytes)}``
    from ptxas's -v report."""
    out = {}
    name = None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out.setdefault(name, [0, 0, 0])[1:] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, [0, 0, 0])[0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def profile(sass_text, log_text=""):
    """Per kernel of KERNELS: the inner loop's slots a pair, its opcode
    counts a pair, registers and spills."""
    funcs = parse(sass_text)
    regs = registers(log_text)
    out = {}
    for label, fragment in KERNELS.items():
        name = next((f for f in funcs if fragment in f), None)
        if name is None:
            raise KeyError(f"{label}: no function matches {fragment!r}")
        loop = inner_loop(*funcs[name])
        record = {"function": name,
                  "registers": regs.get(name, (None,) * 3)[0],
                  "spill_bytes": sum(regs.get(name, (0, 0, 0))[1:])}
        if loop is not None:
            pairs = loop["MUFU.RSQ"]
            record.update(
                pairs_per_trip=pairs,
                slots_per_pair=sum(loop.values()) / pairs,
                per_pair={op: n / pairs for op, n in sorted(loop.items())})
        out[label] = record
    return out


def library_profile():
    """``profile`` of the built kernel library and its build log."""
    from ..ops import _build

    lib = _build.build()
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    return profile(text, (lib.parent / "build.log").read_text())


def main():
    for label, record in library_profile().items():
        print(json.dumps(dict(record, kernel=label)), flush=True)


if __name__ == "__main__":
    main()
