"""Instruction mix of the port's CUDA kernels, read from their machine code.

For every kernel of a built library whose demangled name contains one of
the given patterns, prints the count of each opcode in the whole function
and in its longest loop that holds FFMAs (the span of a backward branch),
with the FFMA share of that loop.  For reading what bounds a kernel whose
inner loop is compute: a loop that issues one instruction a clock on every
scheduler takes (loop instructions / FFMAs) times the time of its FFMAs
alone.

Needs the CUDA toolkit's ``cuobjdump`` (and ``c++filt`` or ``cu++filt``);
builds the library first if it is missing.  On a GPU machine, from the
repository root:

    PYTHONPATH=src python -m repro_torch.launch.sass_mix sampled_cols.cu \\
        "dense_tile<float, 16, 2, 2, 3, 32" \\
        "dense_reduce<float, true>" "cols_apply<float, 8>"
"""
from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
from pathlib import Path

from repro_torch.kernels.gram import _build

_INSTR = re.compile(r"\s*/\*([0-9a-f]+)\*/\s+(.*?)\s*;")
_PRED = re.compile(r"^@!?U?P\w+\s+")
_TARGET = re.compile(r"\bBRA\s+(?:`\()?0x([0-9a-f]+)")


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    return str(Path(_build._nvcc()).with_name(name))


def demangle(names: list) -> list:
    """C++ names of mangled symbols, in order (``c++filt``, else the CUDA
    toolkit's ``cu++filt``), given as arguments."""
    tool = shutil.which("c++filt") or _tool("cu++filt")
    out = subprocess.run([tool, *names], capture_output=True, text=True,
                         check=True).stdout.splitlines()
    if len(out) != len(names):
        raise RuntimeError(f"{tool} gave {len(out)} names for {len(names)}")
    return out


def functions(sass: str) -> dict:
    """{mangled name: [(address, instruction text), ...]} of a
    ``cuobjdump -sass`` listing."""
    out, cur = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            cur = line.split("Function : ", 1)[1].strip()
            out[cur] = []
        elif cur is not None:
            m = _INSTR.match(line)
            if m:
                out[cur].append((int(m.group(1), 16), m.group(2)))
    return out


def opcode(text: str) -> str:
    """The opcode of one instruction, without predicate or modifiers."""
    return _PRED.sub("", text).split()[0].split(".")[0]


def loop_mix(instrs: list) -> dict:
    """Opcode counts of the whole function and of its longest loop (a
    backward branch and the instructions from its target on) that holds
    an FFMA, else its longest loop."""
    at = {addr: i for i, (addr, _) in enumerate(instrs)}
    loops = []
    for j, (addr, text) in enumerate(instrs):
        m = _TARGET.search(text)
        if m and int(m.group(1), 16) < addr and int(m.group(1), 16) in at:
            loops.append(instrs[at[int(m.group(1), 16)]:j + 1])

    def key(body):
        return (any(opcode(t) == "FFMA" for _, t in body), len(body))

    body = max(loops, key=key) if loops else []
    whole = collections.Counter(opcode(t) for _, t in instrs)
    inner = collections.Counter(opcode(t) for _, t in body)
    return {"instructions": len(instrs), "opcodes": dict(whole.most_common()),
            "loop_instructions": len(body),
            "loop_opcodes": dict(inner.most_common()),
            "loop_ffma_share": inner["FFMA"] / len(body) if body else 0.0}


def main(source: str, patterns: list) -> dict:
    lib = _build._library_path(source)
    if not lib.exists():
        _build.build_all()
    sass = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    funcs = functions(sass)
    names = list(funcs)
    out = {}
    for mangled, name in zip(names, demangle(names)):
        name = name.replace("(anonymous namespace)::", "").split("(")[0]
        if any(p in name for p in patterns):
            out[name] = loop_mix(funcs[mangled])
            print(json.dumps({"kernel": name, **out[name]}), flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("source", help="a CUDA source of repro_torch/csrc")
    ap.add_argument("patterns", nargs="+",
                    help="substrings of the demangled kernel names")
    args = ap.parse_args()
    main(args.source, args.patterns)
