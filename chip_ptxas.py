#!/usr/bin/env python3
"""What ptxas makes of the port's CUDA kernels: registers, spills and, against
another tree, whether the kernels compile to the same code.

    python3 chip_ptxas.py [--against DIR [--except SOURCE ...]] [SOURCE ...]

Compiles each source of ``nequip_tpu_torch/csrc`` (or the named ones, e.g.
``tri_bwd.cu``) with ``ops/kernels/build.py``'s nvcc line plus
``-Xptxas=-v``, one nvcc a source, all started together, and prints one line
a kernel: registers, spill stores and loads, stack frame.  With ``--against
DIR`` (a tree holding ``nequip_tpu_torch/csrc``, such as another commit
unpacked by ``git archive``) it compiles DIR's sources too and compares
every kernel that both trees have, source by source and by name: its
registers and spills, and its SASS (``cuobjdump -sass``) where the toolkit
has cuobjdump.  ``--except`` names sources whose bfloat16 kernels are meant
to change: those are listed but not compared (their float32 and float64
kernels are).  Names are compared demangled, without the anonymous
namespace and without a trailing block-size argument of 256 (a defaulted
template argument).  Exits 1 if a compared kernel differs or is missing
from this tree.  Needs nvcc (the machine with the card).
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

from nequip_tpu_torch.ops.kernels import build

FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]


def compile_all(csrc: Path, names, out: Path) -> dict:
    """{source: (object path, ptxas stderr)} for the sources of csrc."""
    nvcc = build._find_nvcc()
    procs = {}
    for name in names:
        obj = out / (Path(name).stem + ".o")
        procs[name] = (obj, subprocess.Popen([nvcc, *FLAGS, f"-I{csrc}", "-Xptxas=-v", "-c", str(csrc / name),
                                              "-o", str(obj)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                             text=True))
    res = {}
    for name, (obj, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {csrc / name}:\n{text[-4000:]}")
        res[name] = (obj, text)
    return res


def demangle(names) -> dict:
    filt = shutil.which("c++filt")
    if filt is None:
        return {n: n for n in names}
    out = subprocess.run([filt], input="\n".join(names), capture_output=True, text=True).stdout.split("\n")
    return dict(zip(names, out))


def normal(name: str) -> str:
    name = re.sub(r"\(anonymous namespace\)::", "", name)
    return re.sub(r", 256>", ">", name)


def kernels(ptxas: str) -> dict:
    """{mangled entry name: {"registers", "spill_stores", "spill_loads", "stack"}}"""
    res, cur = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
            res[cur] = {}
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = m.group(1) if m.group(1) in res else None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            res[cur].update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            res[cur]["registers"] = int(m.group(1))
    return res


def sass(obj: Path) -> dict:
    """{mangled function name: its SASS without the header line}, or {} without cuobjdump."""
    tool = shutil.which("cuobjdump") or ("/usr/local/cuda/bin/cuobjdump"
                                         if os.path.exists("/usr/local/cuda/bin/cuobjdump") else None)
    if tool is None:
        return {}
    text = subprocess.run([tool, "-sass", str(obj)], capture_output=True, text=True).stdout
    res = {}
    for part in text.split("Function : ")[1:]:
        head, _, body = part.partition("\n")
        res[head.strip()] = body
    return res


def table(csrc: Path, names, out: Path) -> dict:
    """{(source, normalised demangled name): (source, mangled, ptxas record, sass)}"""
    built = compile_all(csrc, names, out)
    rows = {}
    for name, (obj, text) in built.items():
        ks = kernels(text)
        code = sass(obj)
        dem = demangle(list(ks))
        for mangled, rec in ks.items():
            rows[name, normal(dem[mangled])] = (name, mangled, rec, code.get(mangled))
    return rows


def precision(name: str) -> str:
    if "__nv_bfloat16" in name or "mma_partial_kernel" in name:
        return "bf16"
    return "f64" if "double" in name else "f32" if "float" in name else "other"


def main() -> int:
    args = sys.argv[1:]
    against, changed = None, set()
    if "--against" in args:
        i = args.index("--against")
        against = Path(args[i + 1])
        del args[i:i + 2]
    if "--except" in args:
        i = args.index("--except")
        j = next((k for k in range(i + 1, len(args)) if args[k].startswith("--")), len(args))
        changed = set(args[i + 1:j])
        del args[i:j]
    names = args or sorted(p.name for p in build.CSRC.glob("*.cu"))
    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / "this").mkdir()
        rows = table(build.CSRC, names, Path(tmp) / "this")
        for (src, key), (_, _, rec, _) in sorted(rows.items()):
            print(f"{src}: {key}: {rec.get('registers')} registers, spill {rec.get('spill_stores')} / "
                  f"{rec.get('spill_loads')} bytes, stack {rec.get('stack')} bytes", flush=True)
        if against is None:
            return 0
        (Path(tmp) / "other").mkdir()
        other = table(against / "nequip_tpu_torch" / "csrc", names, Path(tmp) / "other")
    def compares(key) -> bool:
        return not (precision(key[1]) == "bf16" and key[0] in changed)

    differ, compared, with_sass = 0, {}, 0
    for key, (src, _, rec, code) in sorted(rows.items()):
        if not compares(key) or key not in other:
            continue
        _, _, orec, ocode = other[key]
        compared[precision(key[1])] = compared.get(precision(key[1]), 0) + 1
        same_sass = None if code is None or ocode is None else code == ocode
        with_sass += same_sass is not None
        if rec != orec or same_sass is False:
            differ += 1
            print(f"DIFFERS {src}: {key[1]}: {orec} -> {rec}, sass {'same' if same_sass else 'differs'}", flush=True)
    missing = [k for k in other if compares(k) and k not in rows]
    print(f"compared {sum(compared.values())} kernels against {against} ({compared}; {with_sass} with their SASS; "
          f"bf16 kernels of {sorted(changed)} not compared): {differ} differ"
          f"{'' if not missing else f'; only in {against}: {missing}'}", flush=True)
    return 1 if differ or missing else 0


if __name__ == "__main__":
    sys.exit(main())
