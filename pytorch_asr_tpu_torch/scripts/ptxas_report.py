"""ptxas's resource report of each kernel in a CUDA source, and the kernels
whose report differs between two sources (card machine only: needs ``nvcc``):

    python -m pytorch_asr_tpu_torch.scripts.ptxas_report <a.cu> [<b.cu>]

Each source is compiled as ``ops/build.py`` compiles it (its flags, which
include ``-Xptxas -v``; the source's own directory on the include path) into a
temporary directory.  For each kernel, by its demangled name (``c++filt`` or
the toolkit's ``cu++filt``), the report is ptxas's "Used ..." line (registers,
barriers, shared and constant memory) and its stack and spill line.  With two
sources it also matches b's kernels to a's: by name, or, for a kernel that
gained a trailing template flag of false, by its name without that flag and
with parameters of ``std::conditional_t<false, X, Y>`` named Y (all of them,
or those the new flag chose); and prints those whose report differs, those
only in b (new) and those only in a (gone). Prints one JSON record.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

from pytorch_asr_tpu_torch.ops import build

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")


def _demangle(names: list[str]) -> list[str]:
    tool = shutil.which("c++filt") or shutil.which("cu++filt")
    if tool is None:
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True,
                         check=True).stdout.splitlines()
    return out if len(out) == len(names) else names


def report(source: str) -> dict[str, str]:
    """{demangled kernel name: "Used ... | stack and spills"} of ``source``."""
    src = Path(source).resolve()
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(src.parent), "-o",
                               str(Path(tmp) / "lib.so"), str(src)], capture_output=True,
                              text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    entries, name = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        if m := _ENTRY.search(line):
            name = m.group(1)
            entries[name] = []
        elif name is not None and ("bytes stack frame" in line or "Used " in line):
            entries[name].append(line.split(":", 1)[-1].strip())
    names = list(entries)
    return {d: " | ".join(entries[n]) for n, d in zip(names, _demangle(names))}


_COND = re.compile(r"std::conditional<false, [^<>]*?, ([^<>]*?)>::type")


def _old_names(name: str) -> list[str]:
    """A kernel's name without a trailing template flag of false, with the
    parameter types that flag may have chosen (``std::conditional<false, X,
    Y>::type``) written as Y: all of them first, then each subset (a type an
    earlier flag chose stays as the old name has it)."""
    name = re.sub(r", false>\(", ">(", name, count=1)
    spans = [m.span() for m in _COND.finditer(name)]
    out = []
    for keep in range(2 ** len(spans)):
        new, end = "", 0
        for i, (lo, hi) in enumerate(spans):
            new += name[end:lo] + (name[lo:hi] if keep >> i & 1 else _COND.sub(r"\1", name[lo:hi]))
            end = hi
        out.append(new + name[end:])
    return out


def compare(a: dict[str, str], b: dict[str, str]) -> dict:
    matched, differs, new = {}, {}, []
    for name, rep in b.items():
        old = name if name in a else next((o for o in _old_names(name) if o in a), None)
        if old is None:
            new.append(name)
            continue
        matched[name] = old
        if a[old] != rep:
            differs[name] = {"a": a[old], "b": rep}
    return {"matched": len(matched), "differs": differs, "new": new,
            "gone": sorted(set(a) - set(matched.values()))}


def main(argv: list[str] | None = None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    if not 1 <= len(argv) <= 2:
        raise SystemExit(__doc__)
    reports = [report(s) for s in argv]
    out = {"sources": argv, "kernels": reports}
    if len(reports) == 2:
        out["compare"] = compare(*reports)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
