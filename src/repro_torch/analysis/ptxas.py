"""The build's ``ptxas -v`` report held against each kernel package's
``KERNEL_META['device_kernels']`` (DESIGN.md §10, §15).

``_build`` compiles with ``-Xptxas -v`` and keeps nvcc's output beside
each library (``<package>-<hash>.log``). For every entry function there
the report gives its registers, its static shared memory and its spills.
This module reads that report, demangles the kernel names (nested names,
anonymous namespaces dropped, bool and integer template arguments: the
``dense::dense_push<true>`` spelling of ``KERNEL_META``) and checks:

  * every kernel in the report is declared, by the package whose files
    define it (a library also holds the kernels of the headers it
    includes), and so is its template instance;
  * its static shared memory equals the declared ``ptxas_smem_bytes``, or
    ``static_smem_bytes`` where none is given;
  * its registers stay within ``max_registers`` where one is declared;
  * every kernel and instance a package declares is in its own library's
    report.

A missing report is a failure, never a skip. ``chip_smoke.py`` runs this
on the card's build.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from repro_torch.analysis import cudasrc
from repro_torch.analysis.rules.kernel_shapes import instances, read_meta

KERNELS_DIR = Path(__file__).resolve().parents[1] / "kernels"

_ENTRY_RE = re.compile(r"Compiling entry function '([^']+)'")
_PROPS_RE = re.compile(r"Function properties for (\S+)")
_SPILL_RE = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_USED_RE = re.compile(r"Used (\d+) registers")
_SMEM_RE = re.compile(r"(\d+) bytes smem")
# Itanium literal template arguments: L <type code> [n]<digits> E
_INT_CODES = set("acdhijlmnostxy")


@dataclass
class Entry:
    """One entry function of a ptxas report."""
    mangled: str
    registers: Optional[int] = None
    smem: int = 0
    spill_stores: int = 0
    spill_loads: int = 0


def parse_report(text: str) -> dict[str, Entry]:
    """Entry functions of a ``ptxas -v`` report, by mangled name."""
    out: dict[str, Entry] = {}
    cur: Optional[Entry] = None
    props: Optional[str] = None
    for line in text.splitlines():
        m = _ENTRY_RE.search(line)
        if m:
            cur = out.setdefault(m.group(1), Entry(m.group(1)))
            props = None
            continue
        m = _PROPS_RE.search(line)
        if m:
            props = m.group(1)
            continue
        m = _SPILL_RE.search(line)
        if m and cur is not None and props == cur.mangled:
            cur.spill_stores, cur.spill_loads = map(int, m.groups())
            continue
        m = _USED_RE.search(line)
        if m and cur is not None:
            cur.registers = int(m.group(1))
            s = _SMEM_RE.search(line)
            cur.smem = int(s.group(1)) if s else 0
    return out


def _source_name(m: str, i: int) -> tuple[str, int]:
    j = i
    while j < len(m) and m[j].isdigit():
        j += 1
    n = int(m[i:j])
    return m[j:j + n], j + n


def _template_args(m: str, i: int) -> tuple[list[str], int]:
    """Literal arguments of ``I ... E`` at ``m[i]``."""
    args = []
    i += 1
    while m[i] != "E":
        if m[i] != "L" or m[i + 1] not in _INT_CODES | {"b"}:
            raise ValueError(f"unsupported template argument at {m[i:]}")
        code = m[i + 1]
        j = m.index("E", i + 2)
        raw = m[i + 2:j]
        value = -int(raw[1:]) if raw.startswith("n") else int(raw)
        args.append(("true" if value else "false") if code == "b"
                    else str(value))
        i = j + 1
    return args, i + 1


def demangle(mangled: str) -> str:
    """``ns::kernel<args>`` of a mangled kernel name (anonymous
    namespaces dropped); the name itself where it is not of that form."""
    if not mangled.startswith("_Z"):
        return mangled
    try:
        i, parts, targs = 2, [], None
        if mangled[i] == "N":
            i += 1
            while mangled[i] != "E":
                if mangled[i].isdigit():
                    name, i = _source_name(mangled, i)
                    parts.append(name)
                elif mangled[i] == "I":
                    targs, i = _template_args(mangled, i)
                else:
                    return mangled
        else:
            name, i = _source_name(mangled, i)
            parts.append(name)
            if i < len(mangled) and mangled[i] == "I":
                targs, i = _template_args(mangled, i)
    except (ValueError, IndexError):
        return mangled
    name = "::".join(p for p in parts if not p.startswith("_GLOBAL__N"))
    return name + (f"<{', '.join(targs)}>" if targs is not None else "")


def split_instance(name: str) -> tuple[str, str]:
    """(``ns::kernel``, ``<args>`` or "")."""
    k = name.find("<")
    return (name, "") if k < 0 else (name[:k], name[k:])


def check_build(libraries: dict[str, Path], kernels_dir: Path = KERNELS_DIR
                ) -> tuple[list[dict], list[str]]:
    """(one row per kernel of each library's report, failures). A
    library's report is ``<library>.log``."""
    metas: dict[str, dict] = {}
    failures: list[str] = []
    for meta_py in sorted(kernels_dir.glob("*/meta.py")):
        meta, _, problem = read_meta(meta_py)
        if meta is None:
            failures.append(f"{meta_py.parent.name}/meta.py: {problem}")
        else:
            metas[meta_py.parent.name] = meta
    rows: list[dict] = []
    for pkg, lib in sorted(libraries.items()):
        log = Path(lib).with_suffix(".log")
        if not log.is_file():
            failures.append(f"{pkg}: no ptxas report {log}")
            continue
        owners = sorted({f.parent.name for f in cudasrc.read_unit(
            kernels_dir / pkg / "kernel.cu").files})
        seen: set[str] = set()
        for entry in parse_report(log.read_text()).values():
            name = demangle(entry.mangled)
            base, args = split_instance(name)
            owner = next((o for o in owners if base in metas.get(
                o, {}).get("device_kernels", {})), None)
            row = {"package": pkg, "kernel": name, "owner": owner,
                   "registers": entry.registers, "smem": entry.smem,
                   "spill_stores": entry.spill_stores,
                   "spill_loads": entry.spill_loads}
            rows.append(row)
            if owner is None:
                failures.append(f"{pkg}: {name} ({entry.mangled}) is in "
                                f"the ptxas report but no meta.py of "
                                f"{owners} declares it")
                continue
            inst = instances(metas[owner]["device_kernels"][base]).get(args)
            if inst is None:
                failures.append(f"{pkg}: {name} is in the ptxas report but "
                                f"{owner}/meta.py lists no instance {args!r}")
                continue
            if owner == pkg:
                seen.add(name)
            want = inst.get("ptxas_smem_bytes", inst.get("static_smem_bytes"))
            cap = inst.get("max_registers")
            row.update(meta_smem=want, max_registers=cap,
                       dynamic=inst.get("dynamic_smem_bytes"))
            if entry.smem != want:
                failures.append(f"{pkg}: {name} takes {entry.smem} bytes of "
                                f"static shared memory, {owner}/meta.py "
                                f"says {want}")
            if entry.registers is None:
                failures.append(f"{pkg}: {name} has no register count in "
                                f"the report")
            elif cap is not None and entry.registers > cap:
                failures.append(f"{pkg}: {name} uses {entry.registers} "
                                f"registers, over its max_registers {cap}")
        for base, spec in metas.get(pkg, {}).get("device_kernels",
                                                 {}).items():
            for args in instances(spec):
                if base + args not in seen:
                    failures.append(f"{pkg}: meta.py declares {base}{args}, "
                                    f"which is not in the ptxas report")
    return rows, failures


def render(row: dict) -> str:
    cap, dyn = row.get("max_registers"), row.get("dynamic")
    return (f"{row['package']}: {row['kernel']}: smem {row['smem']} B "
            f"(meta {row.get('meta_smem')})"
            f"{f' + dynamic up to {dyn} B (meta)' if dyn else ''}, "
            f"{row['registers']} registers"
            f"{f' (cap {cap})' if cap is not None else ''}, spills "
            f"{row['spill_stores']}/{row['spill_loads']} B")
