"""Module walking + import preflight (DESIGN.md §15).

The analysis framework's one *runtime* helper: enumerate the modules of a
package directory and verify each imports cleanly BEFORE anything expensive consumes them. Consumer:
``chip_smoke.py``'s analysis phase imports every module of
``repro_torch`` on the card's machine, where no ``jax`` is installed.
"""
from __future__ import annotations

import importlib
import traceback
from pathlib import Path
from typing import Iterator, Sequence


def iter_package_modules(pkg_dir: Path, pkg_name: str
                         ) -> Iterator[tuple[str, Path]]:
    """Yield (dotted module name, path) for every .py module under a
    package directory (subpackages included, __init__ as the package
    itself). Pure filesystem walk — nothing is imported."""
    pkg_dir = Path(pkg_dir)
    for path in sorted(pkg_dir.rglob("*.py")):
        rel = path.relative_to(pkg_dir)
        parts = list(rel.parts[:-1])
        stem = rel.stem
        if stem != "__init__":
            parts.append(stem)
        name = ".".join([pkg_name] + parts) if parts else pkg_name
        yield name, path


def preflight_imports(modules: Sequence[str]) -> list[str]:
    """Import every named module; return human-readable errors (empty =
    all clean)."""
    errors: list[str] = []
    for name in modules:
        try:
            importlib.import_module(name)
        except BaseException as e:  # noqa: BLE001 - report, never crash
            tb = traceback.format_exception_only(type(e), e)[-1].strip()
            errors.append(f"{name}: import failed — {tb}")
    return errors
