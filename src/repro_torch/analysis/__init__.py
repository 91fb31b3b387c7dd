"""repro_torch.analysis — the port's invariant linter and CUDA kernel
sanitizer (DESIGN.md §15).

``python -m repro_torch.analysis`` runs every registered rule over the
port's files and exits non-zero on live findings. See ``framework.py``
for the rule/suppression model, ``rules/`` for the invariants,
``cudasrc.py`` for the reading of the ``.cu`` sources and ``ptxas.py``
for the check of a build's ``ptxas -v`` report against each package's
``KERNEL_META``. Nothing here imports ``jax`` or the JAX package; only
the metrics-doc rule imports modules of ``repro_torch``.
"""
from repro_torch.analysis.framework import (  # noqa: F401
    AnalysisResult,
    FileContext,
    Finding,
    RepoContext,
    Rule,
    all_rules,
    get_rule,
    register,
    run,
)

__all__ = [
    "AnalysisResult", "FileContext", "Finding", "RepoContext", "Rule",
    "all_rules", "get_rule", "register", "run",
]
