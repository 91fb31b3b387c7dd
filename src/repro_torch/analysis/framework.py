"""Rule registry and suppression plumbing for
``repro_torch.analysis``, the port's invariant linter (DESIGN.md §15).

The port's correctness rests on the same hand-maintained structural
invariants as the JAX package's (mirrored adjacency writes, the single
``traversable`` predicate, sorted entity-lock discipline, the WAL written
before any ack, epoch-validated index reads), plus one of its own: the C
launchers of its CUDA kernels agree with the Python calls that reach
them. Each invariant is a *rule* — a pure function from parsed source to
findings — so a violation is caught at diff time instead of waiting for
a property test (or a card) to hit it.

Vocabulary:

  * A **rule** has a unique kebab-case name, a severity, a one-line
    invariant statement, and a ``check`` callback. File-scoped rules run
    once per scanned file (``FileContext``); repo-scoped rules run once
    per analysis (``RepoContext``) and walk whatever they need.
  * A **finding** is (rule, path, line, message). Findings are what the
    CLI prints, ``--json`` serializes, and CI gates on.
  * An inline ``repro-torch-lint: allow(rule-a, rule-b)`` comment
    (written after a ``#``) — on the offending line or the line directly
    above it — suppresses matching findings. Suppressions that silence
    nothing are themselves reported (rule name ``unused-suppression``) so
    dead allows cannot accumulate. The marker is the port's own: the JAX
    package's linter reads its ``repro-lint`` marker anywhere in the tree
    and calls an allow dead where its rule ran and did not fire, so the
    two linters must not share one. An allow is how a justified,
    pre-existing finding is recorded: there is no baseline file.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Iterable, Optional, Union

SEVERITIES = ("error", "warning")

# Inline suppression syntax. Intentionally strict: exactly this spelling,
# so grep finds every allow in the tree.
ALLOW_RE = re.compile(
    r"#\s*repro-torch-lint:\s*allow\(([a-z0-9_,\-\s]+)\)")

# Paths never scanned by the default walk: deliberate-violation fixtures.
GLOBAL_EXCLUDES = ("tests/lint_fixtures_torch",)

# The default walk, relative to the analysis root (usually the repo): the
# port's files only.
DEFAULT_GLOBS = ("src/repro_torch/**/*.py", "tests/test_torch_*.py",
                 "tests/torch_jax_isolation.py", "tools/ab_*.py",
                 "examples/*_torch.py", "chip_smoke.py")

UNUSED_SUPPRESSION = "unused-suppression"


@dataclass(frozen=True)
class Finding:
    """One rule violation, anchored to a file and line."""

    rule: str
    path: str          # repo-relative, forward slashes
    line: int          # 1-indexed; 0 = whole-file finding
    message: str
    severity: str = "error"

    def key(self) -> tuple:
        return (self.rule, self.path, self.line, self.message)

    def to_json(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message, "severity": self.severity}

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: [{self.rule}] {self.message}"


class FileContext:
    """Everything a file-scoped rule may look at for one source file."""

    def __init__(self, root: Path, path: Path, source: str):
        self.root = root
        self.path = path
        self.relpath = _rel(root, path)
        self.source = source
        self.lines = source.splitlines()
        self._tree: Optional[ast.AST] = None
        self._parse_error: Optional[SyntaxError] = None

    @property
    def tree(self) -> Optional[ast.Module]:
        """Parsed AST with parent links, or None on a syntax error (the
        runner reports unparseable files once, as a framework finding)."""
        if self._tree is None and self._parse_error is None:
            try:
                tree = ast.parse(self.source, filename=str(self.path))
            except SyntaxError as e:  # pragma: no cover - defensive
                self._parse_error = e
                return None
            for node in ast.walk(tree):
                for child in ast.iter_child_nodes(node):
                    child._repro_parent = node  # type: ignore[attr-defined]
            self._tree = tree
        return self._tree  # type: ignore[return-value]

    def finding(self, rule: "Rule", node_or_line, message: str) -> Finding:
        line = getattr(node_or_line, "lineno", node_or_line)
        return Finding(rule.name, self.relpath, int(line), message,
                       rule.severity)


class RepoContext:
    """What a repo-scoped rule sees: the root and the scanned file set."""

    def __init__(self, root: Path, files: list[Path]):
        self.root = root
        self.files = files

    def rel(self, path: Path) -> str:
        return _rel(self.root, path)

    def finding(self, rule: "Rule", path: Path, line: int,
                message: str) -> Finding:
        return Finding(rule.name, _rel(self.root, path), int(line), message,
                       rule.severity)


CheckFn = Callable[[Union[FileContext, RepoContext]], Iterable[Finding]]


@dataclass
class Rule:
    """A registered invariant check.

    ``default_filter`` restricts which files the rule sees during a
    DEFAULT root walk (repo gate); files passed explicitly to ``run`` are
    always offered to every file-scoped rule, so fixtures under tests/
    can exercise rules whose default scope excludes tests.
    """

    name: str
    invariant: str                      # one-line statement of the invariant
    check: CheckFn
    scope: str = "file"                 # "file" | "repo"
    severity: str = "error"
    origin: str = ""                    # PR / bug class that motivated it
    default_filter: Callable[[str], bool] = lambda rel: True

    def __post_init__(self):
        assert self.scope in ("file", "repo"), self.scope
        assert self.severity in SEVERITIES, self.severity


_REGISTRY: dict[str, Rule] = {}


def register(rule: Rule) -> Rule:
    """Add a rule to the registry (import-time side effect of the
    ``repro_torch.analysis.rules`` package)."""
    if rule.name in _REGISTRY:
        raise ValueError(f"duplicate rule name {rule.name!r}")
    _REGISTRY[rule.name] = rule
    return rule


def all_rules() -> list[Rule]:
    """Registered rules, sorted by name (imports the rules package once)."""
    import repro_torch.analysis.rules  # noqa: F401  (registration side effect)

    return [(_REGISTRY[k]) for k in sorted(_REGISTRY)]


def get_rule(name: str) -> Rule:
    import repro_torch.analysis.rules  # noqa: F401

    try:
        return _REGISTRY[name]
    except KeyError:
        known = ", ".join(sorted(_REGISTRY))
        raise KeyError(f"unknown rule {name!r} (known: {known})") from None


# ----------------------------------------------------------------------------
# Suppressions
# ----------------------------------------------------------------------------
class Suppressions:
    """Parsed ``repro-torch-lint: allow(...)`` comments of one file.

    An allow on line N silences findings of the named rules on line N and
    line N+1 (i.e. the comment sits on the offending line or directly
    above it). ``unused`` reports allows that silenced nothing.
    """

    def __init__(self, source: str):
        # line -> set of rule names allowed there
        self.allows: dict[int, set[str]] = {}
        self._used: dict[int, set[str]] = {}
        for i, text in enumerate(source.splitlines(), 1):
            m = ALLOW_RE.search(text)
            if m:
                names = {n.strip() for n in m.group(1).split(",") if n.strip()}
                self.allows[i] = names

    def suppresses(self, finding: Finding) -> bool:
        for line in (finding.line, finding.line - 1):
            names = self.allows.get(line)
            if names and finding.rule in names:
                self._used.setdefault(line, set()).add(finding.rule)
                return True
        return False

    def unused(self, relpath: str,
               active: Optional[set] = None) -> list[Finding]:
        """Allows that silenced nothing. ``active`` restricts the check to
        the rules that actually ran — a single-rule run must not call every
        other rule's allows dead."""
        out = []
        for line, names in sorted(self.allows.items()):
            dead = names - self._used.get(line, set())
            if active is not None:
                dead &= active
            for name in sorted(dead):
                out.append(Finding(
                    UNUSED_SUPPRESSION, relpath, line,
                    f"allow({name}) suppresses nothing — remove it",
                    "error"))
        return out


# ----------------------------------------------------------------------------
# Running
# ----------------------------------------------------------------------------
@dataclass
class AnalysisResult:
    """Everything one analysis run produced, pre-gating."""

    findings: list[Finding] = field(default_factory=list)       # live
    suppressed: list[Finding] = field(default_factory=list)     # via allow()
    files_scanned: int = 0
    rules_run: list[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_json(self) -> dict:
        return {
            "ok": self.ok,
            "files_scanned": self.files_scanned,
            "rules": self.rules_run,
            "findings": [f.to_json() for f in self.findings],
            "suppressed": [f.to_json() for f in self.suppressed],
        }


def _rel(root: Path, path: Path) -> str:
    try:
        return path.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        return path.as_posix()


def default_files(root: Path) -> list[Path]:
    """The default scan set: every file of ``DEFAULT_GLOBS``, minus the
    deliberate-violation fixtures."""
    out: dict[Path, None] = {}
    for pattern in DEFAULT_GLOBS:
        for p in sorted(root.glob(pattern)):
            rel = _rel(root, p)
            if not p.is_file() or any(rel.startswith(x)
                                      for x in GLOBAL_EXCLUDES):
                continue
            out.setdefault(p)
    return list(out)


def run(root: Path, paths: Optional[list[Path]] = None,
        rules: Optional[list[Rule]] = None) -> AnalysisResult:
    """Run ``rules`` (default: all registered) over ``paths`` (default:
    the standard root walk) and fold in suppressions.

    Explicit ``paths`` bypass the per-rule default filters — that is how
    the fixture tests point one rule at one deliberately-bad file.
    """
    root = Path(root)
    explicit = paths is not None
    files = [Path(p) for p in paths] if explicit else default_files(root)
    rules = list(rules) if rules is not None else all_rules()

    result = AnalysisResult(files_scanned=len(files),
                            rules_run=[r.name for r in rules])
    raw: list[Finding] = []
    contexts: dict[str, FileContext] = {}

    file_rules = [r for r in rules if r.scope == "file"]
    repo_rules = [r for r in rules if r.scope == "repo"]

    for path in files:
        try:
            source = path.read_text(encoding="utf-8")
        except OSError as e:
            raw.append(Finding("framework", _rel(root, path), 0,
                               f"unreadable: {e}"))
            continue
        ctx = FileContext(root, path, source)
        contexts[ctx.relpath] = ctx
        if path.suffix != ".py":
            continue
        if ctx.tree is None:
            raw.append(Finding("framework", ctx.relpath, 0,
                               "syntax error — file not analyzable"))
            continue
        for rule in file_rules:
            if not explicit and not rule.default_filter(ctx.relpath):
                continue
            raw.extend(rule.check(ctx))

    repo_ctx = RepoContext(root, files)
    for rule in repo_rules:
        raw.extend(rule.check(repo_ctx))

    # de-dup (a rule revisiting a node must not double-report), stable order
    seen: set[tuple] = set()
    ordered: list[Finding] = []
    for f in sorted(raw, key=lambda f: (f.path, f.line, f.rule, f.message)):
        if f.key() not in seen:
            seen.add(f.key())
            ordered.append(f)

    # suppressions: parsed per file that actually has findings
    supp_cache: dict[str, Suppressions] = {}
    live: list[Finding] = []
    for f in ordered:
        supp = supp_cache.get(f.path)
        if supp is None:
            ctx = contexts.get(f.path)
            if ctx is None:
                fpath = root / f.path
                try:
                    src = fpath.read_text(encoding="utf-8")
                except OSError:
                    src = ""
            else:
                src = ctx.source
            supp = supp_cache[f.path] = Suppressions(src)
        if supp.suppresses(f):
            result.suppressed.append(f)
        else:
            live.append(f)

    # dead allows: checked for every SCANNED file (not only files with
    # findings), so a stale allow() cannot hide forever
    active = {r.name for r in rules}
    for relpath, ctx in contexts.items():
        supp = supp_cache.get(relpath) or Suppressions(ctx.source)
        live.extend(supp.unused(relpath, active))

    result.findings = sorted(live, key=lambda f: (f.path, f.line, f.rule))
    return result
