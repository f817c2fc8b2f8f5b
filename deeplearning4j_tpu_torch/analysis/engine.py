"""dl4j-lint rule engine: AST modules, suppressions, findings, driver.

Port of ``deeplearning4j_tpu/analysis/engine.py``. Stdlib-only by design
(like ``monitor/``): the linter runs in CI shells where importing the
package under analysis — let alone torch — is off the table. Rules work
on the AST plus raw source lines; they never execute the code they check.

Suppression syntax (inline, reviewable, reason REQUIRED)::

    self._flag = val  # dl4j-lint: disable=lock-discipline -- set before
                      # the thread starts

A suppression on a ``def``/``class`` header line covers the whole body;
anywhere else it covers that line only.  ``disable=all`` mutes every
rule.  A suppression without the ``-- reason`` tail is inert and is
itself reported (``suppression-missing-reason``): every silenced finding
carries its justification in the diff.

A fixture corpus (a file whose PURPOSE is to contain seeded violations)
opts out wholesale with a file-level pragma in its first 10 lines —
reason required, same as inline suppressions::

    # dl4j-lint: skip-file -- rule-fixture corpus; snippets ARE violations

Baseline workflow (for adopting a rule onto a codebase with existing
findings): ``python -m deeplearning4j_tpu_torch.analysis
--update-baseline`` snapshots current findings into
``.dl4j-lint-torch-baseline.json``; subsequent runs report only NEW
findings.  Fingerprints hash (rule, path, enclosing symbol, normalized
line text) — not line numbers — so unrelated edits above a baselined
finding do not resurrect it.  The shipped baseline stays EMPTY: real
findings get fixed, genuine exceptions get inline suppressions with
reasons.

A no-argument run scans the port package and the port's test files
(``tests/test_torch_*.py`` and their helper ``tests/torch_worlds.py``);
the reference's own linter (``scripts/dl4j_lint.py``) scans the JAX
package and every test file.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = [
    "Finding",
    "LintConfig",
    "Module",
    "Rule",
    "iter_py_files",
    "run_lint",
]

REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

_SUPPRESS_RE = re.compile(
    r"#\s*dl4j-lint:\s*disable=([A-Za-z0-9_,\-]+)"
    r"(?:\s*--\s*(?P<reason>\S.*))?")
_SKIPFILE_RE = re.compile(
    r"#\s*dl4j-lint:\s*skip-file(?:\s*--\s*(?P<reason>\S.*))?")
_SKIPFILE_SCAN_LINES = 10


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint finding, anchored to a source location."""

    rule: str
    path: str  # repo-relative, POSIX separators
    line: int
    col: int
    message: str
    symbol: str = ""  # dotted enclosing scope, e.g. "MLN._epoch_run_fn"

    def format(self) -> str:
        where = f"{self.path}:{self.line}:{self.col}"
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{where}: {self.rule}: {self.message}{sym}"


@dataclasses.dataclass
class LintConfig:
    """Cross-file context handed to every rule."""

    root: str = REPO_ROOT
    # pytest markers registered in pyproject.toml (None = parse the
    # root's pyproject; tests inject their own set)
    registered_markers: Optional[Set[str]] = None

    def markers(self) -> Set[str]:
        if self.registered_markers is None:
            self.registered_markers = _parse_pyproject_markers(
                os.path.join(self.root, "pyproject.toml"))
        return self.registered_markers


def _parse_pyproject_markers(path: str) -> Set[str]:
    """Registered marker names from ``[tool.pytest.ini_options] markers``.
    Hand-parsed: tomllib is 3.11+ and the linter must stay stdlib-only
    on 3.10. Quote-aware bracket tracking, so a ``]`` inside a marker
    DESCRIPTION does not truncate the list, and only the pre-``:`` name
    of each string element registers (quoted words in descriptions do
    not)."""
    try:
        with open(path, encoding="utf-8") as f:
            text = f.read()
    except OSError:
        return set()
    m = re.search(r"markers\s*=\s*\[", text)
    if not m:
        return set()
    i, depth = m.end(), 1
    items: List[str] = []
    buf: Optional[str] = None
    quote: Optional[str] = None
    while i < len(text) and depth:
        c = text[i]
        if quote is not None:
            if c == quote:
                items.append(buf or "")
                buf = quote = None
            else:
                buf = (buf or "") + c
        elif c in "\"'":
            quote, buf = c, ""
        elif c == "[":
            depth += 1
        elif c == "]":
            depth -= 1
        i += 1
    out = set()
    for item in items:
        name = item.split(":", 1)[0].strip()
        if re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name):
            out.add(name)
    return out


class Module:
    """One parsed source file: AST + parent/scope maps + suppressions."""

    def __init__(self, path: str, root: str = REPO_ROOT):
        self.path = os.path.abspath(path)
        self.rel = os.path.relpath(self.path, root).replace(os.sep, "/")
        with open(self.path, encoding="utf-8") as f:
            self.source = f.read()
        self.lines = self.source.splitlines()
        self.tree = ast.parse(self.source, filename=self.rel)
        self.parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
        # pragmas live in COMMENT tokens only — a docstring QUOTING the
        # pragma syntax (usage examples, this engine's own docstring)
        # must never register as a live suppression or skip the file
        comments: Dict[int, str] = {}
        try:
            for tok in tokenize.generate_tokens(
                    io.StringIO(self.source).readline):
                if tok.type == tokenize.COMMENT:
                    comments[tok.start[0]] = tok.string
        except (tokenize.TokenError, IndentationError,
                SyntaxError):  # pragma: no cover - ast.parse succeeded
            comments = {i: line for i, line in enumerate(self.lines, 1)
                        if "#" in line}
        # file-level opt-out for fixture corpora; reasonless pragma is
        # inert (and reported), exactly like inline suppressions
        self.skip_file = False
        self.skip_file_inert_line = 0
        for lineno in sorted(comments):
            if lineno > _SKIPFILE_SCAN_LINES:
                break
            m = _SKIPFILE_RE.search(comments[lineno])
            if m:
                if m.group("reason") is not None:
                    self.skip_file = True
                else:
                    self.skip_file_inert_line = lineno
                break
        # line -> (rules, has_reason); "all" mutes every rule
        self.line_suppressions: Dict[int, Tuple[Set[str], bool]] = {}
        for lineno, text in comments.items():
            m = _SUPPRESS_RE.search(text)
            if m:
                rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
                self.line_suppressions[lineno] = (
                    rules, m.group("reason") is not None)

    # -- scope helpers ---------------------------------------------------

    def enclosing_scopes(self, node: ast.AST) -> List[ast.AST]:
        """Innermost-first chain of enclosing def/class nodes."""
        out = []
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                out.append(cur)
            cur = self.parents.get(cur)
        return out

    def symbol_for(self, node: ast.AST) -> str:
        names = [s.name for s in self.enclosing_scopes(node)]
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.insert(0, node.name)
        return ".".join(reversed(names))

    # -- suppression resolution ------------------------------------------

    def suppressed(self, rule: str, node_or_line) -> bool:
        line = (node_or_line if isinstance(node_or_line, int)
                else getattr(node_or_line, "lineno", 0))
        cands = [line]
        if not isinstance(node_or_line, int):
            # a multi-line statement/expression accepts the suppression
            # on ANY of its lines (the natural spot is the closing one);
            # def/class anchors stay header-only — a comment deep in the
            # body must not mute a def-level finding
            end = getattr(node_or_line, "end_lineno", None)
            if (end is not None and end > line
                    and not isinstance(node_or_line,
                                       (ast.FunctionDef,
                                        ast.AsyncFunctionDef,
                                        ast.ClassDef))):
                cands.extend(range(line + 1, end + 1))
            scopes = self.enclosing_scopes(node_or_line)
            if isinstance(node_or_line, (ast.FunctionDef,
                                         ast.AsyncFunctionDef,
                                         ast.ClassDef)):
                # a finding anchored ON a def/class (e.g. marker-audit)
                # honors that header's own decorator lines too
                scopes = [node_or_line] + scopes
            for scope in scopes:
                cands.append(scope.lineno)
                # decorators sit above the def line; the comment may ride
                # on any decorator line of the scope header
                for dec in getattr(scope, "decorator_list", []):
                    cands.append(dec.lineno)
        for ln in cands:
            entry = self.line_suppressions.get(ln)
            if entry is None:
                continue
            rules, has_reason = entry
            if has_reason and (rule in rules or "all" in rules):
                return True
        return False

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        return Finding(rule=rule, path=self.rel,
                       line=getattr(node, "lineno", 0),
                       col=getattr(node, "col_offset", 0),
                       message=message, symbol=self.symbol_for(node))


class Rule:
    """Base rule: subclasses set ``id``/``doc`` and implement ``check``."""

    id: str = ""
    doc: str = ""

    def check(self, module: Module, config: LintConfig) -> List[Finding]:
        raise NotImplementedError

    def emit(self, out: List[Finding], module: Module, node: ast.AST,
             message: str) -> None:
        """Append a finding unless an inline suppression (on the line or
        on an enclosing def/class header) mutes this rule there."""
        if not module.suppressed(self.id, node):
            out.append(module.finding(self.id, node, message))


SKIP_DIRS = {"__pycache__", ".git", ".dl4j_worktrees", "node_modules"}
# repo-relative roots a no-argument run scans: the port package, and of
# tests/ only the port's files; the CLI's partial --update-baseline
# derives its "what did this run re-check" set from the SAME list, so the
# two can never drift
DEFAULT_SCAN_DIRS = ("deeplearning4j_tpu_torch",)
DEFAULT_TEST_GLOBS = ("tests/test_torch_*.py", "tests/torch_worlds.py")


def default_scan_paths(root: str = REPO_ROOT) -> List[str]:
    import glob

    paths = [os.path.join(root, d) for d in DEFAULT_SCAN_DIRS]
    for pattern in DEFAULT_TEST_GLOBS:
        paths.extend(sorted(glob.glob(os.path.join(root, pattern))))
    return paths


def iter_py_files(paths: Sequence[str]) -> Iterable[str]:
    for p in paths:
        p = os.path.abspath(p)
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs if d not in SKIP_DIRS)
            for name in sorted(files):
                if name.endswith(".py"):
                    yield os.path.join(root, name)


def _suppression_hygiene(module: Module) -> List[Finding]:
    """Inert suppressions (no ``-- reason``) are themselves findings."""
    out = []
    if module.skip_file_inert_line:
        out.append(Finding(
            rule="suppression-missing-reason", path=module.rel,
            line=module.skip_file_inert_line, col=0,
            message=("skip-file pragma has no '-- reason' tail and is "
                     "ignored; a whole-file opt-out must say why")))
    for line, (rules, has_reason) in sorted(
            module.line_suppressions.items()):
        if not has_reason:
            out.append(Finding(
                rule="suppression-missing-reason", path=module.rel,
                line=line, col=0,
                message=("suppression for %s has no '-- reason' tail and "
                         "is ignored; every silenced finding must say why"
                         % ",".join(sorted(rules)))))
    return out


def run_lint(paths: Optional[Sequence[str]] = None,
             select: Optional[Sequence[str]] = None,
             config: Optional[LintConfig] = None) -> List[Finding]:
    """Run the (selected) ruleset over ``paths``; suppressions applied,
    baseline NOT applied (that is the CLI's job — callers that want raw
    findings, like the fixture tests, get them here)."""
    from deeplearning4j_tpu_torch.analysis.rules import ALL_RULES

    config = config or LintConfig()
    if paths is None:
        paths = default_scan_paths(config.root)
    rules = [r for r in ALL_RULES
             if select is None or r.id in set(select)]
    findings: List[Finding] = []
    for path in iter_py_files(paths):
        try:
            module = Module(path, root=config.root)
        except (SyntaxError, UnicodeDecodeError) as exc:
            findings.append(Finding(
                rule="parse-error",
                path=os.path.relpath(path, config.root).replace(os.sep, "/"),
                line=getattr(exc, "lineno", 0) or 0, col=0,
                message=f"cannot parse: {exc}"))
            continue
        if module.skip_file:
            continue  # fixture corpus: neither rules nor hygiene apply
        if select is None or "suppression-missing-reason" in set(select):
            findings.extend(_suppression_hygiene(module))
        for rule in rules:
            findings.extend(rule.check(module, config))
    return findings
