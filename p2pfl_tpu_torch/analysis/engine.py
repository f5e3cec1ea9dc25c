"""Rule engine core: parse → visit → suppress → baseline (a copy of
``p2pfl_tpu/analysis/engine.py``).

The engine is deliberately dumb and lexical — it parses files with stdlib
``ast`` and hands each module to every registered rule, then the rule's
project-wide ``finalize`` pass (for cross-file contracts like the wire
header registry). No imports of analyzed code, no type inference: every
rule here is a pattern distilled from a real incident, tuned so the
historical bug shape flags and the shipped fix passes (the "teeth"
fixtures in ``tests/test_torch_analysis.py`` pin both directions).

Escape hatches, in order of preference:

- ``# p2pfl: allow(rule-id) — justification`` on the finding's line (or
  the line directly above) suppresses that one finding, with the reason
  next to the code it excuses;
- a committed baseline file accepts a whole set of pre-existing findings
  by fingerprint, so the CLI can gate NEW violations on a tree with known
  debt (``--update-baseline`` refreshes it).
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple, Type, Union

from p2pfl_tpu_torch.analysis.findings import Finding

#: inline suppression: ``# p2pfl: allow(rule-id)``, ``allow(a, b)``, or
#: the every-rule wildcard ``allow(*)``
_SUPPRESS_RE = re.compile(r"#\s*p2pfl:\s*allow\(\s*([A-Za-z0-9_\-, *]+?)\s*\)")


@dataclass
class SourceModule:
    """One parsed file: path, source, AST, and its inline suppressions."""

    path: str
    source: str
    tree: ast.Module
    suppressions: Dict[int, Set[str]] = field(default_factory=dict)

    @classmethod
    def parse(cls, path: str, source: Optional[str] = None) -> "SourceModule":
        if source is None:
            with open(path, encoding="utf-8") as fh:
                source = fh.read()
        tree = ast.parse(source, filename=path)
        sup: Dict[int, Set[str]] = {}
        for lineno, line in enumerate(source.splitlines(), 1):
            m = _SUPPRESS_RE.search(line)
            if m:
                sup[lineno] = {tok.strip() for tok in m.group(1).split(",") if tok.strip()}
        return cls(path=path, source=source, tree=tree, suppressions=sup)

    @property
    def basename(self) -> str:
        return os.path.basename(self.path)

    def suppressed(self, line: int, rule_id: str) -> bool:
        """Pragma on the finding's line, or standalone on the line above."""
        for ln in (line, line - 1):
            ids = self.suppressions.get(ln)
            if ids and (rule_id in ids or "*" in ids):
                return True
        return False


class Rule:
    """Base rule: per-module check plus an optional project-wide pass.

    Rules are instantiated fresh per :func:`analyze` run, so a rule may
    accumulate cross-file state in ``check_module`` and cross-check it in
    ``finalize`` (the wire-header registry rule does exactly that).
    """

    id: str = ""
    summary: str = ""

    def check_module(self, mod: SourceModule) -> Iterable[Finding]:
        return ()

    def finalize(self) -> Iterable[Finding]:
        return ()


def iter_python_files(paths: Sequence[str]) -> List[str]:
    """Every ``.py`` under ``paths`` (files pass through), sorted, no dupes."""
    out: List[str] = []
    seen: Set[str] = set()
    for path in paths:
        if os.path.isfile(path):
            candidates = [path]
        else:
            candidates = []
            for root, dirs, files in os.walk(path):
                dirs[:] = sorted(d for d in dirs if not d.startswith(".") and d != "__pycache__")
                candidates += [os.path.join(root, f) for f in sorted(files) if f.endswith(".py")]
        for c in candidates:
            norm = os.path.normpath(c)
            if norm not in seen:
                seen.add(norm)
                out.append(norm)
    return out


def analyze(
    paths: Sequence[str],
    rules: Optional[Sequence[Type[Rule]]] = None,
    *,
    sources: Optional[Dict[str, str]] = None,
) -> List[Finding]:
    """Run ``rules`` (default: the registry) over every file under ``paths``.

    ``sources`` maps path → source text for in-memory analysis (tests).
    Inline-suppressed findings are dropped here; baseline filtering is the
    caller's second stage (:func:`new_findings`) so the CLI can report
    "N findings, M baselined" honestly.
    """
    if rules is None:
        from p2pfl_tpu_torch.analysis.rules import ALL_RULES

        rules = ALL_RULES
    instances = [r() for r in rules]
    mods: List[SourceModule] = []
    if sources is not None:
        mods = [SourceModule.parse(p, src) for p, src in sorted(sources.items())]
    else:
        for path in iter_python_files(paths):
            mods.append(SourceModule.parse(path))
    by_path = {m.path: m for m in mods}

    findings: List[Finding] = []
    for mod in mods:
        for rule in instances:
            findings += list(rule.check_module(mod))
    for rule in instances:
        findings += list(rule.finalize())

    kept = []
    for f in findings:
        mod = by_path.get(f.path)
        if mod is not None and mod.suppressed(f.line, f.rule):
            continue
        kept.append(f)
    kept.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return kept


# ---- baseline ----


def load_baseline(path: str) -> Dict[str, str]:
    """fingerprint → description; missing file = empty baseline."""
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    return dict(data.get("findings", {}))


def write_baseline(path: str, findings: Iterable[Finding]) -> None:
    data = {
        "comment": (
            "p2pfl-check baseline: accepted pre-existing findings by "
            "fingerprint. Prefer fixing, or an inline "
            "'# p2pfl: allow(rule-id)' with a justification, over adding here."
        ),
        "findings": {
            f.fingerprint: f"{f.path}: [{f.rule}] {f.message}"
            for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule))
        },
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(data, fh, indent=2, sort_keys=True)
        fh.write("\n")


def new_findings(findings: Iterable[Finding], baseline: Dict[str, str]) -> List[Finding]:
    return [f for f in findings if f.fingerprint not in baseline]


# ---- shared AST helpers (used by the rules) ----

FuncDef = Union[ast.FunctionDef, ast.AsyncFunctionDef]
FunctionNode = Tuple[str, FuncDef]  # (qualname, def node)

_FUNC_TYPES = (ast.FunctionDef, ast.AsyncFunctionDef)
_SCOPE_TYPES = _FUNC_TYPES + (ast.ClassDef,)


def walk_functions(tree: ast.Module) -> Iterator[FunctionNode]:
    """Every function/method in the module with its dotted qualname.

    Nested functions are yielded separately from their parents, so rules
    that must not treat a deferred closure as part of the enclosing
    control flow (a ``def`` under a lock runs later, outside the lock)
    can simply skip nested defs in their own traversal.
    """

    def rec(node: ast.AST, prefix: str) -> Iterator[FunctionNode]:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _FUNC_TYPES):
                qual = f"{prefix}{child.name}"
                yield qual, child
                yield from rec(child, qual + ".")
            elif isinstance(child, ast.ClassDef):
                yield from rec(child, f"{prefix}{child.name}.")
            else:
                yield from rec(child, prefix)

    yield from rec(tree, "")


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain of plain names, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def last_segment(node: ast.AST) -> Optional[str]:
    """Final attribute/name of a (possibly complex) dotted expression."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def node_pos(node: ast.AST) -> Tuple[int, int]:
    return (getattr(node, "lineno", 0), getattr(node, "col_offset", 0))


def node_end_pos(node: ast.AST) -> Tuple[int, int]:
    return (
        getattr(node, "end_lineno", getattr(node, "lineno", 0)),
        getattr(node, "end_col_offset", getattr(node, "col_offset", 0)),
    )


def iter_non_nested(node: ast.AST) -> Iterator[ast.AST]:
    """Walk a function body without descending into nested defs/classes
    (their bodies execute later, under different locks and liveness)."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, _SCOPE_TYPES) or isinstance(child, ast.Lambda):
            continue
        yield child
        yield from iter_non_nested(child)
