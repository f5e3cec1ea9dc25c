"""Finding and severity types of the port's static checks (a copy of
``p2pfl_tpu/analysis/findings.py``).

One report format for the invariant analyzer
(:mod:`p2pfl_tpu_torch.analysis`) and any later static check: a
:class:`Finding` names the rule, the location, and a human message;
:attr:`Finding.fingerprint` is a line-number-independent identity used by
the baseline mechanism, so reformatting a file does not resurrect
accepted debt. Stdlib only: the analyzer parses code, it never imports or
runs it.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from enum import Enum
from typing import Iterable


class Severity(str, Enum):
    """How a finding gates: ``error`` fails the CLI, the rest inform."""

    ERROR = "error"
    WARNING = "warning"
    INFO = "info"


@dataclass(frozen=True)
class Finding:
    """One rule violation at one source location.

    ``context`` is the enclosing ``Class.function`` qualname (or another
    stable anchor): it participates in the fingerprint instead of the
    line number, so accepted findings survive unrelated edits above them.
    """

    rule: str
    path: str
    line: int
    col: int
    message: str
    severity: Severity = Severity.ERROR
    context: str = ""

    def format(self) -> str:
        """``path:line:col: severity[rule-id] message`` — one line, grep-able."""
        return f"{self.path}:{self.line}:{self.col}: {self.severity.value}[{self.rule}] {self.message}"

    @property
    def fingerprint(self) -> str:
        """Stable identity for baselining: rule + tail of the path +
        enclosing context + message (never the line number)."""
        tail = "/".join(self.path.replace("\\", "/").split("/")[-2:])
        raw = "|".join((self.rule, tail, self.context, self.message))
        return hashlib.sha1(raw.encode()).hexdigest()[:16]


def format_findings(findings: Iterable[Finding]) -> str:
    """All findings, one line each, in deterministic order."""
    ordered = sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule))
    return "\n".join(f.format() for f in ordered)
