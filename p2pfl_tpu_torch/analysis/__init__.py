"""p2pfl-check on the port: static enforcement of its concurrency, merge,
wire and host-gather contracts (counterpart of ``p2pfl_tpu/analysis``).

An AST-based rule engine over the code (stdlib ``ast`` only: analyzed code
is parsed, never imported or run). Four rules, each a contract the port
keeps as the JAX package does: no lock held across a send
(``send-under-lock``), control-plane lattice merges under
``status_merge_lock`` (``monotone-merge``), optional wire-header keys that
decode unchanged when absent and never reach the protobuf interop schema
(``wire-header-compat``), and no host copy of payload data in the ICI
weights plane (``no-host-gather``, rewritten for torch's host
materialisations). JAX's ``donation-reuse`` and ``jit-staleness`` have
nothing to check here: the port donates no buffers and traces no jitted
programs.

Usage::

    python -m p2pfl_tpu_torch.analysis p2pfl_tpu_torch     # exit 1 on findings
    python -m p2pfl_tpu_torch.analysis --list-rules

Findings are suppressed inline with ``# p2pfl: allow(rule-id)`` (same line
or the line above, with a justification after the pragma) or accepted
wholesale through a committed baseline file (``--baseline`` /
``--update-baseline``), so the gate blocks new violations on a tree with
known debt.
"""

from p2pfl_tpu_torch.analysis.engine import (
    Rule,
    SourceModule,
    analyze,
    load_baseline,
    new_findings,
    write_baseline,
)
from p2pfl_tpu_torch.analysis.findings import Finding, Severity

__all__ = [
    "Finding",
    "Rule",
    "Severity",
    "SourceModule",
    "analyze",
    "load_baseline",
    "new_findings",
    "write_baseline",
]
