"""send-under-lock: no protocol send may run while a lock is held.

Incident: the async control plane's handlers run inline on the in-memory
transport — a send made while holding a context/state lock re-enters the
receiver's handler synchronously, which takes its own lock and may send
back, deadlocking two nodes on each other (the async plane's contract:
"handlers compute under locks, collect Action tuples, and
execute_actions runs outside every lock"). On the gRPC transport the
same shape is a latency bomb instead: a send blocks up to
GOSSIP_SEND_TIMEOUT with the lock held, stalling every handler thread.

The rule flags any call whose final attribute is a known transport-send
entry point when it is lexically inside a ``with <…lock>:`` body.
Nested ``def``/``lambda`` bodies are exempt — a closure defined under a
lock runs later, outside it (the eviction-repair thread pattern in
``node.py``).
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, List, Optional, Sequence

from p2pfl_tpu_torch.analysis.engine import (
    Rule,
    SourceModule,
    _SCOPE_TYPES,
    last_segment,
    walk_functions,
)
from p2pfl_tpu_torch.analysis.findings import Finding

#: transport send entry points (communication/protocol.py + gossiper),
#: the async plane's action runner (which fans sends out), and the node
#: journal's snapshot commit (federation/durability.py) — blocking disk
#: I/O with the same stall shape as a send: fsync under a context lock
#: freezes every handler thread for the write's duration
SEND_CALLS = frozenset(
    {
        "send",
        "broadcast",
        "_do_send",
        "_send_to_neighbor",
        "_transport_send",
        "_dispatch_sends",
        "send_message",
        "send_weights",
        "gossip_weights",
        "execute_actions",
        "commit_snapshot",
    }
)


_LOCKISH = re.compile(r"(lock|mutex|cv|cond|condition)$", re.IGNORECASE)


def _lock_name(expr: ast.AST) -> Optional[str]:
    """Name of a with-item that acquires a lock or condition
    (``with self.lock:``, ``with st.status_merge_lock:``,
    ``with self._queue_cv:`` …)."""
    target = expr.func if isinstance(expr, ast.Call) else expr
    name = last_segment(target)
    if name and _LOCKISH.search(name):
        return name
    return None


class SendUnderLockRule(Rule):
    id = "send-under-lock"
    summary = "no transport send while holding a lock (async deadlock contract)"

    def check_module(self, mod: SourceModule) -> Iterable[Finding]:
        out: List[Finding] = []
        for qual, fn in walk_functions(mod.tree):
            self._visit(mod, qual, list(fn.body), [], out)
        return out

    def _visit(
        self,
        mod: SourceModule,
        qual: str,
        nodes: Sequence[ast.AST],
        locks: List[str],
        out: List[Finding],
    ) -> None:
        for node in nodes:
            if isinstance(node, _SCOPE_TYPES) or isinstance(node, ast.Lambda):
                continue  # deferred body: runs outside this lock scope
            held = locks
            if isinstance(node, (ast.With, ast.AsyncWith)):
                acquired: List[str] = []
                for item in node.items:
                    name = _lock_name(item.context_expr)
                    if name is not None:
                        acquired.append(name)
                if acquired:
                    held = locks + acquired
                self._visit(mod, qual, list(node.body), held, out)
                continue
            if locks and isinstance(node, ast.Call):
                callee = last_segment(node.func)
                if callee in SEND_CALLS:
                    out.append(
                        Finding(
                            rule=self.id,
                            path=mod.path,
                            line=node.lineno,
                            col=node.col_offset,
                            message=(
                                f"'{callee}(…)' called while holding "
                                f"'{locks[-1]}' — no lock may be held across a "
                                "send (collect actions under the lock, send "
                                "outside it)"
                            ),
                            context=qual,
                        )
                    )
            self._visit(mod, qual, list(ast.iter_child_nodes(node)), held, out)
