"""monotone-merge: NodeState coverage/status lattices mutate only under lock.

Incident: command handlers run on whatever thread delivers the message
(gossip workers, server executors, duplicate-delivery timers). The
control-plane views on ``NodeState`` — ``models_aggregated`` (coverage),
``nei_status`` (round progress), ``async_done_peers`` (drain release) —
are lattices whose merges must be monotone (union/max) AND atomic: two
unlocked read-merge-writes for the same source clobber each other,
losing a sender's FINAL announcement. That stale-overwrite is the root
cause of an 8-node round-0 wedge (one storm of stale redeliveries
held six nodes in TrainStage indefinitely); the fix serialized every
merge under ``status_merge_lock``.

The rule flags element-level mutations of the tracked dicts/sets —
subscript stores, ``.add/.update/.setdefault/…`` calls — outside a
``with …status_merge_lock:`` body. Whole-attribute REPLACEMENT
(``self.models_aggregated = {}``) is exempt: replace-don't-mutate is the
documented safe idiom (readers capture the old object; see
``NodeState.increase_round``'s ordering contract). Local aliases are
followed one hop (``coverage = st.models_aggregated`` — the shipped
merge captures the dict first).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Sequence

from p2pfl_tpu_torch.analysis.engine import (
    Rule,
    SourceModule,
    _SCOPE_TYPES,
    last_segment,
    node_pos,
    walk_functions,
)
from p2pfl_tpu_torch.analysis.findings import Finding

TRACKED_ATTRS = frozenset({"models_aggregated", "nei_status", "async_done_peers"})
MUTATING_METHODS = frozenset(
    {"add", "update", "setdefault", "pop", "popitem", "remove", "discard", "clear"}
)
LOCK_ATTR = "status_merge_lock"


def _tracked(node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    """The tracked NodeState attribute ``node`` refers to, if any."""
    if isinstance(node, ast.Attribute) and node.attr in TRACKED_ATTRS:
        return node.attr
    if isinstance(node, ast.Name) and node.id in aliases:
        return aliases[node.id]
    return None


def _collect_aliases(fn: ast.AST) -> Dict[str, str]:
    """``coverage = st.models_aggregated`` → {"coverage": "models_aggregated"}."""
    aliases: Dict[str, str] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
            if (
                isinstance(target, ast.Name)
                and isinstance(node.value, ast.Attribute)
                and node.value.attr in TRACKED_ATTRS
            ):
                aliases[target.id] = node.value.attr
    return aliases


class MonotoneMergeRule(Rule):
    id = "monotone-merge"
    summary = "status-lattice mutations must hold status_merge_lock"

    def check_module(self, mod: SourceModule) -> Iterable[Finding]:
        out: List[Finding] = []
        for qual, fn in walk_functions(mod.tree):
            aliases = _collect_aliases(fn)
            self._visit(mod, qual, list(fn.body), False, aliases, out)
        return out

    def _visit(
        self,
        mod: SourceModule,
        qual: str,
        nodes: Sequence[ast.AST],
        locked: bool,
        aliases: Dict[str, str],
        out: List[Finding],
    ) -> None:
        for node in nodes:
            if isinstance(node, _SCOPE_TYPES) or isinstance(node, ast.Lambda):
                continue  # deferred body: must take the lock itself
            now_locked = locked
            if isinstance(node, (ast.With, ast.AsyncWith)):
                if any(last_segment(item.context_expr) == LOCK_ATTR for item in node.items):
                    now_locked = True
                self._visit(mod, qual, list(node.body), now_locked, aliases, out)
                continue
            if not locked:
                attr = self._mutation(node, aliases)
                if attr is not None:
                    line, col = node_pos(node)
                    out.append(
                        Finding(
                            rule=self.id,
                            path=mod.path,
                            line=line,
                            col=col,
                            message=(
                                f"'{attr}' mutated outside `with {LOCK_ATTR}` — "
                                "control-plane lattice merges must be atomic "
                                "monotone read-merge-writes under the lock "
                                "(or replace the whole attribute)"
                            ),
                            context=qual,
                        )
                    )
            self._visit(mod, qual, list(ast.iter_child_nodes(node)), now_locked, aliases, out)

    @staticmethod
    def _mutation(node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
        """Tracked attr this node element-mutates, or None."""
        if isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Subscript):
                    attr = _tracked(target.value, aliases)
                    if attr:
                        return attr
        elif isinstance(node, ast.AugAssign) and isinstance(node.target, ast.Subscript):
            return _tracked(node.target.value, aliases)
        elif isinstance(node, ast.Delete):
            for target in node.targets:
                if isinstance(target, ast.Subscript):
                    attr = _tracked(target.value, aliases)
                    if attr:
                        return attr
        elif isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Attribute) and func.attr in MUTATING_METHODS:
                return _tracked(func.value, aliases)
        return None
