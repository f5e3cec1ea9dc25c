"""wire-header-compat: optional envelope keys follow the tc/vv/xp pattern.

Contract (one registry:
:data:`p2pfl_tpu_torch.communication.wire_headers.OPTIONAL_WIRE_HEADERS`): an
optional wire-header key must (a) decode unchanged when absent —
``d.get(key)``, never ``d[key]`` — in every native codec plane that
carries it, (b) be serialized only under a guard so ``None`` never hits
the wire (old receivers keep parsing new senders), (c) be copied by the
in-memory transport's byte-path re-wrap (or simulations diverge from the
network transports — the exact drift the MEMORY_WIRE_CODEC seam exists
to prevent), and (d) never appear in the protobuf interop codec, whose
schema must stay byte-compatible with real reference nodes.

This is a cross-file rule: it recognizes the three codec files by
basename (``grpc_transport.py``, ``memory.py``, ``proto_wire.py``),
records their ASTs during the per-module pass grouped by DIRECTORY
(each directory holding codec files is its own codec set — teeth
fixtures scanned alongside the real tree can never shadow the real
codec), and cross-checks every registered key in ``finalize``. A key declared in the registry but
missing any leg of the pattern — or a key string leaking into the
protobuf schema — is a finding; so is drift in the other direction
(a declared key the envelope codec never encodes at all).
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, List, Optional, Sequence

from p2pfl_tpu_torch.analysis.engine import FuncDef, Rule, SourceModule, last_segment
from p2pfl_tpu_torch.analysis.findings import Finding

_ENCODERS = {"message": "encode_message", "weights": "encode_weights"}
_DECODERS = {"message": "decode_message", "weights": "decode_weights"}


def _functions(tree: ast.Module) -> Dict[str, FuncDef]:
    out: Dict[str, FuncDef] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = node
    return out


def _with_local_callees(fn: ast.AST, fns: Dict[str, FuncDef]) -> List[ast.AST]:
    """The function plus module-local helpers it calls (one hop) — the
    ``_trace_ctx(d)`` indirection in the shipped decoder."""
    bodies = [fn]
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            helper = fns.get(node.func.id)
            if helper is not None and helper is not fn:
                bodies.append(helper)
    return bodies


def _get_calls(nodes: Sequence[ast.AST], key: str) -> bool:
    for fn in nodes:
        for node in ast.walk(fn):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "get"
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and node.args[0].value == key
            ):
                return True
    return False


def _subscript_loads(nodes: Sequence[ast.AST], key: str) -> Optional[ast.AST]:
    for fn in nodes:
        for node in ast.walk(fn):
            if (
                isinstance(node, ast.Subscript)
                and isinstance(node.ctx, ast.Load)
                and isinstance(node.slice, ast.Constant)
                and node.slice.value == key
            ):
                return node
    return None


def _key_stores(fn: ast.AST, key: str) -> List[ast.Subscript]:
    out = []
    for node in ast.walk(fn):
        if (
            isinstance(node, ast.Subscript)
            and isinstance(node.ctx, ast.Store)
            and isinstance(node.slice, ast.Constant)
            and node.slice.value == key
        ):
            out.append(node)
    return out


def _guarded(fn: ast.AST, target: ast.AST) -> bool:
    """Is ``target`` lexically inside an ``if`` within ``fn``?"""

    def rec(node: ast.AST, in_if: bool) -> Optional[bool]:
        if node is target:
            return in_if
        for child in ast.iter_child_nodes(node):
            nested = in_if or isinstance(node, ast.If) or isinstance(node, ast.IfExp)
            found = rec(child, nested)
            if found is not None:
                return found
        return None

    return bool(rec(fn, False))


class WireHeaderCompatRule(Rule):
    id = "wire-header-compat"
    summary = "optional wire keys: guarded encode, get() decode, memory copy, no protobuf leak"

    #: the codec files the contract lives in, recognized by basename so
    #: teeth fixtures can replicate the shape in a temp directory
    CODEC_BASENAMES = ("grpc_transport.py", "memory.py", "proto_wire.py")

    def __init__(self, headers: Optional[Sequence] = None) -> None:
        self._headers = headers
        # directory → {basename: module}: each directory holding codec
        # files is cross-checked as its own codec set, so teeth fixtures
        # in a scanned tree can never shadow the real codec (and vice
        # versa) — a basename collision across directories is two sets
        self._dirs: Dict[str, Dict[str, SourceModule]] = {}

    def check_module(self, mod: SourceModule) -> Iterable[Finding]:
        if mod.basename in self.CODEC_BASENAMES:
            directory = os.path.dirname(mod.path)
            self._dirs.setdefault(directory, {})[mod.basename] = mod
        return ()

    def finalize(self) -> Iterable[Finding]:
        headers = self._headers
        if headers is None:
            from p2pfl_tpu_torch.communication.wire_headers import OPTIONAL_WIRE_HEADERS

            headers = OPTIONAL_WIRE_HEADERS
        out: List[Finding] = []
        for _directory, mods in sorted(self._dirs.items()):
            envelope = mods.get("grpc_transport.py")
            memory = mods.get("memory.py")
            proto = mods.get("proto_wire.py")
            for h in headers:
                if envelope is not None:
                    out += self._check_envelope(envelope, h)
                if memory is not None:
                    out += self._check_memory(memory, h)
                if proto is not None:
                    out += self._check_proto(proto, h)
        return out

    # ---- per-file checks ----

    def _finding(self, mod: SourceModule, node: Optional[ast.AST], msg: str, ctx: str) -> Finding:
        return Finding(
            rule=self.id,
            path=mod.path,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0),
            message=msg,
            context=ctx,
        )

    def _check_envelope(self, mod: SourceModule, h) -> List[Finding]:
        fns = _functions(mod.tree)
        out: List[Finding] = []
        for plane in h.planes:
            enc = fns.get(_ENCODERS[plane])
            if enc is not None:
                stores = _key_stores(enc, h.key)
                if not stores:
                    out.append(
                        self._finding(
                            mod,
                            enc,
                            f"optional wire key '{h.key}' is registered for the "
                            f"{plane} plane but never written by "
                            f"{_ENCODERS[plane]} — registry/codec drift",
                            _ENCODERS[plane],
                        )
                    )
                for store in stores:
                    if not _guarded(enc, store):
                        out.append(
                            self._finding(
                                mod,
                                store,
                                f"optional wire key '{h.key}' is serialized "
                                "unconditionally — absent-frame compatibility "
                                "requires the is-not-None guard",
                                _ENCODERS[plane],
                            )
                        )
            dec = fns.get(_DECODERS[plane])
            if dec is not None:
                bodies = _with_local_callees(dec, fns)
                sub = _subscript_loads(bodies, h.key)
                if sub is not None:
                    out.append(
                        self._finding(
                            mod,
                            sub,
                            f"optional wire key '{h.key}' read with [] in the "
                            f"{plane} decoder — KeyError on absent frames; use "
                            ".get()",
                            _DECODERS[plane],
                        )
                    )
                elif not _get_calls(bodies, h.key):
                    out.append(
                        self._finding(
                            mod,
                            dec,
                            f"optional wire key '{h.key}' has no absent-frame "
                            f"decode path in {_DECODERS[plane]} (no "
                            f".get('{h.key}'))",
                            _DECODERS[plane],
                        )
                    )
        return out

    def _check_memory(self, mod: SourceModule, h) -> List[Finding]:
        out: List[Finding] = []
        for ctor, kwarg in h.memory_copies:
            calls = [
                node
                for node in ast.walk(mod.tree)
                if isinstance(node, ast.Call) and last_segment(node.func) == ctor
            ]
            if not calls:
                continue  # no byte-path re-wrap in this transport: pass-by-
                # reference carries every attribute automatically
            # EVERY re-wrap site must copy the kwarg — the unary path and the
            # streaming pump each rebuild the update, and a key dropped from
            # either one diverges simulations only on that path's sends
            for call in calls:
                if not any(kw.arg == kwarg for kw in call.keywords):
                    out.append(
                        self._finding(
                            mod,
                            call,
                            f"memory byte path rebuilds {ctor} without copying "
                            f"'{kwarg}' — the optional '{h.key}' header would "
                            "be dropped in simulation but kept on the network "
                            "transports",
                            ctor,
                        )
                    )
        return out

    def _check_proto(self, mod: SourceModule, h) -> List[Finding]:
        """Flag the key as a string constant, a schema keyword argument
        (``pb.Weights(vv=…)``), or a field access (``w.vv``)."""
        for node in ast.walk(mod.tree):
            leaked = (
                (isinstance(node, ast.Constant) and node.value == h.key)
                or (isinstance(node, ast.Attribute) and node.attr == h.key)
                or (
                    isinstance(node, ast.Call)
                    and any(kw.arg == h.key for kw in node.keywords)
                )
            )
            if leaked:
                return [
                    self._finding(
                        mod,
                        node,
                        f"optional wire key '{h.key}' appears in the protobuf "
                        "interop codec — the reference schema must never "
                        "carry optional envelope keys",
                        "protobuf-interop",
                    )
                ]
        return []
