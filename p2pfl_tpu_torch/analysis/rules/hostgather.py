"""no-host-gather: the shard weights-plane modules never touch the host.

The port's ICI weights plane (``communication/ici.py`` and
``parallel/ici_plane.py``) makes the JAX package's promise: model
diffusion with no payload byte crossing from the card to the host (kernel
9 moves each slot's leaves card to card). One innocent ``leaf.cpu()`` for
a shape check, one ``.tobytes()`` for a digest, one ``.item()`` in a debug
branch, and the plane silently becomes a slower byte path while every
counter still reads "ici".

The rule is scope-targeted, not call-targeted: inside the plane's modules
(recognised by basename, so teeth fixtures can take the shape) any host
materialisation is an error:

- ``np.asarray`` / ``np.array`` / ``np.frombuffer`` (host copies);
- ``.cpu()``, ``.numpy()``, ``.tolist()``, ``.item()``, ``.tobytes()``
  with no argument (a copy to the host, a scalar sync, bytes);
- ``.to("cpu")``, ``.to(device="cpu")``, ``.to(torch.device("cpu"))``.

Device-side mechanics stay allowed: views, ``.to(<cuda device>)`` (card to
card), ``torch.empty``/``zeros`` fillers, kernel launches. Outside these
modules the rule is silent: the byte transports rightly build payloads on
the host.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional

from p2pfl_tpu_torch.analysis.engine import Rule, SourceModule, dotted_name, node_pos
from p2pfl_tpu_torch.analysis.findings import Finding

#: the weights-plane modules, recognised by basename
ICI_BASENAMES = ("ici.py", "ici_plane.py")

_HOST_CALLS = {
    "np.asarray",
    "np.array",
    "numpy.asarray",
    "numpy.array",
    "np.frombuffer",
    "numpy.frombuffer",
}
_HOST_ATTR_CALLS = {"cpu", "numpy", "tolist", "item", "tobytes"}


def _is_cpu(node: ast.AST) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return (
        isinstance(node, ast.Call)
        and dotted_name(node.func) in ("torch.device", "device")
        and bool(node.args)
        and _is_cpu(node.args[0])
    )


def _to_cpu(node: ast.Call) -> bool:
    if not (isinstance(node.func, ast.Attribute) and node.func.attr == "to"):
        return False
    targets: List[Optional[ast.AST]] = list(node.args[:1])
    targets += [kw.value for kw in node.keywords if kw.arg == "device"]
    return any(t is not None and _is_cpu(t) for t in targets)


class NoHostGatherRule(Rule):
    id = "no-host-gather"
    summary = "ICI weights-plane modules must not materialize bytes host-side"

    def check_module(self, mod: SourceModule) -> Iterable[Finding]:
        if mod.basename not in ICI_BASENAMES:
            return ()
        out: List[Finding] = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if name in _HOST_CALLS:
                out.append(self._finding(
                    mod, node,
                    f"{name}(…) inside the ICI weights plane — a host copy of (potentially) "
                    "card-resident payload data breaks the zero-host-bytes contract; keep the "
                    "value a tensor on its device or move the code out of the plane modules",
                ))
            elif isinstance(node.func, ast.Attribute) and node.func.attr in _HOST_ATTR_CALLS and not node.args:
                out.append(self._finding(
                    mod, node,
                    f".{node.func.attr}() inside the ICI weights plane — host sync/byte "
                    "materialization breaks the zero-host-bytes contract",
                ))
            elif _to_cpu(node):
                out.append(self._finding(
                    mod, node,
                    ".to('cpu') inside the ICI weights plane — a copy to the host breaks the "
                    "zero-host-bytes contract",
                ))
        return out

    def _finding(self, mod: SourceModule, node: ast.AST, msg: str) -> Finding:
        line, col = node_pos(node)
        return Finding(rule=self.id, path=mod.path, line=line, col=col, message=msg)
