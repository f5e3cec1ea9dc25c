"""Personalized federated learning: federate the body, keep the head local
(counterpart of ``p2pfl_tpu/learning/personalization.py``; FedPer,
Arivazhagan et al. 2019).

Each node trains the full model, but only the shared body enters
aggregation: the personal subtrees (typically the classification head)
never leave the node. :meth:`PersonalizedLearner.get_model_update` ships
the body, :meth:`~PersonalizedLearner.set_parameters` merges an incoming
body with the local personal leaves, and the decode restores a wire
payload against the body, so every transport, codec (int8/topk8, the
anchor being the body too), aggregator and the round FSM work unchanged.
Prefixes are flax path names (``"Dense_2"``, ``"layer_3/ffn"``), the
port's leaf names.
"""

from __future__ import annotations

from typing import Iterable

from p2pfl_tpu_torch.exceptions import ModelNotMatchingError
from p2pfl_tpu_torch.learning.learner import TorchLearner
from p2pfl_tpu_torch.learning.weights import ModelUpdate
from p2pfl_tpu_torch.ops.tree import tree_items, tree_unflatten

_SEP = "/"


def _is_personal(key: str, personal: tuple) -> bool:
    return any(key == p or key.startswith(p + _SEP) for p in personal)


class PersonalizedLearner(TorchLearner):
    """``TorchLearner`` whose ``personal`` path prefixes stay node-local.

    Every training member of a federation must agree on the federated
    subtree (the same prefixes), as it must on the architecture: a plain
    learner mixed in cannot take body-only updates and stops itself on the
    model-mismatch path. The round runs staged: :meth:`fused_round` is
    None, because the fused round's accumulator folds the whole tree and
    would leak the personal subtree into the aggregate."""

    def __init__(self, *args, personal: Iterable[str] = (), **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.personal = tuple(personal)
        if not self.personal:
            raise ValueError("PersonalizedLearner needs at least one personal path prefix")
        # every prefix must match something: a typo among valid prefixes
        # would otherwise federate the layer marked never-leave-the-node
        keys = [k for k, _ in tree_items(self.params)]
        for prefix in self.personal:
            if not any(k == prefix or k.startswith(prefix + _SEP) for k in keys):
                raise ValueError(f"personal prefix {prefix!r} matches no parameters")
        if all(_is_personal(k, self.personal) for k in keys):
            raise ValueError("every parameter is personal — nothing left to federate")

    # ---- outgoing: body only ----

    def _body_tree(self, params) -> dict:
        """The tree of the body leaves alone (personal paths absent)."""
        return tree_unflatten({k: v for k, v in tree_items(params) if not _is_personal(k, self.personal)})

    def get_model_update(self) -> ModelUpdate:
        update = super().get_model_update()  # the anchor is attached there
        update.params = self._body_tree(update.params)
        return update

    def fused_round(self):
        """None: the staged path, whose outgoing update strips the
        personal paths (the fused fold would take the whole tree)."""
        return None

    def set_wire_anchor(self, params, tag: str) -> None:
        # delta-code against the body (the only thing on the wire)
        super().set_wire_anchor(self._body_tree(params), tag)

    # ---- incoming: merge the body, keep the personal leaves ----

    def set_parameters(self, params) -> None:
        """Accept a full tree (the init) or a body tree (aggregates)."""
        incoming = dict(tree_items(params))
        merged = {}
        for key, leaf in tree_items(self.params):
            if _is_personal(key, self.personal):
                merged[key] = leaf  # never overwritten
                continue
            if key not in incoming:
                raise ModelNotMatchingError(f"incoming update misses body param {key}")
            arr = incoming[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ModelNotMatchingError(f"shape mismatch at {key}")
            merged[key] = arr.to(device=leaf.device, dtype=leaf.dtype)
        self.params = tree_unflatten(merged)
        if not self.keep_opt_state:
            self.opt_state = self.tx.init(self.params)
        self.bump_model_version()

    def _decode_template(self, flat: dict):
        """A full-model payload (the init of a plain initiator on a byte
        transport) restores into the whole tree, ``set_parameters`` still
        keeping the local head; any other into the body."""
        if set(flat) == {k for k, _ in tree_items(self.params)}:
            return self.params
        return self._body_tree(self.params)
