"""Federated LoRA: train and exchange only the adapters (subset of
``p2pfl_tpu/learning/lora.py``).

Adapter leaves carry the ``lora_`` name prefix
(:class:`~p2pfl_tpu_torch.models.transformer.LoRADense`). ``LoRALearner``
rides the gossip path and waits for that slice (ROADMAP).
"""

from __future__ import annotations

import torch

from p2pfl_tpu_torch.learning.learner import ce_eval, softmax_cross_entropy


def split_lora(params: dict) -> tuple[dict, dict]:
    """Split a nested-dict param tree into (lora_subtree, base_subtree)."""

    def walk(node):
        lora, base = {}, {}
        for key, val in node.items():
            if isinstance(val, dict):
                sub_l, sub_b = walk(val)
                if sub_l:
                    lora[key] = sub_l
                if sub_b:
                    base[key] = sub_b
            elif key.startswith("lora_"):
                lora[key] = val
            else:
                base[key] = val
        return lora, base

    return walk(params)


def merge_params(base: dict, overlay: dict) -> dict:
    """Recursively overlay one nested dict onto another (no copies)."""
    out = dict(base)
    for key, val in overlay.items():
        if key in out and isinstance(out[key], dict) and isinstance(val, dict):
            out[key] = merge_params(out[key], val)
        else:
            out[key] = val
    return out


def _lm_loss(lora, base, module, x, y, node_axis: bool = False):
    """Training loss + logits. ``node_axis``: x, y and the adapters carry a
    leading node axis N and the loss is each node's mean CE, shape [N]."""
    logits = module(merge_params(base, lora), x)
    ce = softmax_cross_entropy(logits, y)
    if node_axis:
        return ce.reshape(ce.shape[0], -1).mean(1), logits
    return ce.mean(), logits


@torch.no_grad()
def lora_eval(lora, base, x, y, module):
    loss, logits = ce_eval(merge_params(base, lora), module, x, y)
    acc = (logits.argmax(-1) == y.long()).float().mean()
    return loss, acc
