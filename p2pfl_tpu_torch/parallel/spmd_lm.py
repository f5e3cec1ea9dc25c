"""Full-parameter causal-LM federation (counterpart of
``p2pfl_tpu/parallel/spmd_lm.py``).

:class:`SpmdLmFederation` trains a whole transformer LM (dense or MoE) on
every node as one round program, the nodes stacked on one device's
leading tensor axis (``parallel/spmd.py``'s machinery): local epochs with
the batched forward and backward, the masked aggregation, the diffusion.
The local loss is the mean next-token CE plus the MoE layers' router
losses (:func:`p2pfl_tpu_torch.models.base.apply_with_aux`), so the
routers learn through the federation. The round program is
``SpmdFederation``'s with no FedProx, SCAFFOLD, FedOpt or DP-SGD, which
the constructor refuses as JAX's does; ``run_fused`` replays one captured
CUDA graph a span shape on the card, as there.

Not ported: expert parallelism (the JAX class shards the expert stacks
over a ``(nodes, model)`` mesh; ``mesh`` or ``expert_parallel > 1``
raise) and :class:`PipelineFederation` (GPipe stages need more than one
device) — both ROADMAP Queue A item 5.
"""

from __future__ import annotations

import torch

from p2pfl_tpu_torch.learning.learner import ce_eval
from p2pfl_tpu_torch.parallel.spmd import SpmdFederation, _not_ported, spmd_round, spmd_rounds_fused


#: JAX's LM round programs: ``SpmdFederation``'s with FedProx, SCAFFOLD,
#: FedOpt and DP-SGD off, ``(stacked, opt_states, x_all, y_all, perm(s),
#: mask, weights, sel_idx, *, module, tx, agg, trim, keep_opt_state,
#: remat)`` → (params', opt', loss or losses [R])
spmd_lm_round = spmd_round
spmd_lm_rounds_fused = spmd_rounds_fused


@torch.no_grad()
def spmd_lm_eval(stacked, x_test, y_test, *, module):
    """Each node's pure-CE test loss and next-token accuracy over its test
    shard ``[N, S, T]``: ([N], [N])."""

    def node_eval(p, x, y):
        loss, logits = ce_eval(p, module, x, y)
        return loss, (logits.argmax(dim=-1) == y.long()).float().mean()

    return torch.func.vmap(node_eval)(stacked, x_test, y_test)


class SpmdLmFederation(SpmdFederation):
    """N nodes federating a full-parameter transformer LM, stacked on one
    device. ``expert_parallel`` and ``mesh`` (JAX's ``(nodes, model)``
    mesh for tensor and expert parallelism) are not ported and raise;
    SCAFFOLD, FedOpt, DP-SGD and FedProx are refused, as in JAX."""

    def __init__(self, model, datasets, mesh=None, expert_parallel: int = 1, **kwargs) -> None:
        for unsupported in ("scaffold", "server_opt", "dp_clip", "dp_noise", "prox_mu"):
            if kwargs.get(unsupported):
                raise ValueError(f"SpmdLmFederation does not support {unsupported}")
        if mesh is not None or expert_parallel > 1:
            raise _not_ported("SpmdLmFederation's (nodes, model) mesh and expert parallelism", "5")
        super().__init__(model, datasets, **kwargs)

    def evaluate(self) -> dict:
        loss, acc = spmd_lm_eval(self.params, self.x_test, self.y_test, module=self.module)
        return {
            "test_loss": float(loss.mean()),
            "test_acc": float(acc.mean()),
            "per_node_acc": acc.cpu().numpy().tolist(),
        }


class PipelineFederation:
    """JAX's GPipe-pipelined federation. Not ported: its stages need more
    than one device (JAX runs it on a virtual 8-device mesh off the TPU)."""

    def __init__(self, *args, **kwargs) -> None:
        raise _not_ported("PipelineFederation (GPipe stages over several devices)", "5")
