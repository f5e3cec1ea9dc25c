"""Checkpoint / resume (counterpart of ``p2pfl_tpu/learning/checkpoint.py``).

The JAX package checkpoints through orbax; the port writes ``torch.save``
files, which orbax does not read. Covers both run modes:

- :func:`save_learner` / :func:`restore_learner`: one node's params and
  optimizer state (a sharded learner's gathered, and placed again by the
  learner's layout on restore);
- :func:`save_federation` / :func:`restore_federation` (behind
  ``SpmdFederation.save`` / ``.restore``): the node-stacked federation
  state with SCAFFOLD's control variates and FedOpt's server moments,
  plus the host state a resumed round draws from (the numpy and Python
  rngs and the elected train set), so a resumed run is the run that never
  stopped, bit for bit.

Layout: one directory per step, ``<directory>/<step>/state.pt``, written
to a temporary file and moved into place with ``os.replace``, so a step
either holds a whole checkpoint or none. A state is saved as the list of
its leaves (tensors copied to the host, Python scalars) and restored into
the structure of a template, each tensor onto its template leaf's device;
``torch.load(weights_only=True)`` reads it.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from p2pfl_tpu_torch.settings import Settings

STATE_FILE = "state.pt"


def _path(directory: str) -> str:
    return os.path.abspath(os.path.expanduser(directory))


def steps(directory: str) -> list[int]:
    """The steps that hold a whole checkpoint under ``directory``, oldest first."""
    root = _path(directory)
    if not os.path.isdir(root):
        return []
    return sorted(
        int(name) for name in os.listdir(root)
        if name.isdigit() and os.path.isfile(os.path.join(root, name, STATE_FILE))
    )


def save_state(
    directory: str, state: Any, step: int = 0, keep_n: Optional[int] = None, host: Optional[dict] = None
) -> None:
    """Save a tree of tensors and Python scalars as step ``step`` (an
    existing step is overwritten), with an optional ``host`` dict of plain
    Python values. ``keep_n`` newest steps are kept, older ones deleted
    after the save; None reads ``Settings.CHECKPOINT_KEEP_N``, and 0 keeps
    every step."""
    leaves = [x.detach().cpu() if isinstance(x, torch.Tensor) else x for x in pytree.tree_leaves(state)]
    step_dir = os.path.join(_path(directory), str(int(step)))
    os.makedirs(step_dir, exist_ok=True)
    tmp = os.path.join(step_dir, f".{STATE_FILE}.{os.getpid()}.tmp")
    torch.save({"leaves": leaves, "host": host or {}}, tmp)
    os.replace(tmp, os.path.join(step_dir, STATE_FILE))
    keep_n = int(Settings.CHECKPOINT_KEEP_N) if keep_n is None else keep_n
    if keep_n > 0:
        for old in steps(directory)[:-keep_n]:
            shutil.rmtree(os.path.join(_path(directory), str(old)))


def _load(directory: str, step: Optional[int]) -> tuple[dict, int]:
    found = steps(directory)
    use = (found[-1] if found else None) if step is None else step
    if use is None or use not in found:
        raise FileNotFoundError(f"no checkpoint under {directory}" + ("" if step is None else f" at step {step}"))
    path = os.path.join(_path(directory), str(use), STATE_FILE)
    return torch.load(path, map_location="cpu", weights_only=True), use


def _into(template: Any, leaves: list) -> Any:
    """``leaves`` in ``template``'s structure, each tensor on its template
    leaf's device; a leaf of another count, shape or dtype raises."""
    flat, spec = pytree.tree_flatten(template)
    if len(flat) != len(leaves):
        raise ValueError(f"checkpoint holds {len(leaves)} leaves, the template {len(flat)}")
    out = []
    for want, got in zip(flat, leaves):
        if isinstance(want, torch.Tensor):
            if not isinstance(got, torch.Tensor) or got.shape != want.shape or got.dtype != want.dtype:
                raise ValueError(f"checkpoint leaf {getattr(got, 'shape', got)} does not match {want.shape} {want.dtype}")
            got = got.to(want.device)
        out.append(got)
    return pytree.tree_unflatten(out, spec)


def restore_state(directory: str, template: Any, step: Optional[int] = None) -> Any:
    """Restore step ``step`` (the latest when None) into the structure and
    devices of ``template``. A missing checkpoint raises ``FileNotFoundError``."""
    payload, _ = _load(directory, step)
    return _into(template, payload["leaves"])


def _learner_state(learner) -> dict:
    """A learner's params and optimizer state as whole tensors: a sharded
    learner's placed leaves are gathered, so a checkpoint does not depend
    on the slice it was taken on."""
    from p2pfl_tpu_torch.parallel.sharding import gather_tree, map_state

    return {"params": gather_tree(learner.params), "opt_state": map_state(gather_tree, learner.opt_state)}


def save_learner(
    directory: str,
    learner,
    round: Optional[int] = None,  # noqa: A002
    keep_n: Optional[int] = None,
) -> None:
    save_state(directory, _learner_state(learner), step=round or 0, keep_n=keep_n)


def restore_learner(directory: str, learner, step: Optional[int] = None) -> None:
    """Restore a learner's params and optimizer state, placed again in
    the learner's layout (the moments like the params)."""
    from p2pfl_tpu_torch.parallel.sharding import map_state, place_like, tree_is_placed

    state = restore_state(directory, _learner_state(learner), step)
    params, opt_state = state["params"], state["opt_state"]
    if tree_is_placed(learner.params):
        params = place_like(params, learner.params)
        opt_state = map_state(lambda d: place_like(d, params) if d else d, opt_state)
    learner.params = params
    learner.opt_state = opt_state


def _federation_state(fed) -> dict:
    """Everything a resumed federation's device state needs: params, opt
    state and any algorithm state (SCAFFOLD control variates, FedOpt
    server moments and step): dropping those on resume would silently
    degrade the algorithm."""
    state = {"params": fed.params, "opt_state": fed.opt_state}
    if fed.scaffold:
        state["c_global"] = fed.c_global
        state["c_local"] = fed.c_local
    if fed.server_opt:
        state["opt_m"] = fed.opt_m
        state["opt_v"] = fed.opt_v
        state["server_t"] = fed._server_t
    return state


def save_federation(directory: str, fed) -> None:
    host = {
        "rng": fed._rng.bit_generator.state,
        "py_rng": fed._py_rng.getstate(),
        "train_mask": fed.train_mask.tolist(),
    }
    save_state(directory, _federation_state(fed), step=fed.round, host=host)


def restore_federation(directory: str, fed, step: Optional[int] = None) -> None:
    payload, use = _load(directory, step)
    state = _into(_federation_state(fed), payload["leaves"])
    fed.params = state["params"]
    fed.opt_state = state["opt_state"]
    if fed.scaffold:
        fed.c_global = state["c_global"]
        fed.c_local = state["c_local"]
    if fed.server_opt:
        fed.opt_m = state["opt_m"]
        fed.opt_v = state["opt_v"]
        fed._server_t = int(state["server_t"])
    host = payload["host"]
    fed._rng.bit_generator.state = host["rng"]
    fed._py_rng.setstate(host["py_rng"])
    fed.train_mask = np.asarray(host["train_mask"], dtype=np.float32)
    fed.round = use
