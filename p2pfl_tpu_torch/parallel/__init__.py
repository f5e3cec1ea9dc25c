"""parallel of the PyTorch port (see the JAX package's module of the same path).

``ChunkedFederation``, ``SpmdFederation``, ``SpmdLoraFederation``,
``SpmdLmFederation``, ``ShardedNodeFederation`` and
``PipelineFederation``, the meshes (``federation_mesh``,
``submesh_federation_mesh``, ``node_slices``, ``pipeline_mesh``) and the
GPipe functions (``pipeline_apply``, ``pipelined_lm_apply``,
``stack_layers``) are importable from here; each loads its module on
first use. The sharded megafleet's ``fleet_clients_mesh`` and
``shard_capacity`` are not ported yet (ROADMAP Queue A item 5).
"""

_EXPORTS = {
    "ChunkedFederation": "p2pfl_tpu_torch.parallel.chunked",
    "SpmdFederation": "p2pfl_tpu_torch.parallel.spmd",
    "SpmdLoraFederation": "p2pfl_tpu_torch.parallel.spmd_lora",
    "SpmdLmFederation": "p2pfl_tpu_torch.parallel.spmd_lm",
    "PipelineFederation": "p2pfl_tpu_torch.parallel.spmd_lm",
    "ShardedNodeFederation": "p2pfl_tpu_torch.parallel.submesh",
    "federation_mesh": "p2pfl_tpu_torch.parallel.mesh",
    "submesh_federation_mesh": "p2pfl_tpu_torch.parallel.mesh",
    "node_slices": "p2pfl_tpu_torch.parallel.mesh",
    "pipeline_mesh": "p2pfl_tpu_torch.parallel.mesh",
    "pipeline_apply": "p2pfl_tpu_torch.parallel.pipeline",
    "pipelined_lm_apply": "p2pfl_tpu_torch.parallel.pipeline",
    "stack_layers": "p2pfl_tpu_torch.parallel.pipeline",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
