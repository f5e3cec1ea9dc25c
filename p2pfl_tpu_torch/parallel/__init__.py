"""parallel of the PyTorch port (see the JAX package's module of the same path).

``ChunkedFederation``, ``SpmdFederation``, ``SpmdLoraFederation``,
``SpmdLmFederation`` and ``PipelineFederation`` (which raises: not
ported) are importable from here; each loads its module on first use.
"""

_EXPORTS = {
    "ChunkedFederation": "p2pfl_tpu_torch.parallel.chunked",
    "SpmdFederation": "p2pfl_tpu_torch.parallel.spmd",
    "SpmdLoraFederation": "p2pfl_tpu_torch.parallel.spmd_lora",
    "SpmdLmFederation": "p2pfl_tpu_torch.parallel.spmd_lm",
    "PipelineFederation": "p2pfl_tpu_torch.parallel.spmd_lm",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
