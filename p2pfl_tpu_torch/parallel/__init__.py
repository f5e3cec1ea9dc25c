"""parallel of the PyTorch port (see the JAX package's module of the same path).

``ChunkedFederation``, ``SpmdFederation`` and ``SpmdLoraFederation`` are
importable from here; each loads its module on first use.
"""

_EXPORTS = {
    "ChunkedFederation": "p2pfl_tpu_torch.parallel.chunked",
    "SpmdFederation": "p2pfl_tpu_torch.parallel.spmd",
    "SpmdLoraFederation": "p2pfl_tpu_torch.parallel.spmd_lora",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
