"""Rules of the PyTorch port: it imports neither JAX nor the JAX package,
its entry points default to CUDA and raise without a GPU instead of
running on the CPU, and the CUDA sources it builds are in the package."""

import ast
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import p2pfl_tpu_torch
from p2pfl_tpu_torch import DeviceUnavailableError, resolve_device
from p2pfl_tpu_torch.ops import _kernels

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "p2pfl_tpu_torch"


def _modules() -> list[str]:
    return sorted(
        m.name for m in pkgutil.walk_packages([str(PKG)], prefix="p2pfl_tpu_torch.")
    )


def test_import_purity_in_a_fresh_process():
    """A subprocess imports the package, every submodule and chip_smoke;
    neither jax nor p2pfl_tpu may end up in sys.modules (this process has
    JAX loaded by the test conftest, hence the subprocess)."""
    mods = ["p2pfl_tpu_torch", *_modules()]
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'p2pfl_tpu' or m.startswith('p2pfl_tpu.') or m == 'flax' or m == 'optax')\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=str(REPO)
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BAD []" in proc.stdout
    assert len(mods) >= 15


@pytest.mark.parametrize(
    "path", sorted(str(p.relative_to(REPO)) for p in PKG.rglob("*.py")) + ["chip_smoke.py"]
)
def test_no_jax_imports_in_source(path):
    """Statically, too: no import of jax, flax, optax or p2pfl_tpu anywhere
    in the port's sources (also inside functions)."""
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "optax", "p2pfl_tpu"), f"{path}: {name}"


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")


def test_device_none_raises_without_cuda():
    _no_cuda()
    with pytest.raises(DeviceUnavailableError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(DeviceUnavailableError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_raise_without_cuda():
    """No entry point quietly falls back to the CPU."""
    _no_cuda()
    from p2pfl_tpu_torch.convert import params_from_jax
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.models.transformer import TransformerConfig, init_params, tiny_transformer
    from p2pfl_tpu_torch.parallel.spmd_lora import SpmdLoraFederation

    cfg = TransformerConfig(vocab_size=32, dim=32, n_layers=1, n_heads=2, n_kv_heads=1, ffn_hidden=32)
    with pytest.raises(DeviceUnavailableError):
        tiny_transformer(seq_len=16, cfg=cfg)
    with pytest.raises(DeviceUnavailableError):
        init_params(cfg)
    with pytest.raises(DeviceUnavailableError):
        params_from_jax({"embed": np.zeros((2, 2), np.float32)})
    model = tiny_transformer(seq_len=16, cfg=cfg, device="cpu")
    data = FederatedDataset.synthetic_lm(vocab_size=32, seq_len=16, n_train=8, n_test=4)
    with pytest.raises(DeviceUnavailableError):
        SpmdLoraFederation.from_dataset(model, data, n_nodes=2, batch_size=2)
    fed = SpmdLoraFederation.from_dataset(model, data, n_nodes=2, batch_size=2, device="cpu")
    assert fed.x_all.device.type == "cpu"


def test_kernel_sources_and_bindings_agree():
    """The C entry points the ctypes binding declares exist in the CUDA
    source with the same number of parameters, the build targets sm_90a,
    and importing the module built nothing."""
    src = (PKG / "csrc" / "flash_attention.cu").read_text()
    for name, argc in {
        "p2p_flash_fwd": 10, "p2p_flash_bwd_dkvq": 14, "p2p_flash_bwd_dkv": 13, "p2p_flash_bwd_dq": 12,
    }.items():
        m = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)
        assert m, name
        assert len(m.group(1).split(",")) == argc, name
    assert "arch=compute_90a,code=sm_90a" in _kernels.NVCC_FLAGS
    assert _kernels._lib is None
    assert set(_kernels.LAUNCHES) == {"flash_fwd", "flash_bwd_dkvq", "flash_bwd_dq", "flash_bwd_dkv"}
    for rel in ("torch", "TORCH", "ATen"):
        assert f"#include <{rel}" not in src  # plain C interface: no PyTorch headers


def test_launch_counter_reset():
    saved = dict(_kernels.LAUNCHES)
    try:
        _kernels.LAUNCHES["flash_fwd"] = 3
        _kernels.reset_launches()
        assert set(_kernels.LAUNCHES.values()) == {0}
    finally:
        _kernels.LAUNCHES.update(saved)


def test_package_data_lists_the_cuda_sources():
    text = (REPO / "pyproject.toml").read_text()
    assert '"p2pfl_tpu_torch*"' in text
    assert re.search(r'"p2pfl_tpu_torch" = \[[^\]]*"csrc/\*\.cu"', text)
    assert p2pfl_tpu_torch.__file__.startswith(str(PKG))
