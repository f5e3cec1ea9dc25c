"""Rules of the PyTorch port: it imports neither JAX nor the JAX package,
its entry points default to CUDA and raise without a GPU instead of
running on the CPU, and the CUDA sources it builds are in the package."""

import ast
import ctypes
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
        "import chip_smoke, fwd_ablation, bwd_ablation\n"
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
    # the vision slice's modules are among those imported
    assert {"p2pfl_tpu_torch.learning.optimizers", "p2pfl_tpu_torch.learning.checkpoint",
            "p2pfl_tpu_torch.examples.spmd_cifar", "p2pfl_tpu_torch.examples.heterogeneous",
            "p2pfl_tpu_torch.parallel.chunked"} <= set(mods)
    # and the Node's learning breadth: the wire codecs, secure aggregation,
    # FedPer and their example
    assert {"p2pfl_tpu_torch.ops.compression", "p2pfl_tpu_torch.learning.secagg",
            "p2pfl_tpu_torch.learning.personalization", "p2pfl_tpu_torch.examples.secure_mnist"} <= set(mods)
    # and the async control plane with its durability, and the megafleet engine
    assert {f"p2pfl_tpu_torch.federation.{m}" for m in (
        "staleness", "topology", "routing", "buffer", "defense", "durability", "workflow", "simfleet")} | {
        "p2pfl_tpu_torch.commands.federation"} <= set(mods)
    assert {"p2pfl_tpu_torch.federation.megafleet", "p2pfl_tpu_torch.ops.fleet_kernels",
            "p2pfl_tpu_torch.ops.fleet_autotune"} <= set(mods)


@pytest.mark.parametrize(
    "path", sorted(str(p.relative_to(REPO)) for p in PKG.rglob("*.py"))
    + ["chip_smoke.py", "fwd_ablation.py", "bwd_ablation.py"]
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
    # the gossip Node path: model, learner, slices, example
    from p2pfl_tpu_torch.examples.mnist import run
    from p2pfl_tpu_torch.learning.learner import DummyLearner
    from p2pfl_tpu_torch.models.vision import cnn, mlp
    from p2pfl_tpu_torch.parallel.mesh import submesh_federation_mesh

    from p2pfl_tpu_torch.examples import secure_mnist

    for call in (mlp, cnn, DummyLearner, lambda: submesh_federation_mesh(2), lambda: run(nodes=2, rounds=1),
                 lambda: secure_mnist.run(nodes=2, rounds=1)):
        with pytest.raises(DeviceUnavailableError):
            call()


def test_kernel_sources_and_bindings_agree():
    """The C entry points the ctypes binding declares exist in the CUDA
    sources (every ``.cu`` under ``csrc/``) with the same number of
    parameters, each is called by the bindings, the build targets sm_90a,
    and importing the module built nothing."""
    sources = {p.name: p.read_text() for p in sorted((PKG / "csrc").glob("*.cu"))}
    argcs = {
        "flash_bwd_dq_sm90.cu": {"p2p_flash_bwd_dq": 12, "p2p_flash_bwd_dq_offs": 14, "p2p_flash_bwd_dq_smem_bytes": 1},
        "flash_bwd_sm90.cu": {
            "p2p_flash_bwd_dkvq": 14, "p2p_flash_bwd_dkvq_offs": 16, "p2p_flash_bwd_smem_bytes": 1,
            "p2p_flash_bwd_dkv": 13, "p2p_flash_bwd_dkv_offs": 15, "p2p_flash_bwd_dkv_smem_bytes": 1,
        },
        "flash_fwd_sm90.cu": {"p2p_flash_fwd": 10, "p2p_flash_fwd_offs": 11, "p2p_flash_fwd_smem_bytes": 1},
        "ici_exchange.cu": {"p2p_ici_exchange": 3, "p2p_ici_max_entries": 0, "p2p_enable_peer_access": 2},
        "fleet_chunk.cu": {"p2p_fleet_chunk": 6},
    }
    assert sorted(sources) == sorted(argcs)
    bindings = (PKG / "ops" / "_kernels.py").read_text()
    for file, entry_points in argcs.items():
        src = sources[file]
        for name, argc in entry_points.items():
            m = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)
            assert m, name
            params = [p for p in m.group(1).split(",") if p.strip() not in ("", "void")]
            assert len(params) == argc, name
            # the ctypes binding declares a pointer for each pointer, an int for each int
            want = [ctypes.c_void_p if "*" in prm else ctypes.c_int for prm in params]
            assert _kernels.SIGNATURES[name] == want, name
            assert f"lib.{name}(" in bindings or f"_load().{name}(" in bindings, name
        assert len(re.findall(r'extern "C" int p2p_', src)) == len(entry_points), file
        for rel in ("torch", "TORCH", "ATen"):
            assert f"#include <{rel}" not in src  # plain C interface: no PyTorch headers
        # every flash kernel is TMA + wgmma (sm_90a): no warp-level wmma left
        assert "<mma.h>" not in src and "wmma::" not in src
    assert sum(map(len, argcs.values())) == len(_kernels.SIGNATURES)
    assert "arch=compute_90a,code=sm_90a" in _kernels.NVCC_FLAGS
    assert _kernels._lib is None
    assert set(_kernels.LAUNCHES) == {
        "flash_fwd", "flash_bwd_dkvq", "flash_bwd_dq", "flash_bwd_dkv",
        "flash_fwd_offs", "flash_bwd_dkvq_offs", "flash_bwd_dq_offs", "flash_bwd_dkv_offs",
        "ici_exchange", "fleet_chunk",
    }
    assert [s.name for s in _kernels.SOURCES] == [p.name for p in sorted((PKG / "csrc").glob("*.cu"))]
    # kernel 9 stores every payload byte itself: no copy call in its source
    assert "cudaMemcpy" not in sources["ici_exchange.cu"]
    # the fleet kernel's argument table: the source's FleetArgs fields, in
    # order, are the binding's FLEET_ARGS, every one a 64-bit word
    body = re.search(r"struct FleetArgs \{(.*?)\n\};", sources["fleet_chunk.cu"], re.S).group(1)
    decls = [d.strip() for d in re.sub(r"//[^\n]*", "", body).split(";") if d.strip()]
    fields = []
    for d in decls:
        m = re.fullmatch(r"(?:const )?(unsigned char|long long|int|float|double)\s*(\*?)\s*(.*)", d, re.S)
        fields += [(n.strip(), m.group(1) + m.group(2)) for n in m.group(3).split(",")]
    assert [n for n, _ in fields] == [n for n, _ in _kernels.FLEET_ARGS]
    for (name, ctype), (_, kind) in zip(fields, _kernels.FLEET_ARGS):
        want = {"int": "long long", "float": "double"}.get(kind, "*")
        assert ctype.endswith(want), (name, ctype, kind)


def test_forward_ablations_apply_to_the_source():
    """Every edit of ``fwd_ablation.py`` still finds its text in the
    forward's source once, so each ablation really undoes its choice."""
    import fwd_ablation

    src = fwd_ablation.SRC.read_text()
    for name, edits in fwd_ablation.ABLATIONS.items():
        for old, _ in edits:
            assert src.count(old) == 1, (name, old)
        assert (fwd_ablation.ablated_source(edits) != src) == bool(edits), name


def test_backward_ablations_apply_to_the_source():
    """The same for ``bwd_ablation.py``: its ablations of the fused and
    dK/dV template, of the dQ pass and its hazards each find their text in
    their source once."""
    import bwd_ablation
    import fwd_ablation

    groups = [(bwd_ablation.SRC, bwd_ablation.ABLATIONS), (bwd_ablation.DQ_SRC, bwd_ablation.DQ_ABLATIONS)]
    groups += [(path, {name: edits}) for name, (path, edits) in bwd_ablation.HAZARDS.items()]
    for path, ablations in groups:
        src = path.read_text()
        for name, edits in ablations.items():
            for old, _ in edits:
                assert src.count(old) == 1, (name, old)
            assert (fwd_ablation.ablated_source(edits, path) != src) == bool(edits), name
    assert set(bwd_ablation.PROBES) < set(bwd_ablation.ABLATIONS) | set(bwd_ablation.DQ_ABLATIONS)
    assert not set(bwd_ablation.ABLATIONS) & set(bwd_ablation.DQ_ABLATIONS)
    assert {"no_item_barrier", "no_tile_barrier"} <= set(bwd_ablation.HAZARDS)


#: the only modules that may import grpc or google.protobuf (the generated
#: stub is imported by proto_wire alone)
GRPC_MODULES = {
    "p2pfl_tpu_torch.communication.grpc_transport",
    "p2pfl_tpu_torch.communication.proto_wire",
    "p2pfl_tpu_torch.communication.proto.interop_pb2",
}


def test_the_package_imports_without_grpc_and_protobuf():
    """In a process where ``grpc`` and ``google.protobuf`` cannot be
    imported, the package and every module but the gRPC transport import
    (proto_wire falls back to ``HAVE_PROTOBUF = False``); statically, no
    other module imports either of them."""
    mods = [m for m in ["p2pfl_tpu_torch", *_modules()]
            if m not in GRPC_MODULES - {"p2pfl_tpu_torch.communication.proto_wire"}]
    code = (
        "import importlib, importlib.abc, sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] == 'grpc' or name.startswith('google.protobuf'):\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "from p2pfl_tpu_torch.communication import proto_wire\n"
        "assert not proto_wire.HAVE_PROTOBUF\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] == 'grpc' or m.startswith('google.protobuf'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=str(REPO)
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BAD []" in proc.stdout
    for path in sorted(PKG.rglob("*.py")):
        mod = ".".join(path.relative_to(REPO).with_suffix("").parts)
        if mod in GRPC_MODULES:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                [node.module] if isinstance(node, ast.ImportFrom) and node.module else [])
            for name in names:
                assert name.split(".")[0] != "grpc" and not name.startswith("google.protobuf"), (mod, name)


@pytest.mark.parametrize("example", ["node1", "node2"])
def test_two_process_examples_raise_without_a_card(example):
    _no_cuda()
    import importlib

    main = importlib.import_module(f"p2pfl_tpu_torch.examples.{example}").main
    with pytest.raises(DeviceUnavailableError):
        main(["0", "--n_train", "64"])


def test_package_data_lists_the_codec_source_and_the_wire_schemas():
    text = (REPO / "pyproject.toml").read_text()
    assert re.search(r'"p2pfl_tpu_torch" = \[[^\]]*"native/codec\.cpp"', text)
    assert re.search(r'"p2pfl_tpu_torch" = \[[^\]]*"communication/proto/\*\.proto"', text)
    assert (PKG / "native" / "codec.cpp").exists()
    assert sorted(p.name for p in (PKG / "communication" / "proto").glob("*.proto")) == ["interop.proto", "node.proto"]


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
    if list((PKG / "csrc").glob("*.cuh")):  # a header ships and keys the build too
        assert re.search(r'"p2pfl_tpu_torch" = \[[^\]]*"csrc/\*\.cuh"', text)
    assert p2pfl_tpu_torch.__file__.startswith(str(PKG))


def test_library_name_follows_every_source_and_header(tmp_path, monkeypatch):
    """The built library's name hashes every file the build reads, so an
    edited source or header is never served by a stale build."""
    for p in (PKG / "csrc").iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_kernels, "CSRC", tmp_path)
    before = _kernels.library_path()
    (tmp_path / "extra.cuh").write_text("// a header\n")
    with_header = _kernels.library_path()
    (tmp_path / "flash_bwd_dq_sm90.cu").write_text((tmp_path / "flash_bwd_dq_sm90.cu").read_text() + "\n")
    assert len({before, with_header, _kernels.library_path()}) == 3
