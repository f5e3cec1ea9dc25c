"""The port's vision models (ResNet-18/50 and the ViT) against flax on the
CPU: the trees' paths, shapes and dtypes; logits of the same params on the
same numpy-seeded batch, fp32 and bf16; and one check for each of the
three places where flax's conventions differ from PyTorch's defaults
(SAME padding at stride 2, norm epsilon, tanh GELU), each shown to fail
with PyTorch's default.

The flax side runs the port's init converted by ``params_to_jax`` (a flax
init of ResNet-50 alone takes seconds eagerly); flax's own init is only
shape-evaluated, for the tree comparison.
"""

from __future__ import annotations

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from p2pfl_tpu.models import vision as jv
from p2pfl_tpu_torch import DeviceUnavailableError
from p2pfl_tpu_torch.convert import params_from_jax, params_to_jax
from p2pfl_tpu_torch.models import ResNet, ViT, resnet18, resnet50, vit
from p2pfl_tpu_torch.models import vision as tv
from p2pfl_tpu_torch.ops.tree import tree_items

torch.set_num_threads(2)

CPU = torch.device("cpu")
SHAPE = (32, 32, 3)


def _batch(n: int, seed: int = 0, shape=SHAPE) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, *shape)).astype(np.float32)


def _flax_logits(module, tparams: dict, x: np.ndarray) -> np.ndarray:
    return np.asarray(jax.jit(module.apply)({"params": params_to_jax(tparams)}, x), np.float32)


def _leaves(tree) -> list:
    """(path, shape, dtype name) of every leaf, of flax's tree of shapes or
    the port's tree of tensors."""
    return [(path, tuple(leaf.shape), str(leaf.dtype).replace("torch.", "")) for path, leaf in tree_items(tree)]


# ---- trees ----


@pytest.mark.parametrize("name", ["resnet18", "resnet50", "vit"])
def test_trees_equal_flax(name):
    """Paths, shapes and dtypes of every leaf equal flax's init of the
    same architecture (ResNet blocks, GroupNorms and projections, the
    ViT's blocks, LayerNorms and top-level ``pos_embed``)."""
    build, jmod = {
        "resnet18": (resnet18, jv.ResNet(stage_sizes=(2, 2, 2, 2))),
        "resnet50": (resnet50, jv.ResNet(stage_sizes=(3, 4, 6, 3), bottleneck=True, num_classes=100)),
        "vit": (vit, jv.ViT()),
    }[name]
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, *SHAPE))))["params"]
    want = _leaves(shapes)
    model = build(device="cpu")
    assert _leaves(model.params) == want
    assert model.param_count == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert model.input_shape == SHAPE


def test_init_statistics():
    """flax's initializers: conv kernels lecun-normal over fan-in
    ``k·k·c_in`` (std √(1/fan_in)), norms ones and zeros, ``pos_embed``
    normal(0.02); a seed gives the same tree, another seed another."""
    p = resnet18(seed=1, device="cpu").params
    k = p["ResBlock_2"]["Conv_0"]["kernel"]  # 3x3x64x128
    assert abs(float(k.std()) - (1 / (9 * 64)) ** 0.5) < 0.05 * (1 / (9 * 64)) ** 0.5
    assert torch.equal(p["GroupNorm_0"]["scale"], torch.ones(64)) and not p["GroupNorm_0"]["bias"].any()
    assert torch.equal(p["Dense_0"]["kernel"], resnet18(seed=1, device="cpu").params["Dense_0"]["kernel"])
    assert not torch.equal(k, resnet18(seed=2, device="cpu").params["ResBlock_2"]["Conv_0"]["kernel"])
    pos = vit(device="cpu").params["pos_embed"]
    assert pos.shape == (1, 64, 64) and abs(float(pos.std()) - 0.02) < 0.002


def test_constructors_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    for build in (resnet18, resnet50, vit):
        with pytest.raises(DeviceUnavailableError):
            build()


# ---- logits ----


@pytest.mark.parametrize("name,jmod,tmod,n", [
    ("resnet18", jv.ResNet(stage_sizes=(2, 2, 2, 2), dtype=jnp.float32), ResNet((2, 2, 2, 2), dtype=torch.float32), 2),
    ("resnet50", jv.ResNet(stage_sizes=(3, 4, 6, 3), bottleneck=True, num_classes=100, dtype=jnp.float32),
     ResNet((3, 4, 6, 3), bottleneck=True, num_classes=100, dtype=torch.float32), 2),
    ("vit", jv.ViT(dtype=jnp.float32), ViT(dtype=torch.float32), 4),
])
def test_fp32_logits_match_flax(name, jmod, tmod, n):
    """The same params and batch in fp32: every logit within
    1e-4·max|ref| + 1e-5 (read: at most 1.1e-6 of the largest)."""
    init = tv.init_vit_params if name == "vit" else tv.init_resnet_params
    params = init(tmod, SHAPE, 3, CPU)
    x = _batch(n, seed=1)
    want = _flax_logits(jmod, params, x)
    got = tmod(params, torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max() + 1e-5


#: bf16 logits' relative L2 against flax's (read: ResNet-18 4.4e-3,
#: ResNet-50 at batch 2 below that, the ViT 5.7e-3): every conv, GroupNorm
#: and GEMM output is rounded to bf16 on both sides, in another order
BF16_REL_L2 = 2e-2


@pytest.mark.parametrize("name,jmod,tmod,n", [
    ("resnet18", jv.ResNet(stage_sizes=(2, 2, 2, 2)), ResNet((2, 2, 2, 2), dtype=torch.bfloat16), 2),
    ("resnet50", jv.ResNet(stage_sizes=(3, 4, 6, 3), bottleneck=True, num_classes=100),
     ResNet((3, 4, 6, 3), bottleneck=True, num_classes=100, dtype=torch.bfloat16), 2),
    ("vit", jv.ViT(), ViT(dtype=torch.bfloat16), 4),
])
def test_bf16_logits_match_flax(name, jmod, tmod, n):
    init = tv.init_vit_params if name == "vit" else tv.init_resnet_params
    params = init(tmod, SHAPE, 4, CPU)
    x = _batch(n, seed=2)
    want = _flax_logits(jmod, params, x)
    got = tmod(params, torch.from_numpy(x))
    assert got.dtype == torch.float32
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert rel <= BF16_REL_L2, rel


def test_loaded_flax_init_runs_unchanged():
    """A flax init (the reduced ResNet) loads through ``params_from_jax``
    leaf for leaf and gives flax's logits."""
    jmod = jv.ResNet(stage_sizes=(1, 1), dtype=jnp.float32)
    shape = (16, 16, 3)
    jparams = jax.jit(jmod.init)(jax.random.PRNGKey(5), jnp.zeros((1, *shape)))["params"]
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    x = _batch(2, seed=3, shape=shape)
    want = np.asarray(jax.jit(jmod.apply)({"params": jparams}, x))
    got = ResNet((1, 1), dtype=torch.float32)(params, torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max() + 1e-5


# ---- the three traps ----


def test_stride2_same_padding_is_flax_s():
    """flax's SAME at stride 2 on an even input pads 0 rows before and 1
    after: the port's ``_conv`` equals flax's conv (fp32, 1e-5), and the
    symmetric padding of ``F.conv2d(padding=1)`` is far off."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    conv = nn.Conv(6, (3, 3), strides=(2, 2), padding="SAME", use_bias=False)
    kernel = rng.standard_normal((3, 3, 4, 6)).astype(np.float32)
    want = np.asarray(conv.apply({"params": {"kernel": kernel}}, x)).transpose(0, 3, 1, 2)
    xt, kt = torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(kernel)
    got = tv._conv(xt, kt, 2, torch.float32).numpy()
    assert got.shape == want.shape == (2, 6, 4, 4)
    assert np.abs(got - want).max() <= 1e-5
    symmetric = F.conv2d(xt, kt.permute(3, 2, 0, 1), stride=2, padding=1).numpy()
    assert np.abs(symmetric - want).max() > 1.0
    assert tv._same_pads(8, 3, 2) == (0, 1) and tv._same_pads(8, 3, 1) == (1, 1)
    assert tv._same_pads(8, 1, 2) == (0, 0) and tv._same_pads(32, 4, 4) == (0, 0)


def _low_variance(shape, seed: int) -> np.ndarray:
    """Centred activations whose per-group variance (about 4e-6) is near
    the epsilons, where 1e-6 and 1e-5 give different normalisations. (With
    a mean far above the spread flax's fast-variance form E[x²] − E[x]²
    loses digits to cancellation; the port's statistics do not.)"""
    rng = np.random.default_rng(seed)
    return (2e-3 * rng.standard_normal(shape)).astype(np.float32)


def test_norm_epsilon_is_flax_s():
    """GroupNorm and LayerNorm use flax's eps 1e-6 with fp32 statistics:
    within 1e-4 of flax's on low-variance activations (bf16 GroupNorm
    output within one bf16 rounding), where PyTorch's default 1e-5 is
    off by over 10 %."""
    x = _low_variance((2, 4, 4, 16), 1)
    scale = np.linspace(0.5, 1.5, 16).astype(np.float32)
    bias = np.linspace(-0.2, 0.2, 16).astype(np.float32)
    p = {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)

    gn = nn.GroupNorm(num_groups=8)
    want = np.asarray(gn.apply({"params": {"scale": scale, "bias": bias}}, x)).transpose(0, 3, 1, 2)
    assert np.abs(tv._group_norm(xt, p).numpy() - want).max() <= 1e-4
    wrong = F.group_norm(xt, 8, p["scale"], p["bias"], 1e-5).numpy()
    assert np.abs(wrong - want).max() > 0.1
    gn16 = nn.GroupNorm(num_groups=8, dtype=jnp.bfloat16)
    want16 = np.asarray(gn16.apply({"params": {"scale": scale, "bias": bias}}, jnp.asarray(x, jnp.bfloat16)), np.float32)
    got16 = tv._group_norm(xt.bfloat16(), p)
    assert got16.dtype == torch.bfloat16
    assert np.abs(got16.float().numpy() - want16.transpose(0, 3, 1, 2)).max() <= 2.0**-7 * np.abs(want16).max()

    ln = nn.LayerNorm(dtype=jnp.float32)
    want = np.asarray(ln.apply({"params": {"scale": scale, "bias": bias}}, x))
    got = tv._layer_norm(torch.from_numpy(x), p).numpy()
    assert np.abs(got - want).max() <= 1e-4
    wrong = F.layer_norm(torch.from_numpy(x), (16,), p["scale"], p["bias"]).numpy()
    assert np.abs(wrong - want).max() > 0.1


def test_vit_block_gelu_is_tanh():
    """flax's ``nn.gelu`` is the tanh approximation: the port's ViT block
    equals flax's ``ViTBlock`` in fp32 (1e-5 of the largest), and on the
    block's own fc1 outputs exact GELU departs from it by more than that."""
    d = 32
    jblock = jv.ViTBlock(heads=4, dtype=jnp.float32)
    x = np.random.default_rng(2).standard_normal((2, 9, d)).astype(np.float32) * 2
    jparams = jax.jit(jblock.init)(jax.random.PRNGKey(1), x)["params"]
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    want = np.asarray(jblock.apply({"params": jparams}, x))
    got = tv.ViTBlock(4, dtype=torch.float32)(params, torch.from_numpy(x)).numpy()
    tol = 1e-5 * np.abs(want).max()
    assert np.abs(got - want).max() <= tol
    h = torch.linspace(-3, 3, 601)
    assert np.abs(np.asarray(nn.gelu(h.numpy())) - F.gelu(h, approximate="tanh").numpy()).max() <= 1e-6
    assert (F.gelu(h) - F.gelu(h, approximate="tanh")).abs().max() > 1e-4


def test_package_import_turns_tf32_off():
    """The port's fp32 means IEEE fp32 on the card: importing the package
    turns both of torch's TF32 flags off, whatever they were, once.
    Nothing after the import sets them again, so a caller's own choice
    made after it stands (a fresh process: the flags are process-wide)."""
    import pathlib
    import subprocess
    import sys

    code = (
        "import torch\n"
        "torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True\n"
        "import p2pfl_tpu_torch\n"
        "print(torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)\n"
        "torch.backends.cudnn.allow_tf32 = True\n"
        "p2pfl_tpu_torch.resolve_device('cpu')\n"
        "print(torch.backends.cudnn.allow_tf32)\n"
    )
    repo = pathlib.Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == ["False", "False", "True"]
