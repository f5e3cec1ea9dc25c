"""The port's full-model SpmdFederation (``bench.py``'s path) against the
JAX package on the CPU: data, shards, shuffles and election bitwise; one
local step, one round and a fused span of the MLP federation at full
width from the same converted init; FedProx, SCAFFOLD, FedOpt, DP-SGD and
remat; the refusals; and (``slow``) the 64-node bench curve.

Tolerances, stated where used, follow from how the two sides round. In
fp32 with SGD the params agree to a few fp32 ulps. Adam divides each
moment by its own square root, so an element whose gradient sits at
rounding noise moves by about ±lr a step whichever side of zero rounding
put it: under Adam every element is held within 2·lr per step taken and
the mean difference far below one step. bf16 rounds every product, so
its bounds are the looser ones.
"""

import gzip
import struct

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from p2pfl_tpu.learning import privacy as jprivacy
from p2pfl_tpu.learning.dataset import FederatedDataset as JaxDataset
from p2pfl_tpu.learning.dataset import _parse_idx as jax_parse_idx
from p2pfl_tpu.models.base import FlaxModel
from p2pfl_tpu.models.vision import MLP as JaxMLP
from p2pfl_tpu.parallel import SpmdFederation as JaxFederation
from p2pfl_tpu.parallel import spmd as jspmd
from p2pfl_tpu.settings import Settings as JaxSettings
from p2pfl_tpu_torch import DeviceUnavailableError
from p2pfl_tpu_torch.convert import params_from_jax, params_to_jax
from p2pfl_tpu_torch.examples import bench_mnist
from p2pfl_tpu_torch.learning import privacy as tprivacy
from p2pfl_tpu_torch.learning.dataset import FederatedDataset, _parse_idx
from p2pfl_tpu_torch.learning.learner import adam, sgd
from p2pfl_tpu_torch.management import profiling
from p2pfl_tpu_torch.models.base import TorchModel
from p2pfl_tpu_torch.models.vision import MLP, mlp
from p2pfl_tpu_torch.ops.tree import tree_items, tree_leaves, tree_map
from p2pfl_tpu_torch.parallel import spmd as tspmd
from p2pfl_tpu_torch.parallel.spmd import SpmdFederation
from p2pfl_tpu_torch.settings import Settings

torch.set_num_threads(2)

HARD = bench_mnist.HARD_TASK
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
LR = 1e-2
N_NODES, BATCH = 4, 32
DATA = dict(n_train=N_NODES * 96, n_test=N_NODES * 48, **HARD)  # 3 steps a round


def _jax_mlp(dtype) -> FlaxModel:
    return FlaxModel.create(JaxMLP(dtype=dtype), (28, 28, 1), seed=0)


def _port_model(jmodel: FlaxModel, dtype) -> TorchModel:
    params = params_from_jax(jax.tree.map(np.asarray, jmodel.params), device="cpu")
    return TorchModel(MLP(dtype=dtype), params, (28, 28, 1))


def _pair(dtype: str = "f32", n_nodes: int = N_NODES, data: dict = DATA, **kw):
    """A JAX and a port federation from one init, data and seed."""
    base = dict(n_nodes=n_nodes, batch_size=BATCH, vote=False, seed=3, learning_rate=LR)
    base.update(kw)
    jdt, tdt = DTYPES[dtype]
    jmodel = _jax_mlp(jdt)
    jfed = JaxFederation.from_dataset(jmodel, JaxDataset.synthetic_mnist(**data), **base)
    tfed = SpmdFederation.from_dataset(
        _port_model(jmodel, tdt), FederatedDataset.synthetic_mnist(**data), device="cpu", **base
    )
    return jfed, tfed


def _gap(jtree, ttree) -> tuple[float, float]:
    """(max, mean) absolute difference over every element of two trees
    (the JAX one as arrays, the port's as tensors)."""
    want = jax.tree.leaves(jax.tree.map(lambda a: np.asarray(a, np.float32), jtree))
    got = [np.asarray(x, np.float32) for x in jax.tree.leaves(params_to_jax(ttree))]
    assert len(want) == len(got)
    diffs = [np.abs(a - b) for a, b in zip(want, got)]
    return float(max(d.max() for d in diffs)), float(np.mean([d.mean() for d in diffs]))


# ---- data, shards, shuffles and election: bitwise ----


def _idx_bytes(array: np.ndarray, code: int) -> bytes:
    head = struct.pack(">HBB", 0, code, array.ndim) + struct.pack(f">{array.ndim}I", *array.shape)
    return head + array.astype(array.dtype.newbyteorder(">")).tobytes()


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
def test_mnist_idx_reader_bitwise(tmp_path, gz):
    """IDX files the test writes (uint8 images, labels; plain and gzipped)
    load to the same arrays in both packages; ``mnist`` reads them from a
    directory and falls back to the synthetic task without one."""
    rng = np.random.default_rng(0)
    files = {
        "train-images-idx3-ubyte": (rng.integers(0, 256, (12, 28, 28)).astype(np.uint8), 8),
        "train-labels-idx1-ubyte": (rng.integers(0, 10, 12).astype(np.uint8), 8),
        "t10k-images-idx3-ubyte": (rng.integers(0, 256, (5, 28, 28)).astype(np.uint8), 8),
        "t10k-labels-idx1-ubyte": (rng.integers(0, 10, 5).astype(np.uint8), 8),
    }
    for name, (array, code) in files.items():
        data = _idx_bytes(array, code)
        assert np.array_equal(_parse_idx(data), jax_parse_idx(data))
        path = tmp_path / (name + (".gz" if gz else ""))
        path.write_bytes(gzip.compress(data) if gz else data)
    want, got = JaxDataset.mnist(str(tmp_path)), FederatedDataset.mnist(str(tmp_path))
    assert got.source == want.source == "idx"
    for key in ("x_train", "y_train", "x_test", "y_test"):
        a, b = getattr(want, key), getattr(got, key)
        assert a.dtype == b.dtype and np.array_equal(a, b), key
    assert got.x_train.shape == (12, 28, 28, 1)
    # other dtypes of the format, and a file that is not IDX
    for array, code in ((np.arange(6, dtype=np.int32).reshape(2, 3), 12), (np.ones(3, np.float64), 14)):
        assert np.array_equal(_parse_idx(_idx_bytes(array, code)), array)
    with pytest.raises(ValueError, match="not an IDX"):
        _parse_idx(b"\x01\x00\x08\x01" + bytes(8))
    fallback = FederatedDataset.mnist(str(tmp_path / "missing"), n_train=20, n_test=5, **HARD)
    assert fallback.source == "synthetic" and fallback.x_train.shape == (20, 28, 28, 1)


def test_bench_synthetic_hard_arrays_bitwise():
    """The bench's data (``mnist()`` without IDX files, the hard task at
    its full 60k / 10k size) is the same array in both packages."""
    want, got = JaxDataset.mnist(None, **HARD), FederatedDataset.mnist(None, **HARD)
    for key in ("x_train", "y_train", "x_test", "y_test"):
        a, b = getattr(want, key), getattr(got, key)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), key


def test_staged_shards_and_fused_span_inputs_bitwise():
    """Shards staged from unequal partitions (dirichlet), then a fused
    span's shuffles, election and selected rows, and the shuffles of the
    rounds after it: the same arrays in both packages."""
    data = dict(n_train=640, n_test=96, seed=4, **HARD)
    jd, td = JaxDataset.synthetic_mnist(**data), FederatedDataset.synthetic_mnist(**data)
    jsh = [jd.partition(i, 5, "dirichlet", alpha=2.0) for i in range(5)]
    tsh = [td.partition(i, 5, "dirichlet", alpha=2.0) for i in range(5)]
    want, got = jspmd.stage_node_shards(jsh, 16), tspmd.stage_node_shards(tsh, 16)
    assert want["sizes"] == got["sizes"] and want["nb"] == got["nb"] and len(set(got["sizes"])) > 1
    for key in ("x", "y", "x_test", "y_test"):
        assert all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(want[key], got[key])), key

    JaxSettings.TRAIN_SET_SIZE = Settings.TRAIN_SET_SIZE = 3
    try:
        jfed, tfed = _pair(n_nodes=5, data=dict(data, n_train=5 * 64), vote=True)
        jp, jm, js = jfed._fused_inputs(3, 2)
        tp, tm, ts = tfed._fused_inputs(3, 2)
    finally:
        JaxSettings.TRAIN_SET_SIZE = Settings.TRAIN_SET_SIZE = 4
    assert np.array_equal(np.asarray(jp), tp.numpy()) and tp.shape[:3] == (3, 5, 2)
    assert np.array_equal(jfed.train_mask, tfed.train_mask) and tfed.train_mask.sum() == 3
    assert np.array_equal(np.asarray(jm), tm.numpy()) and np.array_equal(np.asarray(js), ts.numpy())
    assert np.array_equal(jfed._make_perm_np(1), tfed._make_perm_np(1))


@pytest.mark.parametrize("noise,q", [(1.1, 64 / 937), (0.6, 0.01), (2.0, 1.0)])
def test_accountant_epsilon_bitwise(noise, q):
    ja, ta = jprivacy.PrivacyAccountant(noise, q), tprivacy.PrivacyAccountant(noise, q)
    for steps in (0, 1, 14, 420):
        ja.step(steps)
        ta.step(steps)
        for delta in (1e-5, 1e-3):
            assert ta.epsilon(delta) == ja.epsilon(delta)
    with pytest.raises(ValueError):
        tprivacy.PrivacyAccountant(0.0, q)


# ---- one step, one round ----


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_local_epoch_one_step_matches_jax(dtype):
    """One Adam step of every node (JAX: its per-node ``_local_epoch``
    vmapped; the port: the node-stacked one) on the same batches from the
    same node-stacked init (each node's params perturbed so nodes differ).
    First-step Adam moves an element by ±lr whatever the gradient's size,
    so a gradient near 0 may flip: params within 2·lr, mean far below;
    fp32 moments to 1e-6 of the largest, bf16 to 2^-5 of it (read 0.016)."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    jmodel = _jax_mlp(jdt)
    stacked = jax.tree.map(
        lambda a: np.stack([np.asarray(a) * (1 + 0.05 * i) for i in range(N_NODES)]), jmodel.params
    )
    xs = rng.random((N_NODES, 1, BATCH, 28, 28, 1), dtype=np.float32)
    ys = rng.integers(0, 10, (N_NODES, 1, BATCH)).astype(np.int32)
    jtx = optax.adam(LR)
    jp, jo, jloss = jax.vmap(
        lambda p, o, x, y: jspmd._local_epoch(p, o, x, y, jmodel.module, jtx)
    )(jax.tree.map(jnp.asarray, stacked), jax.vmap(jtx.init)(jax.tree.map(jnp.asarray, stacked)), xs, ys)

    tp0 = tree_map(torch.tensor, stacked)
    ttx = adam(LR)
    tp, to, tloss = tspmd._local_epoch(
        tp0, ttx.init(tp0), torch.tensor(xs), torch.tensor(ys), MLP(dtype=tdt), ttx
    )
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=1e-6 if dtype == "f32" else 2e-3)
    worst, mean = _gap(jp, tp)
    assert worst <= 2 * LR and mean <= (1e-6 if dtype == "f32" else 0.05 * LR), (worst, mean)
    for jm_, tm_ in ((jo[0].mu, to.mu), (jo[0].nu, to.nu)):
        scale = max(float(np.abs(np.asarray(a)).max()) for a in jax.tree.leaves(jm_))
        assert _gap(jm_, tm_)[0] <= (1e-6 if dtype == "f32" else 2.0 ** -5) * scale
    assert int(to.count) == int(jo[0].count[0]) == 1


@pytest.mark.parametrize("keep", [True, False], ids=["keep_opt_state", "reset_opt_state"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_spmd_round_matches_jax(dtype, keep):
    """One ``run_round(eval=True)``: the train set, loss, accuracy, params
    and Adam state against JAX. With ``keep_opt_state`` every node keeps
    its trained moments; without, they restart from zero. Loss to 1e-5
    (fp32) / 2e-3 (bf16) relative; accuracy within one test example a
    node in fp32 and three in bf16 (an example on the decision boundary
    may flip); params within 2·lr a step, mean below 2e-6 / 0.05·lr; the
    kept first moments to 1e-4 (fp32: later steps see the flipped
    params) / 2^-5 (bf16) of the largest."""
    jfed, tfed = _pair(dtype, keep_opt_state=keep)
    je, te = jfed.run_round(eval=True), tfed.run_round(eval=True)
    assert te["round"] == je["round"] == 1
    tol = 1e-5 if dtype == "f32" else 2e-3
    assert float(te["train_loss"]) == pytest.approx(float(je["train_loss"]), rel=tol)
    n_test = tfed.y_test.numel()
    flips = (N_NODES if dtype == "f32" else 3 * N_NODES) / n_test
    assert abs(float(te["test_acc"]) - float(je["test_acc"])) <= flips
    worst, mean = _gap(jfed.params, tfed.params)
    assert worst <= 2 * LR * tfed._nb and mean <= (2e-6 if dtype == "f32" else 0.05 * LR), (worst, mean)
    # every node holds the aggregate after diffusion
    for _, leaf in tree_items(tfed.params):
        assert torch.equal(leaf[0], leaf[-1])
    jmu, tmu = jfed.opt_state[0].mu, tfed.opt_state.mu
    if keep:
        scale = max(float(np.abs(np.asarray(a)).max()) for a in jax.tree.leaves(jmu))
        assert _gap(jmu, tmu)[0] <= (1e-4 if dtype == "f32" else 2.0 ** -5) * scale
        assert int(tfed.opt_state.count) == int(jfed.opt_state[0].count[0]) == tfed._nb
    else:
        assert all(float(x.abs().max()) == 0.0 for x in tree_leaves(tmu))
        assert int(tfed.opt_state.count) == int(jfed.opt_state[0].count[0]) == 0


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rounds_and_fused_span_match_jax(dtype):
    """Three ``run_round``s, then ``run_fused(3, eval=True)`` (the bench's
    call), then ``evaluate``: the per-round accuracies and the final
    params against JAX. Accuracy within two test examples a node (fp32)
    or six (bf16) a round: Adam's ±lr flips accumulate over 18 steps;
    the losses to 1e-4 / 1e-2 relative (bf16 read up to 0.7% in round 6).
    Params within 2·lr a step; mean below 1e-5 (fp32) / 0.01·lr a step
    (bf16: read 1.0e-3 after 18 steps)."""
    jfed, tfed = _pair(dtype, keep_opt_state=True)
    n_test = tfed.y_test.numel()
    flips = (2 if dtype == "f32" else 6) * N_NODES / n_test
    for _ in range(3):
        je, te = jfed.run_round(eval=True), tfed.run_round(eval=True)
        assert abs(float(te["test_acc"]) - float(je["test_acc"])) <= flips
    jf, tf = jfed.run_fused(3, eval=True), tfed.run_fused(3, eval=True)
    for a, b in zip(jf, tf):
        assert a["round"] == b["round"]
        assert isinstance(b["test_acc"], torch.Tensor) and b["test_acc"].dim() == 0
        assert abs(float(b["test_acc"]) - float(a["test_acc"])) <= flips
        assert float(b["train_loss"]) == pytest.approx(float(a["train_loss"]), rel=1e-4 if dtype == "f32" else 1e-2)
    worst, mean = _gap(jfed.params, tfed.params)
    steps = 6 * tfed._nb
    assert worst <= 2 * LR * steps and mean <= (1e-5 if dtype == "f32" else 0.01 * LR * steps), (worst, mean)
    jm, tm = jfed.evaluate(), tfed.evaluate()
    assert abs(tm["test_acc"] - jm["test_acc"]) <= flips
    assert tm["test_loss"] == pytest.approx(jm["test_loss"], rel=1e-4 if dtype == "f32" else 1e-2)
    assert len(tm["per_node_acc"]) == N_NODES and tfed.round == jfed.round == 6


def test_run_fused_equals_run_rounds_in_the_port():
    """A fused span is the same rounds as ``run_round`` one by one (same
    draws of the shuffle stream, same program): bit for bit on the CPU."""
    fused, single = (_pair(keep_opt_state=True, vote=True)[1] for _ in range(2))
    entries = fused.run_fused(3, eval=True)
    for e in entries:
        s = single.run_round(eval=True)
        assert torch.equal(e["train_loss"], s["train_loss"]) and torch.equal(e["test_acc"], s["test_acc"])
    for (_, a), (_, b) in zip(tree_items(fused.params), tree_items(single.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(fused.opt_state.nu), tree_leaves(single.opt_state.nu)):
        assert torch.equal(a, b)
    assert np.array_equal(fused.train_mask, single.train_mask) and fused.round == single.round == 3


# ---- the other algorithms: one round each ----


def _sgd_round(**kw):
    """One round of a JAX and a port federation under fp32 SGD: the
    round's algebra without Adam's flips, held to 2e-6 absolute (params
    ~0.1, a few fp32 ulps of the summed steps) and the loss to 1e-6."""
    jfed, tfed = _pair("f32", optimizer="sgd", learning_rate=0.1, **kw)
    for _ in range(2):
        je, te = jfed.run_round(eval=True), tfed.run_round(eval=True)
        assert float(te["train_loss"]) == pytest.approx(float(je["train_loss"]), rel=1e-6)
        assert float(te["test_acc"]) == pytest.approx(float(je["test_acc"]), abs=1e-6)
    worst, _ = _gap(jfed.params, tfed.params)
    assert worst <= 2e-6, worst
    return jfed, tfed


@pytest.mark.parametrize("kw", [
    dict(prox_mu=0.1),
    dict(dp_clip=1.0),
    dict(dp_clip=1.0, prox_mu=0.1, remat=True),
    dict(participation=0.5),
], ids=["fedprox", "dp_sgd_noise0", "dp_prox_remat", "participation"])
def test_algorithm_round_matches_jax(kw):
    jfed, tfed = _sgd_round(**kw)
    assert np.array_equal(jfed._make_perm_np(1), tfed._make_perm_np(1))  # streams in step


@pytest.mark.parametrize("fused_ci", [True, False], ids=["fused_ci", "option_ii"])
def test_scaffold_round_matches_jax(fused_ci):
    """SCAFFOLD (SGD): params, the server variate and every node's own."""
    JaxSettings.SCAFFOLD_FUSED_CI = Settings.SCAFFOLD_FUSED_CI = fused_ci
    try:
        jfed, tfed = _sgd_round(scaffold=True)
    finally:
        JaxSettings.SCAFFOLD_FUSED_CI = Settings.SCAFFOLD_FUSED_CI = True
    scale = max(float(np.abs(np.asarray(a)).max()) for a in jax.tree.leaves(jfed.c_local))
    assert scale > 0
    # option II divides a params difference by K·lr: its variates carry
    # that cancellation, 1e-4 of their size; the fused-ci mean is exact
    tol = (1e-5 if fused_ci else 1e-3) * scale
    assert _gap(jfed.c_global, tfed.c_global)[0] <= tol
    assert _gap(jfed.c_local, tfed.c_local)[0] <= tol


@pytest.mark.parametrize("opt", ["adam", "yogi", "adagrad"])
def test_fedopt_round_matches_jax(opt):
    """The FedOpt server step after FedAvg, its moments carried across
    rounds and a fused span (the server step count runs on)."""
    jfed, tfed = _sgd_round(server_opt=opt, server_lr=0.05)
    jfed.run_fused(2), tfed.run_fused(2)
    assert tfed._server_t == jfed._server_t == 4
    worst, _ = _gap(jfed.params, tfed.params)
    assert worst <= 1e-5
    for a, b in ((jfed.opt_m, tfed.opt_m), (jfed.opt_v, tfed.opt_v)):
        scale = max(float(np.abs(np.asarray(x)).max()) for x in jax.tree.leaves(a))
        assert _gap(a, b)[0] <= 1e-4 * scale


def test_remat_changes_no_value():
    """``remat`` recomputes the forward in the backward: the same numbers."""
    feds = [_pair(remat=r, keep_opt_state=True)[1] for r in (False, True)]
    for fed in feds:
        fed.run_round()
    for (_, a), (_, b) in zip(tree_items(feds[0].params), tree_items(feds[1].params)):
        assert torch.equal(a, b)


def test_dp_noise_and_rng_streams():
    """With noise, the DP gradient's deviation from the noiseless one has
    standard deviation σ = noise·clip/B (within 5%), zero mean; a noisy
    round draws exactly what JAX's draws from the shuffle stream, so the
    next shuffles agree; the accountant steps as JAX's."""
    model = mlp(seed=0, device="cpu")
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.random((BATCH, 28, 28, 1), dtype=np.float32))
    y = torch.tensor(rng.integers(0, 10, BATCH).astype(np.int32))

    def loss_one(p, xi, yi, anchor):
        return tspmd._node_loss(model.module, 0.0)(p, xi[None], yi[None], anchor)

    clip, noise = 0.5, 1.3
    quiet, _ = tprivacy.dp_grads(loss_one, model.params, x, y, clip, 0.0)
    loud, _ = tprivacy.dp_grads(
        loss_one, model.params, x, y, clip, noise, torch.Generator().manual_seed(5)
    )
    dev = torch.cat([(a - b).reshape(-1) for a, b in zip(tree_leaves(loud), tree_leaves(quiet))])
    sigma = noise * clip / BATCH
    assert abs(float(dev.std()) / sigma - 1) <= 0.05 and abs(float(dev.mean())) <= 0.05 * sigma

    jfed, tfed = _pair("f32", dp_clip=1.0, dp_noise=1.1)
    jfed.run_round(), tfed.run_round()
    jfed.run_fused(2), tfed.run_fused(2)
    assert np.array_equal(jfed._make_perm_np(1), tfed._make_perm_np(1))
    assert tfed.accountant.steps == jfed.accountant.steps == 3 * tfed._nb
    assert tfed.accountant.epsilon() == jfed.accountant.epsilon()
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(tfed.params))


def test_clip_by_global_norm_matches_jax():
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32), "b": rng.standard_normal(5).astype(np.float32)}
    for clip in (0.1, 100.0):
        want = jprivacy.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), clip)
        got = tprivacy.clip_by_global_norm(tree_map(torch.tensor, tree), clip)
        assert _gap(want, got)[0] <= 1e-7


# ---- bench accounting ----


def test_round_flops_against_jax():
    """The port counts a round's FLOPs from the shapes; JAX reads XLA's
    cost analysis. At the bench's batch of 64 (4 nodes, 4 steps) they
    agree to 5%: the port leaves out activations, biases and the loss,
    XLA counts them and its own fusions (at the bench's 64 nodes the port
    reads 60.78 GFLOP a round against JAX's 61.26, ``BENCH_r05.json``).
    JAX's federation gets a one-device mesh: on the tests' virtual
    multi-device mesh XLA reports the per-device program."""
    from p2pfl_tpu.parallel.mesh import federation_mesh

    data, kw = dict(DATA, n_train=N_NODES * 256), dict(n_nodes=N_NODES, batch_size=64, vote=False, seed=3)
    jmodel = _jax_mlp(jnp.bfloat16)
    jfed = JaxFederation.from_dataset(
        jmodel, JaxDataset.synthetic_mnist(**data), mesh=federation_mesh(n_nodes=1, devices=jax.devices()[:1]), **kw
    )
    tfed = SpmdFederation.from_dataset(
        _port_model(jmodel, torch.bfloat16), FederatedDataset.synthetic_mnist(**data), device="cpu", **kw
    )
    want, got = jfed.round_flops(), tfed.round_flops()
    assert got == pytest.approx(want, rel=0.05), (got, want)
    assert np.array_equal(jfed._make_perm_np(1), tfed._make_perm_np(1))
    bench = SpmdFederation.from_dataset(
        mlp(device="cpu"), FederatedDataset.synthetic_mnist(n_train=64 * 937, n_test=64, **HARD),
        n_nodes=64, batch_size=64, vote=False, seed=3, keep_opt_state=True, device="cpu",
    )
    assert bench._nb == 14 and bench.round_flops() == pytest.approx(60.78e9, rel=1e-3)


def test_profiling_helpers_on_the_cpu():
    assert profiling.peak_flops("cpu") is None
    assert profiling.mfu(1e12, 1.0, device="cpu") is None
    t = torch.arange(3.0) + 2
    assert profiling.force_execution({"b": [t], "a": ()}) == 2.0
    assert profiling.force_execution(7) == 7.0


def test_sgd_matches_optax():
    rng = np.random.default_rng(4)
    g = {"w": rng.standard_normal((3, 2)).astype(np.float32)}
    want, _ = optax.sgd(0.3).update(jax.tree.map(jnp.asarray, g), optax.sgd(0.3).init(g))
    got, state = sgd(0.3).update(tree_map(torch.tensor, g), ())
    assert state == () and _gap(want, got)[0] == 0.0


def test_bias_correction_within_an_ulp_of_optax():
    """Adam's bias correction ``1 - b**count`` runs on the device from an
    int32 count: ``b**count`` within one fp32 ulp of optax's at every step
    to 3000 and equal at 95% of them (read 97.6%; neither side's ``pow`` is correctly
    rounded), so the corrections differ by at most that ulp."""
    counts = np.arange(1, 3001, dtype=np.int32)
    for b in (0.9, 0.999):
        want = np.asarray(jax.jit(lambda c: b ** c)(jnp.asarray(counts)))
        got = (b ** torch.tensor(counts).float()).numpy()
        normal = want > 1e-30  # XLA flushes denormals; 1 - b**c is 1 there either way
        assert np.all(np.abs(got - want)[normal] <= np.spacing(want[normal]))
        assert np.mean(got[normal] == want[normal]) >= 0.95
        assert np.all(1 - got[~normal] == 1 - want[~normal])


# ---- refusals ----


def _data():
    return FederatedDataset.synthetic_mnist(n_train=64, n_test=16)


def test_refusals(tmp_path):
    model = mlp(device="cpu")
    kw = dict(n_nodes=2, batch_size=8, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(DeviceUnavailableError):
            SpmdFederation.from_dataset(model, _data(), n_nodes=2, batch_size=8)
        with pytest.raises(DeviceUnavailableError):
            bench_mnist.run()
    Settings.SECURE_AGGREGATION = True
    try:
        with pytest.raises(ValueError, match="SECURE_AGGREGATION"):
            SpmdFederation.from_dataset(model, _data(), **kw)
    finally:
        Settings.SECURE_AGGREGATION = False
    for bad, match in (
        (dict(scaffold=True), "requires optimizer='sgd'"),
        (dict(scaffold=True, optimizer="sgd", tx=sgd(0.1)), "requires optimizer='sgd'"),
        (dict(dp_noise=1.0), "requires dp_clip"),
        (dict(aggregator="clip", clip_tau=0.0), "clip_tau must be > 0"),
        (dict(aggregator="mode"), "unknown aggregator"),
        (dict(server_opt="sgdm"), "unknown server_opt"),
        (dict(participation=0.0), "participation"),
    ):
        with pytest.raises(ValueError, match=match):
            SpmdFederation.from_dataset(model, _data(), **kw, **bad)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 5"):
        SpmdFederation.from_dataset(model, _data(), mesh=object(), **kw)
    fed = SpmdFederation.from_dataset(model, _data(), participation=0.5, **kw)
    with pytest.raises(ValueError, match="fixed mask"):
        fed.run_fused(2)
    fed = SpmdFederation.from_dataset(model, _data(), vote=True, **kw)
    Settings.VOTE_EVERY_ROUND = True
    try:
        with pytest.raises(ValueError, match="fixed mask"):
            fed.run_fused(2)
    finally:
        Settings.VOTE_EVERY_ROUND = False
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        fed.restore(str(tmp_path / "somewhere"))
    fed.drop_node(0)
    fed.drop_node(1)
    with pytest.raises(RuntimeError, match="no active"):
        fed.run_round()


@pytest.mark.parametrize("algo", ["plain", "scaffold", "fedadam"])
def test_profile_round_breakdown_keys_and_state(algo):
    """``profile_round`` (``tests/test_round_pipeline.py``'s twin): every
    phase timed, ``last_profile`` set, and the federation untouched — the
    next round of the profiled federation equals its unprofiled twin's bit
    for bit (params, loss and the numpy rng stream), with participation
    sampling and SCAFFOLD's or FedOpt's carried state in play."""
    extra = {"plain": dict(participation=0.5), "scaffold": dict(scaffold=True, optimizer="sgd"),
             "fedadam": dict(server_opt="adam")}[algo]
    kw = dict(n_nodes=4, batch_size=16, vote=False, seed=3, device="cpu", **extra)
    fed = SpmdFederation.from_dataset(mlp(seed=0, device="cpu"), _data(), **kw)
    twin = SpmdFederation.from_dataset(mlp(seed=0, device="cpu"), _data(), **kw)
    fed.run_round()
    twin.run_round()
    assert fed.last_profile is None
    prof = fed.profile_round(epochs=1, iters=1)
    assert prof is fed.last_profile
    for key in ("total_s", "train_s", "correction_s", "aggregate_s"):
        assert key in prof and prof[key] >= 0.0, prof
    if algo == "plain":
        assert prof["train_s"] == prof["total_s"] and prof["correction_s"] == 0.0
    assert fed._rng.bit_generator.state == twin._rng.bit_generator.state
    e1, e2 = fed.run_round(), twin.run_round()
    assert torch.equal(e1["train_loss"], e2["train_loss"])
    def state(f):
        carried = [getattr(f, k) for k in ("c_global", "c_local", "opt_m", "opt_v") if hasattr(f, k)]
        return torch.utils._pytree.tree_leaves((f.params, f.opt_state, *carried))

    assert all(torch.equal(a, b) for a, b in zip(state(fed), state(twin), strict=True))


def test_profile_round_restores_the_rng_when_a_probe_fails(monkeypatch):
    """A probe that raises leaves the numpy rng where it was, and
    ``run_round(profile=True)`` profiles the round it is about to run."""
    fed = SpmdFederation.from_dataset(mlp(seed=0, device="cpu"), _data(), n_nodes=4, batch_size=16, vote=False,
                                      seed=3, device="cpu")
    before = fed._rng.bit_generator.state

    def boom(*a, **k):
        raise RuntimeError("probe failed")

    monkeypatch.setattr(tspmd, "spmd_round", boom)
    with pytest.raises(RuntimeError, match="probe failed"):
        fed.profile_round()
    assert fed._rng.bit_generator.state == before and fed.last_profile is None
    monkeypatch.undo()
    fed.run_round(profile=True)
    assert set(fed.last_profile) >= {"total_s", "train_s", "correction_s", "aggregate_s"}
    assert fed.round == 1


def test_state_machine_and_examples(capsys, monkeypatch):
    """Node failure, reset, ``run`` with evaluation, the default dtype
    setting, and both examples' CPU paths at a tiny size."""
    fed = SpmdFederation.from_dataset(
        mlp(device="cpu"), _data(), n_nodes=4, batch_size=8, vote=False, device="cpu"
    )
    assert fed.module.dtype == getattr(torch, Settings.COMPUTE_DTYPE) == torch.bfloat16
    fed.drop_node(2)
    fed.run_round()
    assert fed._effective_mask().tolist() == [1.0, 1.0, 0.0, 1.0]
    fed.restore_node(2)
    history = fed.run(2, eval_every=1)
    assert len(history) == 3 and "test_acc" in history[-1] and fed.round == 3
    fed.reset(seed=0)
    assert fed.round == 0 and fed.history == [] and int(fed.opt_state.count) == 0
    assert torch.equal(fed.node_params(3)["Dense_0"]["kernel"], fed.model.params["Dense_0"]["kernel"])

    from p2pfl_tpu_torch.examples import spmd_mnist

    small = FederatedDataset.synthetic_mnist(n_train=256, n_test=32)
    monkeypatch.setattr(FederatedDataset, "mnist", classmethod(lambda cls: small))
    spmd_mnist.main(["--device", "cpu", "--nodes", "2", "--rounds", "1", "--dp-clip", "1.0",
                     "--dp-noise", "1.0", "--measure_time"])
    out = capsys.readouterr().out
    assert "round 1: loss=" in out and "privacy spent: eps=" in out and "elapsed" in out


# ---- the bench configuration (slow) ----


@pytest.mark.slow
def test_bench_curve_64_nodes_matches_jax():
    """``bench.py``'s federation (64 nodes, batch 64, keep_opt_state,
    seed 3, the synthetic-hard task) from JAX's init, on the CPU, bf16:
    fused chunks of 5 rounds with the on-device curve. The port's curve
    crosses 98% within one round of JAX's (both crossed at round 9, as
    JAX's ``BENCH_r05.json``), and each round's accuracy is within 0.05
    of JAX's: Adam's flips compound over the rounds, and before the
    crossing both curves dip and recover (the largest gap read 0.041, at
    round 6)."""
    kw = dict(n_nodes=64, batch_size=64, vote=False, seed=3, keep_opt_state=True)
    jmodel = _jax_mlp(jnp.bfloat16)
    jfed = JaxFederation.from_dataset(jmodel, JaxDataset.mnist(None, **HARD), **kw)
    tfed = SpmdFederation.from_dataset(
        _port_model(jmodel, torch.bfloat16), FederatedDataset.mnist(None, **HARD), device="cpu", **kw
    )
    jcurve, tcurve = [], []
    while len(tcurve) < 15:
        jcurve += [float(e["test_acc"]) for e in jfed.run_fused(5, eval=True)]
        tcurve += [float(e["test_acc"]) for e in tfed.run_fused(5, eval=True)]
        if min(max(jcurve), max(tcurve)) >= 0.98:
            break
    cross = [next(i + 1 for i, a in enumerate(c) if a >= 0.98) for c in (jcurve, tcurve)]
    print(f"JAX {jcurve}\nport {tcurve}\nrounds to 98%: JAX {cross[0]}, port {cross[1]}")
    assert abs(cross[0] - cross[1]) <= 1
    assert max(abs(a - b) for a, b in zip(jcurve, tcurve)) <= 0.05

