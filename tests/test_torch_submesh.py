"""Sharded nodes on the port (``parallel/submesh.py``, sharded learners,
the shard-wise fold and the ICI plane's per-slot blocks) against the JAX
package and against the port's own one-slot paths, on the CPU.

JAX runs on 8 virtual CPU devices (``tests/conftest.py``); the port's
slots all name the CPU (``parallel/mesh.py``). Inputs are numpy-made
from seeds; both packages get the same init (JAX's, converted).

Tolerances, stated where used:

- the port against itself: BIT-EQUAL. ``model_parallel=2`` against
  ``model_parallel=1``, a sharded learner against a plain one, the
  sharded round against ``fused_node_round``: the gathered tensors are
  the whole tensors, Adam and SGD are elementwise and the fold sums node
  by node, so every shard gets the bits of the whole. Against
  ``SpmdFederation`` (one vmapped program, a contraction for the fold):
  summation-order ulps, stated in the test.
- the port against JAX, fp32 compute: ``rtol 2e-5, atol 1e-6`` (SGD;
  measured 3e-8). Not bit-equal: XLA's and the CPU BLAS's fp32 GEMMs sum
  in different orders.
- bf16 compute (the JAX MLP's default): XLA and torch round every bf16
  product differently; two SGD rounds read 7.8e-5 max, 1.9e-6 mean, so
  ``atol 2.5e-4`` and a mean under 1e-5.
- under Adam an element whose gradient sits at rounding noise moves by
  about ±lr a step either way (``tests/test_torch_spmd.py``): each element
  within 2·lr a step, the mean far below.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2pfl_tpu.learning.dataset import FederatedDataset as JaxDataset
from p2pfl_tpu.models.base import FlaxModel
from p2pfl_tpu.models.vision import MLP as JaxMLP
from p2pfl_tpu.parallel import ShardedNodeFederation as JaxSharded
from p2pfl_tpu_torch import DeviceUnavailableError
from p2pfl_tpu_torch.communication import ici
from p2pfl_tpu_torch.communication.memory import MemoryRegistry
from p2pfl_tpu_torch.convert import params_from_jax, params_to_jax, placed_params_from_jax
from p2pfl_tpu_torch.learning.dataset import FederatedDataset
from p2pfl_tpu_torch.learning.learner import TorchLearner, init_opt_state, sgd
from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.models.base import TorchModel
from p2pfl_tpu_torch.models.vision import MLP
from p2pfl_tpu_torch.node import stop_leaked_nodes
from p2pfl_tpu_torch.ops import aggregation as tagg
from p2pfl_tpu_torch.ops.tree import tree_items, tree_leaves, tree_map
from p2pfl_tpu_torch.parallel import ici_plane
from p2pfl_tpu_torch.parallel import sharding as tsh
from p2pfl_tpu_torch.parallel.mesh import node_slices, submesh_federation_mesh
from p2pfl_tpu_torch.parallel.spmd import SpmdFederation, fused_node_round
from p2pfl_tpu_torch.parallel.submesh import ShardedNodeFederation, stack_across_slices, submesh_node_round
from p2pfl_tpu_torch.settings import Settings, set_test_settings

torch.set_num_threads(2)

MLP_RULES = (
    (r"Dense_0/kernel", (None, "model")),
    (r"Dense_1/kernel", ("model", None)),
    (r"Dense_2/kernel", (None, "model")),
    (r".*", ()),
)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _port_env():
    set_test_settings()
    logger.set_level("INFO")
    MemoryRegistry.reset()
    ici.ShardPlaneRegistry.reset()
    ici.reset_ici_stats()
    yield
    stop_leaked_nodes()
    MemoryRegistry.reset()
    ici.ShardPlaneRegistry.reset()
    Settings.WEIGHTS_PLANE = "bytes"


def _jax_model(dtype=jnp.float32) -> FlaxModel:
    return FlaxModel.create(JaxMLP(dtype=dtype), (28, 28, 1), seed=0)


def _port_model(jmodel: FlaxModel, dtype=torch.float32) -> TorchModel:
    return TorchModel(MLP(dtype=dtype), params_from_jax(jax.tree.map(np.asarray, jmodel.params), device="cpu"),
                      (28, 28, 1))


def _bit_equal(a, b) -> bool:
    la, lb = tree_leaves(tsh.gather_tree(a)), tree_leaves(tsh.gather_tree(b))
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _feds(n=4, model_parallel=1, optimizer="sgd", keep_opt_state=False, vote=False, dtype="f32",
          data_parallel=1, jax_side=True, **kw):
    """A JAX and a port ShardedNodeFederation from one init, data and seed
    (JAX's ``tests/test_submesh.py::_mk_feds``)."""
    jdt, tdt = DTYPES[dtype]
    base = dict(batch_size=16, vote=vote, seed=3, optimizer=optimizer, learning_rate=1e-2,
                keep_opt_state=keep_opt_state, **kw)
    jmodel = _jax_model(jdt)
    port = ShardedNodeFederation.from_dataset(
        _port_model(jmodel, tdt), FederatedDataset.synthetic_mnist(n_train=64 * n, n_test=32, seed=5),
        n_nodes=n, rules=MLP_RULES, model_parallel=model_parallel, data_parallel=data_parallel, device="cpu",
        **base,
    )
    if not jax_side:
        return None, port
    jfed = JaxSharded.from_dataset(
        jmodel, JaxDataset.synthetic_mnist(n_train=64 * n, n_test=32, seed=5), n_nodes=n, rules=MLP_RULES,
        model_parallel=model_parallel, data_parallel=data_parallel, **base,
    )
    return jfed, port


def _jleaves(tree) -> list:
    return [np.asarray(x, dtype=np.float32) for x in jax.tree.leaves(tree)]


def _tleaves(tree) -> list:
    return [x.float().numpy() for x in tree_leaves(tsh.gather_tree(tree))]


# ---- the node round ----


def test_submesh_node_round_bit_identical_to_fused_node_round():
    """The port's submesh round is its fused Node round bit for bit (the
    batches gathered on the device by ``perm``, the accumulator with a
    leading node axis), placed or not; against JAX's submesh round at
    ``rtol 2e-5, atol 1e-6`` (fp32, SGD)."""
    from p2pfl_tpu.learning.learner import sgd as jsgd
    from p2pfl_tpu.parallel.submesh import submesh_node_round as jax_round

    jmodel = _jax_model()
    model = _port_model(jmodel)
    tx = sgd(1e-2)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(48, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=(48,)).astype(np.int32)
    perm = rng.permutation(48).reshape(1, 6, 8).repeat(2, axis=0).astype(np.int32)
    w = torch.tensor(64.0)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    idx = torch.from_numpy(perm).long()
    fused = fused_node_round(model.params, tx.init(model.params), xt[idx], yt[idx], w, module=model.module, tx=tx)
    sub = submesh_node_round(model.params, tx.init(model.params), xt, yt, torch.from_numpy(perm), w,
                             module=model.module, tx=tx)
    assert _bit_equal(fused["params"], sub["params"]) and torch.equal(fused["train_losses"], sub["train_losses"])
    assert _bit_equal(fused["psum"], tree_map(lambda v: v[0], sub["psum"]))
    assert tuple(sub["wsum"].shape) == (1,) and float(sub["wsum"][0]) == float(fused["wsum"])
    # placed on a (1, 2) slice: the same bits, the accumulator placed
    sl = node_slices(submesh_federation_mesh(1, 2, devices=["cpu"] * 2))[0]
    placed = tsh.shard_tree(sl, model.params, MLP_RULES)
    psub = submesh_node_round(placed, init_opt_state(tx, placed), xt, yt, torch.from_numpy(perm), w,
                              module=model.module, tx=tx)
    assert _bit_equal(psub["params"], sub["params"])
    k = psub["psum"]["Dense_0"]["kernel"]
    assert isinstance(k, tsh.SlotSharded) and k.spec == (None, None, "model") and tuple(k.shape) == (1, 784, 256)
    assert torch.equal(k.full(), sub["psum"]["Dense_0"]["kernel"])
    # JAX's submesh round on the same inputs
    jp = jax.tree.map(jnp.asarray, jmodel.params)
    jtx = jsgd(1e-2)
    jout = jax_round(jp, jtx.init(jp), jnp.asarray(x), jnp.asarray(y), jnp.asarray(perm), jnp.float32(64.0),
                     module=jmodel.module, tx=jtx)
    for a, b in zip(_jleaves(jout["params"]), _tleaves(psub["params"])):
        np.testing.assert_allclose(b, a, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(sub["train_losses"].numpy(), np.asarray(jout["train_losses"]), rtol=2e-5)


# ---- federation parity ----


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_sharded_federation_m1_bit_identical_to_spmd(optimizer):
    """model_parallel=1 against the port's SpmdFederation (moments kept, 3
    rounds). SpmdFederation steps the nodes as one vmapped program
    (batched GEMMs) and folds by a weighted contraction; the sharded
    federation steps one node at a time and sums node by node. Under SGD
    the two agree to summation-order ulps (``rtol 1e-5, atol 1e-7``);
    under Adam an element whose gradient sits at rounding noise flips by
    ±lr a step, so each element within 2·lr a step, the mean under 1e-6,
    and the step counts equal."""
    _, sharded = _feds(optimizer=optimizer, keep_opt_state=True, jax_side=False)
    ref = SpmdFederation.from_dataset(
        sharded.model, FederatedDataset.synthetic_mnist(n_train=256, n_test=32, seed=5), n_nodes=4, batch_size=16,
        vote=False, seed=3, optimizer=optimizer, learning_rate=1e-2, keep_opt_state=True, device="cpu",
    )
    for _ in range(3):
        sharded.run_round(epochs=1)
        ref.run_round(epochs=1)
    for i in range(sharded.n):
        if optimizer == "sgd":
            for a, b in zip(_tleaves(sharded.node_params(i)), _tleaves(ref.node_params(i))):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
        else:
            diffs = [np.abs(a - b) for a, b in zip(_tleaves(sharded.node_params(i)), _tleaves(ref.node_params(i)))]
            assert max(float(d.max()) for d in diffs) <= 2 * 1e-2 * 3 * sharded._nb
            assert np.mean([d.mean() for d in diffs]) < 1e-6
            assert int(sharded.opt_state[i].count) == int(ref.opt_state.count) == 3 * sharded._nb
    assert float(sharded.last_fold["wsum"].sum()) == float(sum(sharded._sizes))


def test_sharded_federation_m1_vote_path_matches_spmd():
    """Partial participation (3 of 4 elected): non-elected nodes fold an
    explicit zero accumulator. Against the port's SpmdFederation (ROADMAP
    Queue C: not JAX's sharded path): the same train set; the fold
    accumulates then divides where SpmdFederation normalizes first, so at
    a total weight of 192 the two agree to summation-order ulps
    compounded by the second round's training: ``rtol 1e-3, atol 5e-6``
    (JAX's own bound)."""
    Settings.TRAIN_SET_SIZE = 3
    _, sharded = _feds(vote=True, jax_side=False)
    ref = SpmdFederation.from_dataset(
        sharded.model, FederatedDataset.synthetic_mnist(n_train=256, n_test=32, seed=5), n_nodes=4, batch_size=16,
        vote=True, seed=3, optimizer="sgd", learning_rate=1e-2, device="cpu",
    )
    for _ in range(2):
        e1 = sharded.run_round(epochs=1)
        e2 = ref.run_round(epochs=1)
    assert (sharded.train_mask == ref.train_mask).all() and sharded.train_mask.sum() == 3.0
    for a, b in zip(_tleaves(sharded.node_params(0)), _tleaves(ref.node_params(0))):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=5e-6)
    assert np.isfinite(e1["train_loss"]) and np.isfinite(float(e2["train_loss"]))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_sharded_federation_m2_matches_jax_and_the_ports_m1(dtype):
    """model_parallel=2, 2 rounds (JAX's test): against JAX's sharded
    federation (fp32 ``rtol 2e-5, atol 1e-6``; bf16 ``atol 2.5e-4``, mean
    under 1e-5) and against the port's model_parallel=1 bit for bit."""
    jfed, m2 = _feds(model_parallel=2, dtype=dtype)
    _, m1 = _feds(model_parallel=1, dtype=dtype, jax_side=False)
    for _ in range(2):
        jfed.run_round(epochs=1)
        m2.run_round(epochs=1)
        m1.run_round(epochs=1)
    for i in range(m2.n):
        assert _bit_equal(m2.node_params(i), m1.node_params(i))
    diffs = []
    for a, b in zip(_jleaves(jfed.node_params(0)), _tleaves(m2.node_params(0))):
        if dtype == "f32":
            np.testing.assert_allclose(b, a, rtol=2e-5, atol=1e-6)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=2.5e-4)
        diffs.append(np.abs(a - b).mean())
    assert dtype == "f32" or np.mean(diffs) < 1e-5


def test_sharded_federation_never_materializes_full_model_per_device():
    """Fold inputs are the node-stacks of each slot's shards, fold outputs
    and the diffused params are slot shards (the half tensors), and no
    slot holds a full params copy: per-slot bytes equal the port's
    ``shard_shape`` accounting exactly and stay under half the model
    + 20 %."""
    _, fed = _feds(model_parallel=2, jax_side=False)
    fed.run_round(epochs=1)
    full = {path: tuple(x.shape) for path, x in tree_items(fed.model.params)}
    for (path, k), shape in fed.last_fold["blocks"].items():
        if path.endswith("kernel"):
            assert k is not None and shape[0] == fed.n and shape[1:] != full[path], (path, shape)
    k0 = fed.node_params(0)["Dense_0"]["kernel"]
    assert k0.spec == (None, Settings.MESH_MODEL_AXIS)
    assert [tuple(s.shape) for s in k0.shards] == [(784, 128)] * 2
    per_slot = fed.per_device_bytes()
    assert len(per_slot) == 2 * fed.n
    want = tsh.shard_bytes_accounting(fed.slices[0], fed.model.params, MLP_RULES)
    assert set(per_slot.values()) == {want}  # SGD: no optimizer state
    full_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(fed.model.params))
    assert max(per_slot.values()) < full_bytes / 2 * 1.2
    with pytest.raises(RuntimeError, match="whole sharded leaf"):
        fed._assert_fold_shardings({}, {})


def test_fold_vs_restacked_fedavg_parity():
    """The fold (accumulate, then divide) against the restacked FedAvg
    (normalize, then contract): bit-equal at equal weights (a common
    factor commutes with every rounding), ``rtol 1e-6`` otherwise; and
    the same fold in JAX, bit-equal at equal weights."""
    from p2pfl_tpu.ops.aggregation import fedavg_fold_stacked as jfold

    rng = np.random.default_rng(7)
    n = 4
    stacked = {"a": rng.normal(size=(n, 6, 4)).astype(np.float32), "b": rng.normal(size=(n, 3)).astype(np.float32)}
    ts = tree_map(torch.from_numpy, stacked)
    ref = tree_map(lambda x: x[0], ts)

    def fold(weights):
        w = torch.tensor(weights, dtype=torch.float32)
        psum = tree_map(lambda x: x * w.reshape((n,) + (1,) * (x.dim() - 1)), ts)
        return tagg.fedavg_fold_stacked(psum, w, ref), psum, w

    eq, psum, w = fold([32.0] * n)
    assert _bit_equal(eq, tagg.fedavg(ts, torch.full((n,), 32.0)))
    jeq = jfold(tree_map(lambda x: jnp.asarray(x.numpy()), psum), jnp.asarray(w.numpy()),
                jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape[1:], x.dtype), stacked))
    for a, b in zip(_jleaves(jeq), _tleaves(eq)):
        np.testing.assert_array_equal(a, b)
    uneq, _, _ = fold([31.0, 64.0, 17.0, 96.0])
    for a, b in zip(_tleaves(uneq), _tleaves(tagg.fedavg(ts, torch.tensor([31.0, 64.0, 17.0, 96.0])))):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    # stacked shard by shard: the stack of each slot's blocks
    from p2pfl_tpu_torch.parallel.submesh import _lead

    sl = node_slices(submesh_federation_mesh(1, 2, devices=["cpu"] * 2))[0]
    per_node = [tree_map(_lead, tsh.shard_tree(sl, tree_map(lambda x, i=i: x[i], ts),
                                               ((r"a", (None, "model")), (r".*", ()))))
                for i in range(n)]
    blocks = stack_across_slices(per_node)
    assert sorted(blocks["a"]) == ["#0", "#1"] and tuple(blocks["a"]["#0"].shape) == (n, 6, 2)
    assert torch.equal(torch.cat([blocks["a"]["#0"], blocks["a"]["#1"]], dim=-1), ts["a"])


def test_sharded_federation_data_parallel_smoke():
    _, fed = _feds(n=2, model_parallel=2, data_parallel=2, jax_side=False)
    assert len(fed.mesh.slot_keys) == 8 and dict(fed.slices[0].shape) == {"data": 2, "model": 2}
    e = fed.run_round(epochs=1, eval=True)
    assert np.isfinite(e["train_loss"]) and 0.0 <= e["test_acc"] <= 1.0
    # diffusion: both nodes hold the identical aggregate; every slot holds
    # its block (the data axis duplicates the model axis's blocks)
    assert _bit_equal(fed.node_params(0), fed.node_params(1))
    k = fed.node_params(0)["Dense_0"]["kernel"]
    assert len(k.shards) == 4 and torch.equal(k.shards[0], k.shards[2])


def test_sharded_federation_rejects_bad_rules_and_secagg():
    data = FederatedDataset.synthetic_mnist(n_train=64, n_test=16, seed=5)
    model = _port_model(_jax_model())
    with pytest.raises(ValueError, match="fails lint"):
        ShardedNodeFederation.from_dataset(model, data, n_nodes=2, rules=((r"Dnse_0/kernel", (None, "model")),
                                                                          (r".*", ())), batch_size=16,
                                           device="cpu")
    Settings.SECURE_AGGREGATION = True
    try:
        with pytest.raises(ValueError, match="trust domain"):
            ShardedNodeFederation.from_dataset(model, data, n_nodes=2, rules=MLP_RULES, batch_size=16, device="cpu")
    finally:
        Settings.SECURE_AGGREGATION = False
    with pytest.raises(ValueError, match="robust_agg"):
        ShardedNodeFederation.from_dataset(model, data, n_nodes=2, rules=MLP_RULES, batch_size=16, device="cpu",
                                           robust_agg="krum")
    if not torch.cuda.is_available():
        with pytest.raises(DeviceUnavailableError):
            ShardedNodeFederation.from_dataset(model, data, n_nodes=2, rules=MLP_RULES, batch_size=16)


# ---- robust folds ----


@pytest.mark.parametrize("kind,trim", [("median", 1), ("trimmed-mean", 1), ("trimmed-mean", 2),
                                       ("trimmed-mean", 0)])
def test_robust_fold_stacked_matches_jax(kind, trim):
    """Median and trimmed mean over node-stacked params (N 5, fp32 and
    bf16 leaves) against JAX's ``robust_fold_stacked``: the median
    bit-equal (sort, the middle value); the trimmed mean to ``rtol 1e-6``
    (a mean of the kept values, summed in another order); and shard by
    shard the same bits as over the whole leaves."""
    from p2pfl_tpu.ops.aggregation import robust_fold_stacked as jfold

    rng = np.random.default_rng(11)
    stacked = {"k": rng.normal(size=(5, 8, 6)).astype(np.float32), "b": rng.normal(size=(5, 6)).astype(np.float32)}
    ref = {"k": np.zeros((8, 6), np.float32), "b": np.zeros((6,), jnp.bfloat16)}
    jout = jfold(jax.tree.map(jnp.asarray, stacked), jax.tree.map(jnp.asarray, ref), kind, trim=trim)
    tref = {"k": torch.zeros(8, 6), "b": torch.zeros(6, dtype=torch.bfloat16)}
    tout = tagg.robust_fold_stacked(tree_map(torch.from_numpy, stacked), tref, kind, trim=trim)
    assert tout["b"].dtype == torch.bfloat16
    for a, b in zip(_jleaves(jout), _tleaves(tout)):
        if kind == "median":
            np.testing.assert_array_equal(b, a)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)
    halves = [tagg.robust_fold_stacked({"k": torch.from_numpy(stacked["k"][:, :, h * 3:(h + 1) * 3])},
                                       {"k": tref["k"]}, kind, trim=trim)["k"] for h in range(2)]
    assert torch.equal(torch.cat(halves, dim=-1), tout["k"])


@pytest.mark.parametrize("kind", ["median", "trimmed-mean"])
def test_robust_sharded_federation_m2_bit_equal_m1_and_near_jax(kind):
    """``robust_agg`` at model_parallel 2 against 1 (bit for bit), against
    JAX's robust sharded federation (fp32, ``rtol 2e-5, atol 1e-6``), and
    the refusal of partial participation."""
    jfed, m2 = _feds(model_parallel=2, robust_agg=kind)
    _, m1 = _feds(model_parallel=1, robust_agg=kind, jax_side=False)
    for _ in range(2):
        jfed.run_round(epochs=1)
        m2.run_round(epochs=1)
        m1.run_round(epochs=1)
    assert _bit_equal(m2.node_params(0), m1.node_params(0)) and m2.last_fold["wsum"] is None
    for a, b in zip(_jleaves(jfed.node_params(0)), _tleaves(m2.node_params(0))):
        np.testing.assert_allclose(b, a, rtol=2e-5, atol=1e-6)
    m2.drop_node(1)
    with pytest.raises(RuntimeError, match="full participation"):
        m2.run_round(epochs=1)


# ---- sharded learners ----


def _learners(mesh, rules=MLP_RULES, dtype="f32", seed=9, **kw):
    jdt, tdt = DTYPES[dtype]
    data = FederatedDataset.synthetic_mnist(n_train=64, n_test=16, seed=1)
    jmodel = _jax_model(jdt)
    placed = TorchLearner(_port_model(jmodel, tdt), data, batch_size=16, seed=seed, mesh=mesh,
                          partition_rules=rules, **kw)
    plain = TorchLearner(_port_model(jmodel, tdt), data, batch_size=16, seed=seed, **kw)
    return jmodel, placed, plain


def test_learner_submesh_placement_matches_plain_learner():
    """A TorchLearner on a (1, 2) slice: params and Adam moments placed
    by the rules; ``fit`` bit-equal to the plain learner's (and to JAX's
    placed learner within 2·lr a step, Adam's flips); the fused round's
    ``partial_acc`` keeps the layout; a typo'd rule set fails at
    construction. The per-slot bytes of params + Adam equal the
    ``shard_shape`` accounting exactly."""
    from p2pfl_tpu.learning.learner import JaxLearner
    from p2pfl_tpu.parallel.mesh import node_slices as jnode_slices
    from p2pfl_tpu.parallel.mesh import submesh_federation_mesh as jsubmesh

    sl = node_slices(submesh_federation_mesh(1, 2, devices=["cpu"] * 2))[0]
    jmodel, placed, plain = _learners(sl)
    k = placed.params["Dense_0"]["kernel"]
    assert isinstance(k, tsh.SlotSharded) and k.spec == (None, Settings.MESH_MODEL_AXIS)
    assert placed.opt_state.mu["Dense_0"]["kernel"].spec == (None, Settings.MESH_MODEL_AXIS)
    assert isinstance(placed.params["Dense_0"]["bias"], torch.Tensor)
    got = tsh.slot_bytes(placed.params, placed.opt_state, mesh=sl)
    want = (tsh.shard_bytes_accounting(sl, placed.params, MLP_RULES)
            + tsh.shard_bytes_accounting(sl, placed.opt_state, MLP_RULES))
    assert set(got.values()) == {want}
    placed.fit()
    plain.fit()
    assert _bit_equal(placed.params, plain.params)
    assert _bit_equal(placed.opt_state.nu, plain.opt_state.nu)
    jsl = jnode_slices(jsubmesh(1, model_parallel=2, devices=jax.devices()[:2]))[0]
    jl = JaxLearner(jmodel, JaxDataset.synthetic_mnist(n_train=64, n_test=16, seed=1), batch_size=16, seed=9,
                    mesh=jsl, partition_rules=MLP_RULES)
    jl.fit()
    diffs = [np.abs(a - b) for a, b in zip(_jleaves(jl.params), _tleaves(placed.params))]
    assert max(float(d.max()) for d in diffs) <= 2 * 1e-3 * 4 and np.mean([d.mean() for d in diffs]) < 1e-5
    # the fused round runs placed, its accumulator keeps the layout
    upd = placed.fused_round()
    ref = plain.fused_round()
    psum, _ = upd.partial_acc
    assert psum["Dense_0"]["kernel"].spec == (None, Settings.MESH_MODEL_AXIS)
    assert _bit_equal(psum, ref.partial_acc[0]) and _bit_equal(upd.params, ref.params)
    assert placed.evaluate() == plain.evaluate()
    with pytest.raises(ValueError, match="fails lint"):
        TorchLearner(_port_model(jmodel), FederatedDataset.synthetic_mnist(n_train=64, n_test=16), batch_size=16,
                     mesh=sl, partition_rules=((r"Dnse/kernel", ("model",)),))


def test_sharded_learner_checkpoint_resume_bit_equal(tmp_path):
    """Save a sharded learner after one fit (gathered), resume into a new
    learner on another slice of the same shape (placed again), fit both
    once more: bit-equal params and moments, as the uninterrupted one."""
    from p2pfl_tpu_torch.learning.checkpoint import restore_learner, save_learner

    slices = node_slices(submesh_federation_mesh(2, 2, devices=["cpu"] * 4))
    _, a, _ = _learners(slices[0], keep_opt_state=True)
    a.fit()
    save_learner(str(tmp_path), a, round=1)
    _, b, _ = _learners(slices[1], keep_opt_state=True)
    restore_learner(str(tmp_path), b)
    assert b.params["Dense_1"]["kernel"].mesh is slices[1]
    assert b.opt_state.mu["Dense_1"]["kernel"].spec == (Settings.MESH_MODEL_AXIS, None)
    b._rng.bit_generator.state = a._rng.bit_generator.state
    a.fit()
    b.fit()
    assert _bit_equal(a.params, b.params) and _bit_equal(a.opt_state.mu, b.opt_state.mu)
    assert int(a.opt_state.count) == int(b.opt_state.count) == 8


# ---- the ICI plane's per-slot blocks ----


def _bits(t):
    return t.reshape(-1).view(torch.int16 if t.element_size() == 2 else torch.int32)


def test_shard_transfer_moves_every_slot_block_in_one_exchange(monkeypatch):
    """A mixed fp32/bf16 tree placed on a (1, 2) slice moves onto a
    disjoint slice: block k of the sender lands on slot k of the receiver
    in ONE exchange (kernel 9's one launch on a card; its plain version
    here), bit-exact; the filler is never written; the specs ride along."""
    slices = node_slices(submesh_federation_mesh(2, 2, devices=["cpu"] * 4))
    rules = ((r"w$", (None, "model")), (r"e$", ("model", None)), (r".*", ()))
    rng = np.random.default_rng(2)

    def tree(sl, seed):
        r = np.random.default_rng(seed)
        t = {"w": torch.from_numpy(r.normal(size=(7, 6)).astype(np.float32)),
             "e": torch.from_numpy(r.normal(size=(4, 3)).astype(np.float32)).to(torch.bfloat16),
             "b": torch.from_numpy(r.normal(size=(5,)).astype(np.float32))}
        return tsh.shard_tree(sl, t, rules)

    src_tree, filler = tree(slices[0], 0), tree(slices[1], 1)
    before = [s.clone() for leaf in tree_leaves(filler) for s in ici_plane._blocks(leaf)]
    src = ici_plane.slice_info_of(src_tree, slices[0])
    dst = ici_plane.slice_info_of(filler, slices[1])
    assert src.specs == dst.specs == ((), ("model", None), (None, "model"))
    calls = []
    real = ici_plane.exchange
    monkeypatch.setattr(ici_plane, "exchange", lambda s, d: (calls.append(len(s)), real(s, d)))
    out = ici_plane.shard_transfer(src_tree, filler, src, dst)
    assert calls == [5]  # b whole + 2 blocks of e + 2 blocks of w, one exchange
    for path, leaf in tree_items(out):
        sent = dict(tree_items(src_tree))[path]
        for k, (a, b) in enumerate(zip(ici_plane._blocks(sent), ici_plane._blocks(leaf))):
            assert torch.equal(_bits(a), _bits(b)) and a.data_ptr() != b.data_ptr()
        if isinstance(leaf, tsh.SlotSharded):
            assert leaf.mesh is slices[1] and leaf.spec == sent.spec
    after = [s for leaf in tree_leaves(filler) for s in ici_plane._blocks(leaf)]
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(before, after))
    # the same blocks through exchange_plain, bit for bit
    srcs = [s for leaf in tree_leaves(src_tree) for s in ici_plane._blocks(leaf)]
    dsts = [torch.empty_like(s) for s in srcs]
    ici_plane.exchange_plain(srcs, dsts)
    got = [s for leaf in tree_leaves(out) for s in ici_plane._blocks(leaf)]
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(dsts, got))
    # specs that differ are not transfer-compatible; conform_specs re-lays
    # the tree out on the sender's own slice and counts the leaves it moved
    other = ici_plane.SliceInfo(slices[1], ((), (), (None, "model")))
    assert not ici_plane.transfer_compatible(src, other)
    conformed, moved = ici_plane.conform_specs(src_tree, slices[0], other.specs)
    assert moved == 1 and isinstance(conformed["e"], torch.Tensor) and conformed["w"] is src_tree["w"]
    flat = ici_plane.replicate_on_slice(src_tree, src)
    assert all(isinstance(x, torch.Tensor) for x in tree_leaves(flat))
    assert torch.equal(flat["w"], src_tree["w"].full())
    del rng


def _sharded_fleet(model_parallel: int, plane: str = "ici", protocol: str = "memory") -> list:
    """``examples/mnist.py``'s path, 2 Nodes on (1, model_parallel) slices
    of the CPU, full topology, 2 rounds of equal shards: the final params."""
    from p2pfl_tpu_torch.examples import mnist as example

    out = example.run(nodes=2, rounds=2, samples=256, batch_size=32, device="cpu", weights_plane=plane,
                      topology="full", timeout=60, model_parallel=model_parallel, protocol=protocol)
    return out["params"]


def test_sharded_gossip_nodes_over_the_ici_plane_equal_one_slot_nodes():
    """Two gossip Nodes whose learners sit on (1, 2) slices, the MLP rules:
    the ICI plane moved their per-slot shards with no fallback, fix-up or
    failed transfer, both end on one model, and that model is the one the
    same two Nodes on one-slot learners reach, bit for bit (FedAvg of two
    halves is exact in either order, as the one-slot planes' own test
    shows)."""
    sharded = _sharded_fleet(2)
    stats = ici.ici_stats()
    assert stats["shard_sends"] > 0 and stats["bytes_moved"] > 0
    assert stats["fallback_bytes"] == 0 and stats["align_violations"] == 0
    assert isinstance(sharded[0]["Dense_0"]["kernel"], tsh.SlotSharded)
    assert _bit_equal(sharded[0], sharded[1])
    ici.reset_ici_stats()
    one_slot = _sharded_fleet(1)
    assert _bit_equal(sharded[0], one_slot[0])


def test_sharded_nodes_over_grpc_bytes_equal_one_slot_nodes():
    """The byte path over gRPC: a sharded learner's placed leaves go on
    the wire whole (gathered), the receiver places the decode by its
    rules; the final model equals the one-slot Nodes' bit for bit."""
    sharded = _sharded_fleet(2, plane="bytes", protocol="grpc")
    one_slot = _sharded_fleet(1, plane="bytes", protocol="grpc")
    assert isinstance(sharded[1]["Dense_1"]["kernel"], tsh.SlotSharded)
    assert _bit_equal(sharded[0], one_slot[0]) and _bit_equal(sharded[0], sharded[1])


@pytest.mark.parametrize("mode", ["int8", "topk8"])
def test_sharded_nodes_under_a_codec_on_the_ici_plane(mode, monkeypatch):
    """int8 / topk8 on the ICI plane with sharded learners: the encode
    reads the gathered tensors, the decode is placed by the receiver's
    layout; no fix-up, no fallback but topk8's early
    ``anchor_round_mismatch`` ones (a peer's anchor of another round: the
    byte path's skip, by design), and one update through the plane's
    codec equals the byte path's decode bit for bit
    (``ici.move_codec_against_bytes``)."""
    from p2pfl_tpu_torch.learning.weights import ModelUpdate

    reasons = []
    real = ici._fallback
    monkeypatch.setattr(ici, "_fallback", lambda src, nei, reason: (reasons.append(reason), real(src, nei, reason)))
    Settings.WIRE_COMPRESSION = mode
    try:
        params = _sharded_fleet(2)
        stats = ici.ici_stats()
        assert stats["shard_sends"] > 0 and stats["align_violations"] == 0
        assert set(reasons) <= ({"anchor_round_mismatch"} if mode == "topk8" else set())
        assert isinstance(params[0]["Dense_0"]["kernel"], tsh.SlotSharded)
        slices = node_slices(submesh_federation_mesh(2, 2, devices=["cpu"] * 4))
        data = FederatedDataset.synthetic_mnist(n_train=64, n_test=16)
        a = TorchLearner(_port_model(_jax_model()), data, mesh=slices[0], partition_rules=MLP_RULES)
        b = TorchLearner(_port_model(_jax_model()), data, mesh=slices[1], partition_rules=MLP_RULES)
        a.fit()
        tag = "0:1"
        a.set_wire_anchor(b.get_parameters(), tag)
        b.set_wire_anchor(b.get_parameters(), tag)
        upd = ModelUpdate(a.get_parameters(), ["a"], 64, anchor=a.wire_anchor()[0], anchor_tag=tag)
        src = ici_plane.slice_info_of(a.get_parameters(), slices[0])
        dst = ici_plane.slice_info_of(b.get_parameters(), slices[1])
        got, want, moved, _ = ici.move_codec_against_bytes(upd, b.get_parameters(), src, dst, b, mode)
        assert moved > 0 and isinstance(got["Dense_0"]["kernel"], tsh.SlotSharded)
        assert got["Dense_0"]["kernel"].mesh is slices[1]
        assert _bit_equal(got, want)
    finally:
        Settings.WIRE_COMPRESSION = "none"


def test_sharded_nodes_fall_back_loudly_on_a_spec_mismatch():
    """A receiver whose learner is placed by other rules: the plane counts
    a fallback with its reason and the transport delivers; the receiver
    places what it got in its own layout."""
    from p2pfl_tpu_torch.learning.weights import ModelUpdate

    slices = node_slices(submesh_federation_mesh(2, 2, devices=["cpu"] * 4))
    data = FederatedDataset.synthetic_mnist(n_train=64, n_test=16)
    model = _port_model(_jax_model())
    a = TorchLearner(model, data, mesh=slices[0], partition_rules=MLP_RULES)
    b = TorchLearner(model, data, mesh=slices[1], partition_rules=((r"Dense_0/kernel", (None, "model")), (r".*", ())))
    info_a = ici_plane.slice_info_of(a.get_parameters(), slices[0])
    info_b = ici_plane.slice_info_of(b.get_parameters(), slices[1])
    assert info_a.specs != info_b.specs and not ici_plane.transfer_compatible(info_a, info_b)
    b.set_parameters(ModelUpdate(a.get_parameters(), ["a"], 1).params)
    assert b.params["Dense_1"]["kernel"].__class__ is torch.Tensor
    assert _bit_equal(b.params, a.params)


def test_placed_params_from_jax():
    """A JAX node's numpy params placed on a port slice: each placed
    leaf's blocks are the slot shards the JAX placement gives; back to JAX
    bit for bit."""
    from p2pfl_tpu.parallel.mesh import node_slices as jnode_slices
    from p2pfl_tpu.parallel.mesh import submesh_federation_mesh as jsubmesh
    from p2pfl_tpu.parallel.sharding import shard_tree as jshard_tree

    jparams = jax.tree.map(np.asarray, _jax_model().params)
    sl = node_slices(submesh_federation_mesh(1, 4, devices=["cpu"] * 4))[0]
    placed = placed_params_from_jax(jparams, sl, MLP_RULES)
    jsl = jnode_slices(jsubmesh(1, model_parallel=4, devices=jax.devices()[:4]))[0]
    jplaced = jshard_tree(jsl, jax.tree.map(jnp.asarray, jparams), MLP_RULES)
    jk = jplaced["Dense_1"]["kernel"]
    by_dev = {s.device: np.asarray(s.data) for s in jk.addressable_shards}
    for p, dev in enumerate(np.asarray(jsl.devices).flat):
        np.testing.assert_array_equal(placed["Dense_1"]["kernel"].shards[p].numpy(), by_dev[dev])
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(params_to_jax(placed))):
        np.testing.assert_array_equal(a, b)
