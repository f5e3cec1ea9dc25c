"""The port's partition-rule engine (``p2pfl_tpu_torch/parallel/sharding.py``)
and meshes against the JAX package's on the CPU.

Both engines see the same trees (numpy-made, or the same shapes): the
specs, the lint reports and their findings must be EQUAL; the port's
``SlotSharding.shard_shape`` must equal ``NamedSharding.shard_shape`` on
config 5's full tree at model_parallel 1/4/8 (shapes only: JAX's
``eval_shape`` against the port's meta-device tree, nothing allocated),
and the bytes a slot holds must equal what ``bench_suite.py``'s
1B projection computes; the block a slot holds must be, bit for bit, the
shard JAX puts on the device at that position (8 virtual CPU devices,
``tests/conftest.py``; the port's slots all name the CPU). No tolerance
applies here: every comparison is exact.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from p2pfl_tpu.parallel import mesh as jmesh
from p2pfl_tpu.parallel import sharding as jsh
from p2pfl_tpu_torch.learning.learner import adam, init_opt_state
from p2pfl_tpu_torch.models.transformer import TransformerConfig, init_params
from p2pfl_tpu_torch.ops.tree import tree_items, tree_leaves
from p2pfl_tpu_torch.parallel import mesh as tmesh
from p2pfl_tpu_torch.parallel import sharding as tsh
from p2pfl_tpu_torch.settings import Settings

MLP_RULES = (
    (r"Dense_0/kernel", (None, "model")),
    (r"Dense_1/kernel", ("model", None)),
    (r"Dense_2/kernel", (None, "model")),
    (r".*", ()),
)
CPU = ["cpu"]


def _np_tree(shapes: dict, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    out: dict = {}
    for path, shape in shapes.items():
        node = out
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = rng.normal(size=shape).astype(np.float32)
    return out


def _jax_tree(t):
    return jax.tree.map(jnp.asarray, t)


def _torch_tree(t):
    return jax.tree.map(torch.from_numpy, t)


def _jspecs(tree) -> dict:
    """JAX spec tree as ``{path: tuple}``."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {jsh._path_str(kp): tuple(s) for kp, s in flat}


def _tspecs(tree) -> dict:
    return {path: spec for path, spec in tree_items(tree)}


def _facts(report) -> tuple:
    return (
        list(report.unmatched), list(report.dead_rules), list(report.unknown_axes), list(report.indivisible),
        [(f.rule, f.message, f.severity.value, f.line, f.col) for f in report.findings()],
    )


def _jslice(m: int, d: int = 1):
    return jmesh.node_slices(jmesh.submesh_federation_mesh(1, m, d, devices=jax.devices()[: m * d]))[0]


def _tslice(m: int, d: int = 1):
    return tmesh.node_slices(tmesh.submesh_federation_mesh(1, m, d, devices=CPU * (m * d)))[0]


# ---- rule engine ----


def test_match_rules_first_match_wins_and_scalars_replicate():
    shapes = {"layer/attn/wq/kernel": (4, 8), "scale": ()}
    rules = ((r"attn/(wq|wk)/kernel", (None, "model")), (r"kernel", ("model", None)), (r".*", ()))
    t = _np_tree(shapes)
    js = _jspecs(jsh.match_partition_rules(rules, _jax_tree(t)))
    ts = _tspecs(tsh.match_partition_rules(rules, _torch_tree(t)))
    assert js == ts
    assert ts["layer/attn/wq/kernel"] == (None, Settings.MESH_MODEL_AXIS) and ts["scale"] == ()


def test_match_rules_unmatched_raises_and_replicate_mode():
    t = _np_tree({"odd_name": (4, 4)})
    rules = ((r"kernel", (None, "model")),)
    for engine, tree in ((jsh, _jax_tree(t)), (tsh, _torch_tree(t))):
        with pytest.raises(ValueError, match="no partition rule matches"):
            engine.match_partition_rules(rules, tree)
    js = _jspecs(jsh.match_partition_rules(rules, _jax_tree(t), on_unmatched="replicate"))
    ts = _tspecs(tsh.match_partition_rules(rules, _torch_tree(t), on_unmatched="replicate"))
    assert js == ts == {"odd_name": ()}


def test_lint_reports_dead_rules_unknown_axes_unmatched():
    t = _np_tree({"Dense_0/kernel": (8, 4), "Dense_0/bias": (4,), "odd": (2, 2)})
    rules = ((r"Dense_0/kernel", (None, "model")), (r"Dnse_0/kernel", ("model", None)), (r"bias", ("bogus_axis",)))
    jr = jsh.lint_partition_rules(rules, _jax_tree(t), jmesh.federation_mesh(devices=jax.devices()[:2]))
    tr = tsh.lint_partition_rules(rules, _torch_tree(t), tmesh.federation_mesh(devices=CPU * 2))
    assert _facts(jr) == _facts(tr)
    assert tr.unmatched == ["odd"] and tr.dead_rules == [r"Dnse_0/kernel"]
    assert ("bias", "bogus_axis") in tr.unknown_axes and not tr.ok()
    with pytest.raises(ValueError, match="fails lint"):
        tsh.check_partition_rules(rules, _torch_tree(t), tmesh.federation_mesh(devices=CPU * 2))


def test_lint_clean_set_and_indivisible_is_informational():
    rules = ((r"kernel", (None, "model")), (r".*", ()))
    for shapes, indivisible in (({"Dense_0/kernel": (8, 6), "Dense_0/bias": (3,)}, []),
                                ({"Dense_0/kernel": (8, 5), "Dense_0/bias": (3,)},
                                 [("Dense_0/kernel", Settings.MESH_MODEL_AXIS)])):
        t = _np_tree(shapes)
        jr = jsh.lint_partition_rules(rules, _jax_tree(t), _jslice(2))
        tr = tsh.lint_partition_rules(rules, _torch_tree(t), _tslice(2))
        assert _facts(jr) == _facts(tr)
        assert tr.ok() and tr.indivisible == indivisible
        # placement replicates the indivisible leaf instead of failing
        jspec = tuple(jsh.tree_shardings(_jslice(2), _jax_tree(t), rules)["Dense_0"]["kernel"].spec)
        tspec = tsh.tree_shardings(_tslice(2), _torch_tree(t), rules)["Dense_0"]["kernel"].spec
        assert jspec == tspec == ((None, Settings.MESH_MODEL_AXIS) if not indivisible else (None, None))


def test_tree_shardings_raises_on_unknown_axis_and_scalar_rules_stay_live():
    tm = tmesh.federation_mesh(devices=CPU * 2)
    with pytest.raises(ValueError, match="not in the mesh"):
        tsh.tree_shardings(tm, {"w": torch.zeros(4, 4)}, ((r"w", ("bogus_axis", None)),))
    t = _np_tree({"scale": (1,), "w": (8, 8)})
    rules = ((r"scale", ()), (r"w", ("model", None)))
    jr = jsh.lint_partition_rules(rules, _jax_tree(t), jmesh.federation_mesh(devices=jax.devices()[:2]))
    tr = tsh.lint_partition_rules(rules, _torch_tree(t), tm)
    assert _facts(jr) == _facts(tr) and tr.dead_rules == []
    tsh.check_partition_rules(rules, _torch_tree(t), tm)  # must not raise


def test_lint_tuple_axis_product_divisibility_matches_placement():
    rules = ((r"w", (("data", "model"), None)),)
    for shape, indivisible in (((2, 4), [("w", "data+model")]), ((4, 4), [])):
        t = _np_tree({"w": shape})
        jr = jsh.lint_partition_rules(rules, _jax_tree(t), _jslice(2, 2))
        tr = tsh.lint_partition_rules(rules, _torch_tree(t), _tslice(2, 2))
        assert _facts(jr) == _facts(tr) and tr.indivisible == indivisible
        jspec = tuple(jsh.tree_shardings(_jslice(2, 2), _jax_tree(t), rules)["w"].spec)
        tspec = tsh.tree_shardings(_tslice(2, 2), _torch_tree(t), rules)["w"].spec
        assert jspec == tspec


def test_opt_state_places_by_the_same_rules():
    rules = MLP_RULES[:1] + ((r".*", ()),)
    t = {"Dense_0": {"kernel": np.ones((8, 4), np.float32), "bias": np.zeros((4,), np.float32)}}
    jopt = jax.eval_shape(optax.adam(1e-3).init, _jax_tree(t))
    jspecs = jsh.tree_shardings(_jslice(2), jopt, rules)
    assert tuple(jspecs[0].mu["Dense_0"]["kernel"].spec) == (None, Settings.MESH_MODEL_AXIS)
    sm = _tslice(2)
    placed = tsh.shard_tree(sm, _torch_tree(t), rules)
    opt = init_opt_state(adam(1e-3), placed)
    # the moments are placed like the params they mirror, as the rules
    # place the moments' own paths (mu/Dense_0/kernel); the step count is a
    # scalar and replicates
    rule_specs = tsh.tree_shardings(sm, opt, rules)
    assert opt.mu["Dense_0"]["kernel"].spec == rule_specs.mu["Dense_0"]["kernel"].spec == (None, "model")
    assert rule_specs.count.spec == () and isinstance(opt.count, torch.Tensor)
    assert tuple(jspecs[0].count.spec) == ()


# ---- mesh construction ----


def test_federation_mesh_raises_on_stranded_devices():
    for make, devs in ((jmesh.federation_mesh, jax.devices()), (tmesh.federation_mesh, CPU * 8)):
        with pytest.raises(ValueError, match="strand"):
            make(n_nodes=3, devices=devs)
        assert make(n_nodes=3, devices=devs[:3]).shape[Settings.MESH_NODES_AXIS] == 3
        assert make(n_nodes=64, devices=devs).shape[Settings.MESH_NODES_AXIS] == 8


def test_submesh_federation_mesh_and_node_slices():
    gm = tmesh.submesh_federation_mesh(2, model_parallel=2, data_parallel=2, devices=CPU * 8)
    jgm = jmesh.submesh_federation_mesh(2, model_parallel=2, data_parallel=2)
    assert dict(gm.shape) == dict(jgm.shape) == {
        Settings.MESH_NODES_AXIS: 2, Settings.MESH_DATA_AXIS: 2, Settings.MESH_MODEL_AXIS: 2,
    }
    slices = tmesh.node_slices(gm)
    assert len(slices) == 2
    assert dict(slices[0].shape) == {Settings.MESH_DATA_AXIS: 2, Settings.MESH_MODEL_AXIS: 2}
    # disjoint slot ownership although every slot names the CPU
    assert not (slices[0].slot_keys & slices[1].slot_keys)
    with pytest.raises(ValueError, match="exactly"):
        tmesh.submesh_federation_mesh(3, model_parallel=3, devices=CPU * 8)  # 9 slots asked, 8 given


def test_expert_pipeline_and_sharded_fleet_meshes_run():
    """Expert and pipeline parallelism run (the SPMD federations' meshes):
    an expert-parallel federation places its node-stacked leaves by the
    node-shifted rules, and a GPipe federation builds its stages. The
    sharded megafleet engine runs on two CPU slots; a card fleet asked for
    more shards than the visible cards raises."""
    from p2pfl_tpu_torch import DeviceUnavailableError
    from p2pfl_tpu_torch.federation.megafleet import FleetSpec, MegaFleet
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.models.transformer import tiny_transformer
    from p2pfl_tpu_torch.parallel import PipelineFederation, SpmdLmFederation

    cfg = TransformerConfig(vocab_size=64, dim=32, n_layers=2, n_heads=2, n_kv_heads=1, ffn_hidden=64, lora_rank=0)
    data = FederatedDataset.synthetic_lm(vocab_size=64, seq_len=16, n_train=32, n_test=8)
    model = tiny_transformer(seq_len=16, cfg=cfg, device="cpu")
    fed = SpmdLmFederation.from_dataset(model, data, n_nodes=2, expert_parallel=2, batch_size=4, vote=False,
                                        device="cpu", mesh=tmesh.federation_mesh(2, 2, devices=CPU * 4))
    wq = dict(tree_items(fed.params))["layer_0/attn/wq/kernel"]
    assert wq.spec == (Settings.MESH_NODES_AXIS, None, Settings.MESH_MODEL_AXIS)
    assert tuple(wq.shards[0].shape) == (1, 32, 16)
    pipe = PipelineFederation(model, [data], mesh=tmesh.pipeline_mesh(2, devices=CPU * 2), batch_size=4, device="cpu")
    assert pipe.stage_devices == [torch.device("cpu")] * 2
    spec = FleetSpec.synth(40, seed=1905, dim=4)
    fleet = MegaFleet(spec, shards=2, device="cpu")
    assert fleet.mesh.size == 2 and fleet.run().merges > 0
    with pytest.raises((ValueError, DeviceUnavailableError)):
        MegaFleet(spec, shards=torch.cuda.device_count() + 1)


# ---- placement: shard shapes and blocks against JAX ----


def _config5(lora: bool) -> TransformerConfig:
    kw = dict(lora_rank=8, lora_mlp=True) if lora else dict(lora_rank=0)
    return TransformerConfig(vocab_size=4096, dim=2048, n_heads=32, n_kv_heads=4, n_layers=22, ffn_hidden=5632, **kw)


@pytest.fixture(scope="module")
def config5_trees():
    from p2pfl_tpu.models.transformer import CausalLM
    from p2pfl_tpu.models.transformer import TransformerConfig as JaxConfig
    from p2pfl_tpu.models.transformer import resolve_attention

    out = {}
    for lora in (True, False):
        kw = dict(lora_rank=8, lora_mlp=True) if lora else dict(lora_rank=0)
        jcfg = JaxConfig(vocab_size=4096, dim=2048, n_heads=32, n_kv_heads=4, n_layers=22, ffn_hidden=5632, **kw)
        module = CausalLM(jcfg, resolve_attention("dense"))
        jtree = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros((1, 1024), jnp.int32))["params"]
        out[lora] = (jtree, init_params(_config5(lora), device="meta"))
    return out


@pytest.mark.parametrize("lora", [True, False])
@pytest.mark.parametrize("m", [1, 4, 8])
def test_shard_shapes_match_jax_on_the_config5_tree(config5_trees, lora, m):
    jtree, ttree = config5_trees[lora]
    jflat = {jsh._path_str(kp): x for kp, x in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    tflat = dict(tree_items(ttree))
    assert set(jflat) == set(tflat)
    assert all(x.device.type == "meta" for x in tflat.values())  # nothing allocated
    jsl, tsl = _jslice(m), _tslice(m)
    jsd = {jsh._path_str(kp): s for kp, s in jax.tree_util.tree_flatten_with_path(
        jsh.tree_shardings(jsl, jtree, jsh.DEFAULT_TRANSFORMER_RULES), is_leaf=lambda x: hasattr(x, "spec"))[0]}
    tsd = dict(tree_items(tsh.tree_shardings(tsl, ttree)))
    for path, leaf in tflat.items():
        assert tsd[path].spec == tuple(jsd[path].spec), path
        assert tsd[path].shard_shape(tuple(leaf.shape)) == jsd[path].shard_shape(tuple(jflat[path].shape)), path
    # params + Adam moments a slot: the port's accounting
    per_slot = tsh.shard_bytes_accounting(tsl, ttree) * 3 + 4  # params, mu, nu (fp32), count int32
    opt = init_opt_state(adam(1e-3), ttree)
    assert per_slot == tsh.shard_bytes_accounting(tsl, ttree) + tsh.shard_bytes_accounting(tsl, opt)
    if lora:
        import bench_suite

        want = bench_suite._sharded_1b_hbm_projection()
        assert per_slot == want[f"bytes_per_device_m{m}"]
        assert sum(math.prod(x.shape) for x in tflat.values()) == want["n_params"]


def test_placed_blocks_are_jax_device_shards():
    """Slot p's block is the shard JAX puts on the device at position p,
    for specs over one axis, over the data axis, and over a tuple of
    axes (data major)."""
    shapes = {"a": (8, 12), "b": (16, 4), "c": (8, 6), "d": (5,)}
    rules = ((r"^a$", (None, "model")), (r"^b$", (("data", "model"), None)), (r"^c$", ("data", "model")),
             (r".*", ()))
    t = _np_tree(shapes, seed=3)
    jsl, tsl = _jslice(2, 2), _tslice(2, 2)
    jplaced = jsh.shard_tree(jsl, _jax_tree(t), rules)
    tplaced = tsh.shard_tree(tsl, _torch_tree(t), rules)
    devices = list(np.asarray(jsl.devices).flat)
    for path in ("a", "b", "c"):
        jarr, tleaf = jplaced[path], tplaced[path]
        assert isinstance(tleaf, tsh.SlotSharded) and tleaf.spec == tuple(jarr.sharding.spec)
        by_dev = {s.device: np.asarray(s.data) for s in jarr.addressable_shards}
        for p, dev in enumerate(devices):
            np.testing.assert_array_equal(tleaf.shards[p].numpy(), by_dev[dev])
        np.testing.assert_array_equal(tleaf.full().numpy(), t[path])
    assert isinstance(tplaced["d"], torch.Tensor)  # replicated: one whole tensor


def test_placed_leaf_round_trips_and_counts_its_bytes():
    sl = _tslice(4)
    x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    leaf = tsh.SlotSharded.place(x, tsh.SlotSharding(sl, (None, "model")))
    assert [tuple(s.shape) for s in leaf.shards] == [(8, 3)] * 4 and leaf.nbytes == x.numel() * 4
    assert torch.equal(leaf.full(), x)
    assert tsh.SlotSharding(sl, (None, "model")).global_shape((8, 3)) == (8, 12)
    with pytest.raises(ValueError, match="divisible"):
        tsh.SlotSharding(sl, ("model",)).shard_shape((6,))
    flat = tsh.shard_flat({"w": leaf, "b": torch.zeros(2)})
    assert sorted(flat["w"]) == ["#0", "#1", "#2", "#3"]
    back = tsh.from_shard_flat(flat, {"w": leaf, "b": torch.zeros(2)})
    assert back["w"].shards == leaf.shards
    counts = tsh.slot_bytes({"w": leaf, "b": torch.zeros(2)})
    assert set(counts.values()) == {8 * 3 * 4 + 2 * 4}  # a shard + the replicated bias, on every slot
    assert [tuple(x.shape) for x in tree_leaves(tsh.gather_tree({"w": leaf}))] == [(8, 12)]
