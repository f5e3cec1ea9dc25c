"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they need an NVIDIA GPU with ``nvcc`` (Hopper, sm_90a)
and skip elsewhere. Run them on the card under a timeout (a lost barrier
phase hangs a kernel, and the back-to-back tests are there to provoke it):

    timeout 900 python -m pytest -m cuda tests/test_torch_cuda_kernels.py

``chip_smoke.py`` checks the same kernels at the main path's shape.
"""

import pytest
import torch

import chip_smoke
from p2pfl_tpu_torch.ops import _kernels
from p2pfl_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

#: every kernel-against-plain check runs on the inputs of each seed
SEEDS = chip_smoke.SEEDS
#: the head widths the flash kernels are built for
WIDTHS = (32, 64, 128)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(cuda, b=2, h=4, t=128, d=64, n=4, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return [
        torch.randn((b, h, t, d), generator=gen, device=cuda).to(torch.bfloat16) for _ in range(n)
    ]


def _close(got, want, terms=None):
    """chip_smoke's limit: same rounding points on both sides, fp32 sums in
    other orders (and bulk reductions for the fused dQ), so each element is
    held to RTOL·|ref| plus RTOL of the reference's RMS, plus TERMS_TOL of
    the sum of the magnitudes of its terms where ``terms`` gives them (one
    term's bf16 rounding may differ on the two sides, however much the
    terms cancel)."""
    assert chip_smoke.check(got, want, terms)[2] <= 1


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("causal", [True, False])
def test_kernels_match_plain(cuda, causal, d):
    for seed in SEEDS:
        q, k, v, do = _inputs(cuda, d=d, seed=seed)
        o, lse = _kernels.flash_fwd(q, k, v, causal)
        o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal, 64, 64)
        _close(o, o_ref, fa.flash_fwd_magnitude(q, k, v, causal, 64, 64))
        assert (lse - lse_ref).abs().max().item() <= 1e-4
        delta = (do.float() * o.float()).sum(-1)
        args = (q, k, v, do, lse, delta, causal)
        want = fa.flash_bwd_fused_plain(*args, 64, 64)
        for got_fused, got_split, ref, terms in zip(
            _kernels.flash_bwd_fused(*args), _kernels.flash_bwd_split(*args), want,
            fa.flash_bwd_magnitude(*args, 64, 64),
        ):
            _close(got_fused, ref, terms)
            _close(got_split, ref, terms)
    torch.cuda.synchronize()


@pytest.mark.parametrize("bwd_mode", ["fused", "split"])
def test_autograd_on_card_matches_cpu_plain(cuda, bwd_mode):
    q, k, v, g = (x.transpose(1, 2) for x in _inputs(cuda, t=192))
    cfg = fa.FlashConfig(64, 64, bwd_mode=bwd_mode)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        xs = [x.detach().to(dev).requires_grad_(True) for x in (q, k, v)]
        out = fa.flash_attention(*xs, True, cfg)
        out.backward(g.to(dev))
        grads.append([out.detach().cpu()] + [x.grad.cpu() for x in xs])
    for got, want in zip(*grads):
        _close(got, want)


# the forward's edges (b, h, T, causal): one 64-row tile (a block's second
# warpgroup lies past T), a half 128-row tile, a long full sweep, one head
# and an odd number of heads
FWD_SHAPES = {
    "t64": (2, 4, 64, True), "t192": (2, 4, 192, True), "t192_full": (2, 4, 192, False),
    "t4096_full": (1, 2, 4096, False), "bh1": (1, 1, 256, True), "bh_odd": (1, 3, 320, True),
}


def _check_fwd(o, lse, o_ref, lse_ref, terms, dead=0):
    _close(o, o_ref, terms)
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    if dead:  # rows that see nothing: O exactly 0, lse exactly the sentinel
        assert torch.count_nonzero(o[..., :dead, :]) == 0 and bool((lse[..., :dead] == -1e30).all())


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("shape", list(FWD_SHAPES))
def test_forward_edges_match_plain(cuda, shape, d):
    b, h, t, causal = FWD_SHAPES[shape]
    for seed in SEEDS:
        q, k, v = _inputs(cuda, b=b, h=h, t=t, d=d, n=3, seed=seed)
        _check_fwd(*_kernels.flash_fwd(q, k, v, causal), *fa.flash_fwd_plain(q, k, v, causal, 64, 64),
                   fa.flash_fwd_magnitude(q, k, v, causal, 64, 64))
    torch.cuda.synchronize()


# ring hops at T 192 (a half 128-row tile): the five cases of OFFSETS, and
# "split", where the first block's first warpgroup streams no tile while
# the second streams one in which none of its rows sees a key
FWD_OFFSETS = {
    "diagonal": (192, 192), "visible": (384, 0), "masked": (0, 192), "offtile": (192 + 32, 192 + 8),
    "offtile_late": (192, 192 + 32), "split": (0, 128),
}


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("case", list(FWD_OFFSETS))
def test_offset_forward_half_tile_matches_plain(cuda, case, d):
    q_off, k_off = FWD_OFFSETS[case]
    for seed in SEEDS:
        q, k, v = _inputs(cuda, b=1, h=3, t=192, d=d, n=3, seed=seed)
        _check_fwd(*_kernels.flash_fwd_offs(q, k, v, q_off, k_off),
                   *fa.flash_fwd_offs_plain(q, k, v, q_off, k_off, 64, 64),
                   fa.flash_fwd_offs_magnitude(q, k, v, q_off, k_off, 64, 64), dead=min(max(k_off - q_off, 0), 192))
    torch.cuda.synchronize()


# ---- the fused backward (kernels 2 and 6, csrc/flash_bwd_sm90.cu) at the
# forward's edges: blocks of 128 k rows whose second warpgroup lies past T,
# a long full sweep, one head and an odd number of heads ----


def _check_backward_edges(cuda, shape, backward, d):
    b, h, t, causal = FWD_SHAPES[shape]
    for seed in SEEDS:
        q, k, v, do = _inputs(cuda, b=b, h=h, t=t, d=d, seed=seed)
        o, lse = _kernels.flash_fwd(q, k, v, causal)
        delta = (do.float() * o.float()).sum(-1)
        args = (q, k, v, do, lse, delta, causal)
        for got, ref, terms in zip(backward(*args), fa.flash_bwd_fused_plain(*args, 64, 64),
                                   fa.flash_bwd_magnitude(*args, 64, 64)):
            _close(got, ref, terms)
    torch.cuda.synchronize()


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("shape", list(FWD_SHAPES))
def test_fused_backward_edges_match_plain(cuda, shape, d):
    _check_backward_edges(cuda, shape, _kernels.flash_bwd_fused, d)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("shape", list(FWD_SHAPES))
def test_split_backward_edges_match_plain(cuda, shape, d):
    """Kernels 3 and 4 (csrc/flash_bwd_dq_sm90.cu and the dK/dV pass of
    csrc/flash_bwd_sm90.cu) at the forward's edges: blocks of 128 rows
    whose second warpgroup lies past T, a long full sweep, one head and an
    odd number of heads."""
    _check_backward_edges(cuda, shape, _kernels.flash_bwd_split, d)


def _check_offset_backward_half_tile(cuda, case, backward, d):
    """At T 192 with a nonzero lse cotangent: dQ rows that no k tile
    reaches and dK/dV rows of keys that no q row sees are exact zeros (all
    three of a fully masked hop)."""
    q_off, k_off = FWD_OFFSETS[case]
    t = 192
    for seed in SEEDS:
        q, k, v, do = _inputs(cuda, b=1, h=3, t=t, d=d, seed=seed)
        o, lse = _kernels.flash_fwd_offs(q, k, v, q_off, k_off)
        delta = (do.float() * o.float()).sum(-1)
        gen = torch.Generator(device=cuda).manual_seed(100 + seed)
        glse = torch.randn(lse.shape, generator=gen, device=cuda)
        glse = torch.where(lse <= -0.5e30, torch.zeros_like(glse), glse)
        args = (q, k, v, do, lse, delta, glse, q_off, k_off)
        dq, dk, dv = backward(*args)
        for got, ref, terms in zip((dq, dk, dv), fa.flash_bwd_fused_offs_plain(*args, 64, 64),
                                   fa.flash_bwd_offs_magnitude(*args, 64, 64)):
            _close(got, ref, terms)
        dead = min(max(k_off - q_off, 0), t)  # leading q rows that see nothing
        seen = min(max(q_off + t - k_off, 0), t)  # keys some q row sees
        assert torch.count_nonzero(dq[..., :dead, :]) == 0
        assert torch.count_nonzero(dk[..., seen:, :]) == 0 and torch.count_nonzero(dv[..., seen:, :]) == 0
        if case == "masked":
            assert seen == 0 and dead == t
    torch.cuda.synchronize()


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("case", list(FWD_OFFSETS))
def test_offset_fused_backward_half_tile_matches_plain(cuda, case, d):
    """Kernel 6."""
    _check_offset_backward_half_tile(cuda, case, _kernels.flash_bwd_fused_offs, d)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("case", list(FWD_OFFSETS))
def test_offset_split_backward_half_tile_matches_plain(cuda, case, d):
    """Kernels 7 and 8."""
    _check_offset_backward_half_tile(cuda, case, _kernels.flash_bwd_split_offs, d)


#: the back-to-back tests' cases at chip_smoke's T 1024: the fully masked
#: hop (no work item has a tile: every consumer takes the zero-work path),
#: the diagonal hop, a hop whose first k rows no q row sees, and kernels
#: 3/4 causal and full at chip_smoke's 4 x 32 heads
B2B_CASES = {"masked": (0, 1024), "diagonal": (1024, 1024), "split": (0, 128), "causal": None, "full": None}


def _back_to_back(cuda, case, backward, backward_offs, dq_exact: bool, d: int = 64):
    """chip_smoke's ``back_to_back`` (B2B_CALLS launches queued, then 20
    behind sleep kernels, each call against the first) on one case's
    inputs: → the differing elements per output."""
    offs = B2B_CASES[case]
    q, k, v, do = _inputs(cuda, b=2 if offs else 4, h=32, t=1024, d=d)
    if offs is None:
        causal = case == "causal"
        o, lse = _kernels.flash_fwd(q, k, v, causal)
        args = (q, k, v, do, lse, (do.float() * o.float()).sum(-1), causal)
        call = lambda: backward(*args)  # noqa: E731
    else:
        o, lse = _kernels.flash_fwd_offs(q, k, v, *offs)
        args = (q, k, v, do, lse, (do.float() * o.float()).sum(-1), torch.zeros_like(lse), *offs)
        call = lambda: backward_offs(*args)  # noqa: E731
    return chip_smoke.back_to_back(call, dq_exact)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("case", ["masked", "diagonal", "split"])
def test_fused_backward_back_to_back_calls_agree(cuda, case, d):
    """Kernels 2 and 6 hand out their work items and buffers without a
    lost barrier phase: every call's dK and dV equal the first call's bit
    for bit, and its dQ (summed through bulk reductions in no fixed order)
    is within the limit of the first call's."""
    bad = _back_to_back(cuda, case, _kernels.flash_bwd_fused, _kernels.flash_bwd_fused_offs, dq_exact=False, d=d)
    assert bad == [0, 0, 0]


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("case", list(B2B_CASES))
def test_split_backward_back_to_back_calls_agree(cuda, case, d):
    """The same for kernels 3/4 ("causal", "full") and 7/8: the dK/dV pass
    hands out work items from a counter like the fused backward, and every
    output has one summation order, so all calls agree bit for bit."""
    bad = _back_to_back(cuda, case, _kernels.flash_bwd_split, _kernels.flash_bwd_split_offs, dq_exact=True, d=d)
    assert bad == [0, 0, 0]


def _drive_launches(cuda, attn: str, seq: int, nodes: int, bwd_mode: str = "auto") -> dict:
    """Launch counts of one chip_smoke drive (run_round + run_fused(1) +
    evaluate) of a 22-layer model at a narrow width (head dim 64)."""
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.models.transformer import TransformerConfig, tiny_transformer
    from p2pfl_tpu_torch.parallel.mesh import federation_mesh
    from p2pfl_tpu_torch.parallel.spmd_lora import SpmdLoraFederation

    cfg = TransformerConfig(vocab_size=256, dim=128, n_heads=2, n_kv_heads=1, n_layers=22,
                            ffn_hidden=256, lora_rank=4, lora_mlp=True, scan_layers=True,
                            flash_config=None if bwd_mode == "auto" else fa.FlashConfig(bwd_mode=bwd_mode))
    data = FederatedDataset.synthetic_lm(vocab_size=256, seq_len=seq, n_train=nodes * 2,
                                         n_test=nodes * 2, shift_frac=0.15)
    mesh = federation_mesh(model_parallel=4, devices=[cuda] * 4) if attn == "ring_flash" else None
    model = tiny_transformer(seq_len=seq, seed=0, cfg=cfg, attn=attn, mesh=mesh, device=cuda)
    _kernels.reset_launches()
    fed = SpmdLoraFederation.from_dataset(model, data, n_nodes=nodes, batch_size=1, vote=False,
                                          seed=3, device=cuda)
    fed.run_round()
    fed.run_fused(rounds=1)
    fed.evaluate()
    torch.cuda.synchronize()
    return dict(_kernels.LAUNCHES)


def test_drives_launch_the_fused_backward(cuda):
    """The main drive's 22 layers x 4 steps make 88 kernel-2 launches; the
    ring drive's 22 layers x 16 hops x 4 steps 1408 kernel-6 launches."""
    main = _drive_launches(cuda, "flash", 1024, 4)
    assert main["flash_bwd_dkvq"] == 88 and main["flash_bwd_dkvq_offs"] == 0
    ring = _drive_launches(cuda, "ring_flash", 4096, 2)
    assert ring["flash_bwd_dkvq_offs"] == 1408 and ring["flash_bwd_dkvq"] == 0


def test_drives_launch_the_split_backward(cuda):
    """With ``bwd_mode="split"`` the same drives make 88 launches each of
    kernels 3 and 4, and 1408 each of kernels 7 and 8, and none of the
    fused backward."""
    main = _drive_launches(cuda, "flash", 1024, 4, bwd_mode="split")
    assert main["flash_bwd_dq"] == main["flash_bwd_dkv"] == 88 and main["flash_bwd_dkvq"] == 0
    ring = _drive_launches(cuda, "ring_flash", 4096, 2, bwd_mode="split")
    assert ring["flash_bwd_dq_offs"] == ring["flash_bwd_dkv_offs"] == 1408
    assert ring["flash_bwd_dkvq_offs"] == 0 and ring["flash_bwd_dq"] == ring["flash_bwd_dkv"] == 0


def test_launch_counts_and_refusals(cuda):
    q, k, v, _ = _inputs(cuda)
    _kernels.reset_launches()
    _kernels.flash_fwd(q, k, v, True)
    assert _kernels.LAUNCHES["flash_fwd"] == 1
    assert _kernels.LAUNCHES_BY_WIDTH["flash_fwd"] == {32: 0, 64: 1, 128: 0}
    with pytest.raises(TypeError):
        _kernels.flash_fwd(q.float(), k.float(), v.float(), True)
    with pytest.raises(ValueError, match="multiple"):
        _kernels.flash_fwd(q[:, :, :100].contiguous(), k[:, :, :100].contiguous(), v[:, :, :100].contiguous(), True)
    # a width that is not built (96) raises; it never runs the plain version
    with pytest.raises(ValueError, match="head_dim"):
        _kernels.flash_fwd(*(torch.cat([x, x[..., :32]], -1) for x in (q, k, v)), True)
    o96 = torch.empty((2, 4, 128, 96), dtype=torch.bfloat16, device=cuda)
    assert _kernels._load().p2p_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o96.data_ptr(),
                                          o96.data_ptr(), 8, 128, 96, 1, _kernels._stream()) == -1
    assert _kernels.flash_fwd_smem_bytes(96) == -1
    with pytest.raises(ValueError, match="contiguous"):
        _kernels.flash_fwd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), True)
    assert _kernels.LAUNCHES["flash_fwd"] == 1


# (q_off, k_off) of one ring hop at T 128: diagonal, fully visible, fully
# masked, and two off-tile pairs whose mask cuts through the 64-row tiles:
# in "offtile" every row sees key 0; in "offtile_late" (q_off < k_off) rows
# 0-31 see nothing inside the k tile their q tile visits, which runs the
# kernels' sentinel guard
OFFSETS = {
    "diagonal": (128, 128), "visible": (256, 0), "masked": (0, 128), "offtile": (128 + 32, 128 + 8),
    "offtile_late": (128, 128 + 32),
}


@pytest.mark.parametrize("case", list(OFFSETS))
def test_offset_kernels_match_plain(cuda, case):
    q_off, k_off = OFFSETS[case]
    q, k, v, do = _inputs(cuda)
    o, lse = _kernels.flash_fwd_offs(q, k, v, q_off, k_off)
    o_ref, lse_ref = fa.flash_fwd_offs_plain(q, k, v, q_off, k_off, 64, 64)
    _close(o, o_ref, fa.flash_fwd_offs_magnitude(q, k, v, q_off, k_off, 64, 64))
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    dead = min(max(k_off - q_off, 0), q.shape[2])  # leading rows that see nothing
    if dead:
        assert torch.count_nonzero(o[..., :dead, :]) == 0 and bool((lse[..., :dead] == -1e30).all())
    delta = (do.float() * o.float()).sum(-1)
    gen = torch.Generator(device=cuda).manual_seed(1)
    glse = torch.randn(lse.shape, generator=gen, device=cuda)
    glse = torch.where(lse <= -0.5e30, torch.zeros_like(glse), glse)
    args = (q, k, v, do, lse, delta, glse, q_off, k_off)
    for got_fused, got_split, ref, terms in zip(
        _kernels.flash_bwd_fused_offs(*args), _kernels.flash_bwd_split_offs(*args),
        fa.flash_bwd_fused_offs_plain(*args, 64, 64), fa.flash_bwd_offs_magnitude(*args, 64, 64),
    ):
        _close(got_fused, ref, terms)
        _close(got_split, ref, terms)
    torch.cuda.synchronize()


@pytest.mark.parametrize("bwd_mode", ["fused", "split"])
def test_ring_flash_on_card_matches_cpu_plain(cuda, bwd_mode):
    """ring_attention(impl="flash") with 4 shards on one card against the
    same ring on the CPU's plain versions, forward and gradients."""
    from p2pfl_tpu_torch.ops.attention import ring_attention
    from p2pfl_tpu_torch.parallel.mesh import federation_mesh

    q, k, v, g = (x.transpose(1, 2) for x in _inputs(cuda, t=512))
    cfg = fa.FlashConfig(64, 64, bwd_mode=bwd_mode)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        mesh = federation_mesh(model_parallel=4, devices=[dev] * 4)
        xs = [x.detach().to(dev).requires_grad_(True) for x in (q, k, v)]
        _kernels.reset_launches()
        out = ring_attention(*xs, mesh, "model", impl="flash", flash_config=cfg)
        out.backward(g.to(dev))
        if dev.type == "cuda":
            assert _kernels.LAUNCHES["flash_fwd_offs"] == 16
            bwd = ["flash_bwd_dkvq_offs"] if bwd_mode == "fused" else ["flash_bwd_dq_offs", "flash_bwd_dkv_offs"]
            assert all(_kernels.LAUNCHES[name] == 16 for name in bwd)
        grads.append([out.detach().cpu()] + [x.grad.cpu() for x in xs])
    for got, want in zip(*grads):
        _close(got, want)


def test_offset_wrappers_refuse_bad_offsets(cuda):
    q, k, v, _ = _inputs(cuda)
    with pytest.raises(ValueError, match="offsets"):
        _kernels.flash_fwd_offs(q, k, v, -1, 0)


# ---- kernel 9: the ICI plane's shard transfer (bit-exact, any dtype) ----


def _exchange_tree(cuda, name):
    """The trees of chip_smoke's exchange phase: the MLP's fp32 leaves, a
    bf16 tree, odd byte counts at unaligned offsets (destinations half
    co-misaligned, half whole allocations), the config-5 model's bf16
    weight shapes."""
    from p2pfl_tpu_torch.models.transformer import TransformerConfig, init_params
    from p2pfl_tpu_torch.models.vision import mlp
    from p2pfl_tpu_torch.ops.tree import tree_leaves

    gen = torch.Generator(device=cuda).manual_seed(9)
    if name == "mlp_fp32":
        srcs = tree_leaves(mlp(seed=0, device=cuda).params)
    elif name == "bf16":
        srcs = [torch.randn(s, generator=gen, device=cuda).to(torch.bfloat16) for s in ((4096, 2048), (8, 2048), (3, 5, 7))]
    elif name == "odd_unaligned":
        flat = torch.randint(0, 256, (1 << 20,), generator=gen, device=cuda, dtype=torch.uint8)
        spans = [(1, 1001), (3 + 4096, 17), (5 + 8192, 65537), (16 + 200000, 15), (7 + 300000, 123457)]
        shadow = torch.empty_like(flat)
        srcs = [flat[o:o + n] for o, n in spans] + [
            flat[600002:600002 + 666].view(torch.bfloat16), flat[700012:700012 + 3996].view(torch.float32)
        ]
        return srcs, [shadow[o:o + n] for o, n in spans] + [torch.empty_like(s) for s in srcs[len(spans):]]
    else:
        cfg = TransformerConfig(vocab_size=4096, dim=2048, n_heads=32, n_kv_heads=4, n_layers=22,
                                ffn_hidden=5632, lora_rank=8, lora_mlp=True)
        srcs = [x.to(torch.bfloat16) for x in tree_leaves(init_params(cfg, seed=0, device=cuda))]
    return srcs, [torch.empty_like(s) for s in srcs]


def _bits(t):
    return t.reshape(-1).view(torch.uint8)


@pytest.mark.parametrize("tree", ["mlp_fp32", "bf16", "odd_unaligned", "config5_bf16"])
def test_ici_exchange_matches_plain_bit_exact(cuda, tree):
    from p2pfl_tpu_torch.parallel.ici_plane import exchange_plain

    srcs, dsts = _exchange_tree(cuda, tree)
    refs = [torch.empty_like(d) for d in dsts]
    _kernels.reset_launches()
    _kernels.ici_exchange(srcs, dsts)
    exchange_plain(srcs, refs)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["ici_exchange"] == 1  # one launch for the whole tree
    for s, d, r in zip(srcs, dsts, refs):
        assert torch.equal(_bits(d), _bits(r)) and torch.equal(_bits(d), _bits(s))


def test_shard_transfer_between_slots_of_one_card(cuda):
    """Two nodes' slots of one card: the transfer launches kernel 9 once,
    lands in fresh buffers, and leaves the filler unwritten."""
    from p2pfl_tpu_torch.models.vision import mlp
    from p2pfl_tpu_torch.ops.tree import tree_leaves
    from p2pfl_tpu_torch.parallel import ici_plane
    from p2pfl_tpu_torch.parallel.mesh import node_slices, submesh_federation_mesh

    a, b = node_slices(submesh_federation_mesh(2, devices=[cuda, cuda]))
    tree, filler = mlp(seed=0, device=cuda).params, mlp(seed=1, device=cuda).params
    kept = [x.clone() for x in tree_leaves(filler)]
    src, dst = ici_plane.slice_info_of(tree, a), ici_plane.slice_info_of(filler, b)
    _kernels.reset_launches()
    out = ici_plane.shard_transfer(tree, filler, src, dst)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["ici_exchange"] == 1
    for x, y, f, k in zip(tree_leaves(tree), tree_leaves(out), tree_leaves(filler), kept):
        assert torch.equal(_bits(x), _bits(y)) and y.data_ptr() != x.data_ptr()
        assert torch.equal(f, k)


def test_ici_exchange_refusals(cuda):
    x = torch.arange(10.0, device=cuda)
    _kernels.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.ici_exchange([x], [torch.empty(10)])
    with pytest.raises(ValueError):
        _kernels.ici_exchange([x], [torch.empty(11, device=cuda)])
    with pytest.raises(ValueError, match="contiguous"):
        _kernels.ici_exchange([x.view(2, 5).t()], [torch.empty(5, 2, device=cuda)])
    _kernels.ici_exchange([x[:0]], [torch.empty(0, device=cuda)])  # nothing to move: no launch
    assert _kernels.LAUNCHES["ici_exchange"] == 0


# ---- kernel 9 across two cards (peer stores; needs a machine with >= 2) ----


@pytest.fixture
def two_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (kernel 9's peer stores)")
    return torch.device("cuda", 0), torch.device("cuda", 1)


def test_ici_exchange_across_two_cards(two_cards):
    """Sources on one card, destinations on the other: one launch on the
    source card stores into the peer's memory, bit for bit, both ways."""
    from p2pfl_tpu_torch.parallel.ici_plane import exchange_plain

    for src_dev, dst_dev in (two_cards, two_cards[::-1]):
        srcs, _ = _exchange_tree(src_dev, "bf16")
        srcs += _exchange_tree(src_dev, "mlp_fp32")[0]
        dsts = [torch.empty_like(s, device=dst_dev) for s in srcs]
        refs = [torch.empty_like(d) for d in dsts]
        _kernels.reset_launches()
        _kernels.ici_exchange(srcs, dsts)
        exchange_plain(srcs, refs)
        torch.cuda.synchronize(src_dev)
        torch.cuda.synchronize(dst_dev)
        assert _kernels.LAUNCHES["ici_exchange"] == 1
        for s, d, r in zip(srcs, dsts, refs):
            assert d.device == dst_dev
            assert torch.equal(_bits(d), _bits(r)) and torch.equal(_bits(d).cpu(), _bits(s).cpu())


def test_ici_gossip_federation_across_two_cards(two_cards):
    """Two gossip Nodes, one slot on each card, the ICI plane: every model
    payload crosses cards through kernel 9's peer stores; both nodes end
    on one model with no fallback or failed transfer."""
    from p2pfl_tpu_torch.communication.ici import ici_stats, reset_ici_stats
    from p2pfl_tpu_torch.examples import mnist as example

    reset_ici_stats()
    _kernels.reset_launches()
    out = example.run(nodes=2, rounds=2, samples=2048, batch_size=128, device=None,
                      weights_plane="ici", topology="full", devices=list(two_cards))
    torch.cuda.synchronize()
    stats = ici_stats()
    assert stats["shard_sends"] > 0 and stats["bytes_moved"] > 0
    assert stats["fallback_bytes"] == 0 and stats["align_violations"] == 0
    assert _kernels.LAUNCHES["ici_exchange"] == stats["shard_sends"]
    from p2pfl_tpu_torch.ops.tree import tree_leaves

    a, b = (tree_leaves(p) for p in out["params"])
    assert a[0].device == two_cards[0] and b[0].device == two_cards[1]
    assert max((x.cpu() - y.cpu()).abs().max().item() for x, y in zip(a, b)) <= 1e-5
