"""The limit that holds the flash kernels to their plain versions on the
card (``chip_smoke.check``), tested here on the CPU with the plain versions.

Each element is held to RTOL·|ref| + RTOL·rms(ref) + TERMS_TOL·Σ|terms|,
where Σ|terms| is the sum of the magnitudes of the terms that form it
(``flash_attention.*_magnitude``). The last part bounds what a differing
bf16 rounding of one P or dS does to a sum whose terms cancel; without it
(the old limit) such a flip fails. A real fault, one k tile left out,
fails both.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from p2pfl_tpu_torch.ops import flash_attention as fa

NEG_INF = -1e30


def _inputs(t=256, h=4, dtype=torch.bfloat16, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((1, h, t, 64), dtype=np.float32)).to(dtype) for _ in range(4)]


def _dense_magnitudes(q, k, v, do, lse, delta, glse, visible):
    """Σ|terms| of O, dQ, dK, dV from whole [T, T] matrices: P = exp(S −
    lse) where the pair is visible and the row sees something, else 0;
    dS = P (dP − Δ + g_lse)."""
    scale = q.shape[-1] ** -0.5
    s = scale * q @ k.transpose(-1, -2)
    live = visible & (lse[..., None] > NEG_INF / 2)
    p = torch.where(live, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    ds = p * (do @ v.transpose(-1, -2) - delta[..., None] + glse[..., None])
    return (p @ v.abs(), scale * ds.abs() @ k.abs(), scale * ds.abs().transpose(-1, -2) @ q.abs(),
            p.transpose(-1, -2) @ do.abs())


# (causal, q_off, k_off): a causal and a full launch, and two ring hops in
# global coordinates: the diagonal, and one whose first 32 rows see nothing
CASES = {"causal": (True, None, None), "full": (False, None, None), "diagonal": (True, 256, 256),
         "offtile_late": (True, 256, 288)}


@pytest.mark.parametrize("case", list(CASES))
def test_magnitudes_equal_a_dense_computation(case):
    """The blocked helpers (the plain versions' sweeps, loop bounds and
    masks) against whole matrices, in float64 where both are exact."""
    causal, q_off, k_off = CASES[case]
    q, k, v, do = _inputs(dtype=torch.float64)
    t = q.shape[2]
    rows, cols = torch.arange(t)[:, None], torch.arange(t)[None, :]
    if q_off is None:
        o, lse = fa.flash_fwd_plain(q, k, v, causal, 64, 64)
        o_mag = fa.flash_fwd_magnitude(q, k, v, causal, 64, 64)
        delta, glse = (do * o).sum(-1), torch.zeros(lse.shape, dtype=lse.dtype)
        mags = fa.flash_bwd_magnitude(q, k, v, do, lse, delta, causal, 64, 64)
        visible = rows >= cols if causal else torch.ones(t, t, dtype=torch.bool)
    else:
        o, lse = fa.flash_fwd_offs_plain(q, k, v, q_off, k_off, 64, 64)
        o_mag = fa.flash_fwd_offs_magnitude(q, k, v, q_off, k_off, 64, 64)
        delta = (do * o).sum(-1)
        glse = torch.from_numpy(np.random.default_rng(7).standard_normal(lse.shape))
        glse = torch.where(lse <= NEG_INF / 2, torch.zeros_like(glse), glse)
        mags = fa.flash_bwd_offs_magnitude(q, k, v, do, lse, delta, glse, q_off, k_off, 64, 64)
        visible = q_off + rows >= k_off + cols
    want = _dense_magnitudes(q, k, v, do, lse, delta, glse, visible)
    for got, ref in zip((o_mag, *mags), want):
        assert got.dtype == torch.float64
        torch.testing.assert_close(got, ref, rtol=1e-10, atol=1e-12)
    if case == "offtile_late":  # rows that see nothing have no terms
        assert torch.count_nonzero(o_mag[..., :32, :]) == 0 and torch.count_nonzero(mags[0][..., :32, :]) == 0


def _plain_backward(t=256):
    """bf16 inputs through the plain forward and split backward (kernels
    1, 3, 4), with P and dS as the plain versions form them, and each
    output's terms' magnitudes."""
    q, k, v, do = _inputs(t=t)
    o, lse = fa.flash_fwd_plain(q, k, v, True, 64, 64)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, True, 64, 64)
    outs = {"dQ": fa.flash_bwd_dq_plain(*args), **dict(zip(("dK", "dV"), fa.flash_bwd_dkv_plain(*args)))}
    terms = dict(zip(("dQ", "dK", "dV"), fa.flash_bwd_magnitude(*args)))
    scale = 64 ** -0.5
    s = scale * q.float() @ k.float().transpose(-1, -2)
    p = torch.where(torch.ones(t, t, dtype=torch.bool).tril(), torch.exp(s - lse[..., None]), torch.zeros_like(s))
    ds = p * (do.float() @ v.float().transpose(-1, -2) - delta[..., None])
    return (q, k, v, do), outs, terms, p.to(torch.bfloat16).float(), ds.to(torch.bfloat16).float()


def _ulp(x):
    """One bf16 ulp of each (nonzero) element of x."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


@pytest.mark.parametrize("output", ["dQ", "dK", "dV"])
def test_limit_passes_a_rounding_flip_that_the_old_limit_fails(output):
    """The output of a kernel that rounded one P (dV) or dS (dQ, dK) to
    the other bf16 neighbour: at the element where that flip weighs most
    against the old limit (a sum whose terms cancel), the old limit fails
    and the new one, which adds TERMS_TOL·Σ|terms|, passes."""
    (q, k, v, do), outs, terms, pb, dsb = _plain_backward()
    scale = 64 ** -0.5
    # flip[..., i, j, d]: one ulp of the rounded factor of term (i, j) of element (i or j, d)
    if output == "dV":  # dV[j, d] = Σ_i P[i, j] dO[i, d]
        flip = _ulp(pb)[..., :, :, None] * do.float().abs()[..., :, None, :]
        flip = flip * (pb != 0)[..., None]
        flip, at = flip.max(dim=-3)
    elif output == "dK":  # dK[j, d] = scale Σ_i dS[i, j] Q[i, d]
        flip = scale * (_ulp(dsb) * (dsb != 0))[..., :, :, None] * q.float().abs()[..., :, None, :]
        flip, at = flip.max(dim=-3)
    else:  # dQ[i, d] = scale Σ_j dS[i, j] K[j, d]
        flip = scale * (_ulp(dsb) * (dsb != 0))[..., :, :, None] * k.float().abs()[..., None, :, :]
        flip, at = flip.max(dim=-2)
    ref = outs[output].float()
    old_limit = chip_smoke.RTOL * ref.abs() + chip_smoke.RTOL * ref.pow(2).mean().sqrt()
    worst = torch.argmax(flip / old_limit)
    got = ref.clone()
    got.view(-1)[worst] += flip.view(-1)[worst]
    assert chip_smoke.check(got, outs[output])[2] > 1  # the old limit fails the flip
    assert chip_smoke.check(got, outs[output], terms[output])[2] <= 1
    assert chip_smoke.check(outs[output], outs[output], terms[output])[2] == 0


def test_limit_fails_a_dropped_tile():
    """dQ with k tile 0 left out of every q tile after the first: a real
    fault, far above either limit."""
    (q, k, v, do), outs, terms, pb, dsb = _plain_backward()
    scale = 64 ** -0.5
    got = outs["dQ"].float().clone()
    got[..., 64:, :] -= scale * (dsb[..., 64:, :64] @ k.float()[..., :64, :])
    assert chip_smoke.check(got, outs["dQ"])[2] > 1
    assert chip_smoke.check(got, outs["dQ"], terms["dQ"])[2] > 1
    # the same for dV with q tile 1 left out of k tile 0
    got = outs["dV"].float().clone()
    got[..., :64, :] -= pb[..., 64:128, :64].transpose(-1, -2) @ do.float()[..., 64:128, :]
    assert chip_smoke.check(got, outs["dV"])[2] > 1
    assert chip_smoke.check(got, outs["dV"], terms["dV"])[2] > 1
