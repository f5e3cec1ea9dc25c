"""Secure aggregation: pairwise additive masking over the gossip overlay
(counterpart of ``p2pfl_tpu/learning/secagg.py``, Bonawitz et al., CCS'17).

- Every node derives one shared seed per train-set peer by Diffie-Hellman
  over the message gossip (one ``secagg_pub`` broadcast at experiment
  start, the RFC 3526 group-14 modulus below).
- Before contributing, a node adds ``u_i = Σ_{j≠i} sign(i,j)·(s_ij/w_i)·
  PRG(seed_ij, round)`` with the pair scale ``s_ij = SECAGG_MASK_STD·
  sqrt(w_i·w_j)`` (sample counts ride the DH keys) and ``sign(i,j) = +1``
  iff ``addr_i < addr_j``: in the weighted FedAvg sum the masks cancel
  pairwise, up to fp32 rounding. The masks are fp32 numpy arrays (the
  same bytes as the JAX package's from the same seeds), added to the
  params where they live in fp32.
- Dropout recovery: survivors re-disclose their pair seeds for the
  dropped members only (``secagg_recover``), and :func:`dropout_correction`
  gives the exact uncancelled sum to subtract.
- Double masking (``Settings.SECAGG_DOUBLE_MASK``): every contribution
  also carries a per-round self mask whose seed is t-of-n Shamir-shared
  with the train set (shares encrypted under :func:`dh_share_key`), so a
  captured masked update stays masked through every recovery path; no
  honest participant publishes both seed types for one (node, round).

Threat model: passive wire snooping. Degenerate DH keys are rejected and
the first key a peer announces is latched (``commands/control.py``).
FedAvg only, over a lossless wire (``WIRE_COMPRESSION="none"``), with
fp32 parameters: anything else breaks exact cancellation. The SPMD
federations do not mask (one program is one trust domain);
:func:`masked_stack` is the same masking over a node-stacked tree, to
check cancellation without a wire.
"""

from __future__ import annotations

import hashlib
import secrets
from typing import Any, Optional

import numpy as np
import torch

from p2pfl_tpu_torch.exceptions import SecAggError
from p2pfl_tpu_torch.learning.weights import ModelUpdate, named_leaves
from p2pfl_tpu_torch.ops.tree import tree_unflatten
from p2pfl_tpu_torch.settings import Settings

Tree = Any

# RFC 3526 group 14: 2048-bit MODP prime, generator 2.
DH_PRIME = int(
    "FFFFFFFFFFFFFFFFC90FDAA22168C234C4C6628B80DC1CD129024E088A67CC74"
    "020BBEA63B139B22514A08798E3404DDEF9519B3CD3A431B302B0A6DF25F1437"
    "4FE1356D6D51C245E485B576625E7EC6F44C42E9A637ED6B0BFF5CB6F406B7ED"
    "EE386BFB5A899FA5AE9F24117C4B1FE649286651ECE45B3DC2007CB8A163BF05"
    "98DA48361C55D39A69163FA8FD24CF5F83655D23DCA3AD961C62F356208552BB"
    "9ED529077096966D670C354E4ABC9804F1746C08CA18217C32905E462E36CE3B"
    "E39E772C180E86039B2783A2EC07A28FB5C55DF06F4C52C9DE2BCBF695581718"
    "3995497CEA956AE515D2261898FA051015728E5A8AACAA68FFFFFFFFFFFFFFFF",
    16,
)
DH_GENERATOR = 2


def dh_keypair() -> tuple[int, int]:
    """A fresh (private, public) modular Diffie-Hellman pair."""
    priv = secrets.randbits(256)
    return priv, pow(DH_GENERATOR, priv, DH_PRIME)


def valid_public_key(pub: int) -> bool:
    """Range check of a peer's DH public key: 0, 1 and p-1 (and anything
    out of range) would make the shared secret computable by anyone."""
    return 2 <= pub <= DH_PRIME - 2


def dh_pair_seed(priv: int, peer_pub: int, context: str) -> int:
    """The shared 256-bit PRG key of one (self, peer) pair, symmetric:
    ``sha256(g^(xy) mod p ‖ context)``."""
    if not valid_public_key(peer_pub):
        raise SecAggError("degenerate DH public key (value outside [2, p-2])")
    shared = pow(peer_pub, priv, DH_PRIME)
    h = hashlib.sha256(shared.to_bytes(256, "big") + context.encode("utf-8"))
    return int.from_bytes(h.digest(), "big")


# ---- Shamir t-of-n secret sharing over GF(2^521 − 1) ----

SHAMIR_PRIME = 2**521 - 1

#: pseudo-contributor appended to diffused (finalized, self-mask-free)
#: aggregates under double masking, so receivers tell them from
#: full-coverage aggregates still carrying self masks ("#" cannot appear in
#: a node address). AddModelCommand strips it.
CLEAN_MARKER = "#secagg_clean"


def shamir_split(secret: int, n: int, t: int) -> list[tuple[int, int]]:
    """``n`` shares ``(x, y)``, x = 1..n, any ``t`` of which rebuild
    ``secret``; fewer reveal nothing."""
    if not 1 <= t <= n:
        raise ValueError(f"need 1 <= t <= n (t={t}, n={n})")
    if not 0 <= secret < SHAMIR_PRIME:
        raise ValueError("secret out of field range")
    coeffs = [secret] + [secrets.randbelow(SHAMIR_PRIME) for _ in range(t - 1)]
    out = []
    for x in range(1, n + 1):
        y = 0
        for c in reversed(coeffs):  # Horner
            y = (y * x + c) % SHAMIR_PRIME
        out.append((x, y))
    return out


def shamir_reconstruct(shares: list[tuple[int, int]]) -> int:
    """The secret (the polynomial at x = 0) by Lagrange interpolation of at
    least ``t`` shares with distinct x (duplicates collapse)."""
    pts = list(dict(shares).items())
    secret = 0
    for i, (xi, yi) in enumerate(pts):
        num, den = 1, 1
        for j, (xj, _yj) in enumerate(pts):
            if i == j:
                continue
            num = (num * (-xj)) % SHAMIR_PRIME
            den = (den * (xi - xj)) % SHAMIR_PRIME
        secret = (secret + yi * num * pow(den, -1, SHAMIR_PRIME)) % SHAMIR_PRIME
    return secret


def share_threshold(n_members: int) -> int:
    """Honest-majority threshold: more than half the train set, clamped to
    the ``n_members − 1`` peers who hold shares."""
    return max(1, min(n_members - 1, n_members // 2 + 1))


def dh_share_key(priv: int, peer_pub: int, experiment: str) -> int:
    """The pair's share-encryption key: a domain-separated sibling hash of
    the DH secret, so disclosing the pair mask seed (dropout recovery)
    reveals nothing about it."""
    return dh_pair_seed(priv, peer_pub, experiment + "\x00share-enc")


def _share_stream(share_key: int, round_no: int, owner: str, holder: str, n_bytes: int) -> bytes:
    """Keyed XOF stream encrypting one share, bound to (key, round, owner,
    holder): the A→B and B→A shares never reuse a keystream."""
    return hashlib.shake_256(
        b"p2pfl-secagg-share-enc\x00"
        + share_key.to_bytes(32, "big")
        + round_no.to_bytes(8, "big")
        + owner.encode("utf-8")
        + b"\x00"
        + holder.encode("utf-8")
    ).digest(n_bytes)


SHARE_BYTES = 66  # ceil(521/8): every share travels as a fixed-width field element


def encrypt_share(y: int, share_key: int, round_no: int, owner: str, holder: str) -> bytes:
    raw = y.to_bytes(SHARE_BYTES, "big")
    stream = _share_stream(share_key, round_no, owner, holder, SHARE_BYTES)
    return bytes(a ^ b for a, b in zip(raw, stream))


def decrypt_share(blob: bytes, share_key: int, round_no: int, owner: str, holder: str) -> int:
    if len(blob) != SHARE_BYTES:
        raise SecAggError(f"share ciphertext must be {SHARE_BYTES} bytes")
    stream = _share_stream(share_key, round_no, owner, holder, SHARE_BYTES)
    return int.from_bytes(bytes(a ^ b for a, b in zip(blob, stream)), "big")


# ---- the masks ----


def _leaf_mask(
    seed: int, round_no: int, shape: tuple, li: int, domain: bytes = b"p2pfl-secagg-mask\x00",
) -> np.ndarray:
    """Deterministic N(0, 1) block, the same stream on both ends of a pair:
    SHAKE-256 keyed by (seed, round, leaf index) through Box–Muller in
    float64, cast to fp32 (the JAX package's bytes from the same inputs)."""
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    m = 2 * ((n + 1) // 2)  # even count for Box–Muller pairing
    material = hashlib.shake_256(
        domain + seed.to_bytes(32, "big") + round_no.to_bytes(8, "big") + li.to_bytes(8, "big")
    ).digest(8 * m)
    x = np.frombuffer(material, dtype=">u8").astype(np.float64)
    u = (x + 1.0) * 2.0**-64  # uniform in (0, 1]: log() is safe
    half = m // 2
    r = np.sqrt(-2.0 * np.log(u[:half]))
    theta = (2.0 * np.pi) * u[half:]
    z = np.concatenate([r * np.cos(theta), r * np.sin(theta)])[:n]
    return z.astype(np.float32).reshape(shape)


def _shapes(template: Tree) -> dict:
    """``{path: shape}`` of a tree's leaves (metadata only)."""
    return {key: tuple(leaf.shape) for key, leaf in named_leaves(template)[1]}


def pairwise_mask(
    template: Tree,
    my_addr: str,
    pair_seeds: dict[str, int],
    round_no: int,
    pair_scales: Optional[dict[str, float]] = None,
) -> dict[str, np.ndarray]:
    """This node's total pair mask as ``{path: fp32 array}``: each pair
    contributes ``+s_ij·PRG(seed_ij)`` on one side and ``−s_ij·PRG`` on
    the other (``pair_scales[j] = s_ij``, the same value on both ends)."""
    shapes = _shapes(template)
    keys = sorted(shapes)
    out = {k: np.zeros(shapes[k], np.float32) for k in keys}
    for peer, seed in pair_seeds.items():
        sign = 1.0 if my_addr < peer else -1.0
        s = 1.0 if pair_scales is None else pair_scales[peer]
        for li, k in enumerate(keys):
            out[k] += (sign * s) * _leaf_mask(seed, round_no, shapes[k], li)
    return out


def pair_scale(w_i: float, w_j: float) -> float:
    """``s_ij = STD·sqrt(w_i·w_j)`` from the announced sample counts."""
    return Settings.SECAGG_MASK_STD * float(np.sqrt(float(w_i) * float(w_j)))


def _add_host(params: Tree, host: dict, sign: float = 1.0, divisor: Optional[float] = None) -> Tree:
    """``params ± host`` leaf by leaf in fp32, each host array moved to its
    leaf's device (``host / divisor`` taken in fp32 numpy first)."""
    out = {}
    for key, leaf in named_leaves(params)[1]:
        arr = host[key] if divisor is None else host[key] / np.float32(divisor)
        t = torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(leaf.device)
        base = leaf.to(torch.float32)
        out[key] = base + t if sign > 0 else base - t
    return tree_unflatten(out)


def mask_update(
    update: ModelUpdate,
    my_addr: str,
    train_set: list[str],
    priv: int,
    pubs: dict[str, tuple[int, int]],
    experiment: str,
    round_no: int,
    announced_samples: Optional[int] = None,
    self_seed: Optional[int] = None,
) -> ModelUpdate:
    """Mask a node's own contribution before it enters the aggregator.

    ``pubs`` maps each peer to its (DH public key, announced sample count).
    ``self_seed`` (the per-round double-masking seed) adds
    ``STD·PRG_self(b_i^r)`` on top. Raises :class:`SecAggError` when the
    update cannot be masked safely (lossy wire compression, missing peer
    keys, zero or changed sample weight, non-fp32 params): the caller then
    skips contributing, never sends unmasked."""
    peers = [n for n in train_set if n != my_addr]
    if not peers:
        return update
    if Settings.WIRE_COMPRESSION != "none":
        raise SecAggError(
            f"WIRE_COMPRESSION={Settings.WIRE_COMPRESSION!r} breaks mask "
            "cancellation; secure aggregation needs a lossless wire"
        )
    missing = [n for n in peers if n not in pubs]
    if missing:
        raise SecAggError(f"missing DH public keys for train-set peers {missing}")
    if update.num_samples <= 0:
        raise SecAggError("cannot mask a contribution with zero sample weight")
    if announced_samples is not None and update.num_samples != announced_samples:
        raise SecAggError(
            f"num_samples changed since the key announcement "
            f"({announced_samples} announced, {update.num_samples} now); "
            "mask cancellation would silently break"
        )
    if any(w <= 0 for _p, w in pubs.values()):
        raise SecAggError("a peer announced a non-positive sample count")
    bad_dtypes = {
        str(leaf.dtype).replace("torch.", "")
        for _k, leaf in named_leaves(update.params)[1]
        if leaf.dtype != torch.float32
    }
    if bad_dtypes:
        # cancellation is exact only in fp32: a narrower dtype rounds each
        # node's mask apart, and the residue survives the sum
        raise SecAggError(
            f"params contain {sorted(bad_dtypes)} leaves; secure aggregation "
            "requires float32 parameters (use param_dtype=float32 — bf16 "
            "compute is unaffected)"
        )
    w_i = float(update.num_samples)
    seeds = {n: dh_pair_seed(priv, pubs[n][0], experiment) for n in peers}
    scales = {n: pair_scale(w_i, pubs[n][1]) / w_i for n in peers}
    masks = pairwise_mask(update.params, my_addr, seeds, round_no, scales)
    if self_seed is not None:
        for k, m in self_mask(update.params, self_seed, round_no).items():
            masks[k] = masks[k] + m
    return ModelUpdate(_add_host(update.params, masks), list(update.contributors), update.num_samples)


def maybe_reveal_self_seed(node, round_no: int) -> None:
    """Broadcast this node's self-mask seed for ``round_no`` if, and only
    if, the seed exists, no pair-seed disclosure about this node was
    observed this round, and it was not sent already. The one gate of both
    reveal sites (a peer's coverage naming us, and our finalize)."""
    st = node.state
    my_b = st.secagg_self_seed.get(round_no)
    if my_b is None or (round_no, st.addr) in st.secagg_round_dropped or (round_no, st.addr) in st.secagg_reveal_sent:
        return
    st.secagg_reveal_sent.add((round_no, st.addr))
    node.protocol.broadcast(
        node.protocol.build_msg(
            "secagg_reveal", [st.experiment_name or "", st.addr, "0", f"{my_b:x}"], round=round_no
        )
    )


_SELF_DOMAIN = b"p2pfl-secagg-self\x00"


def self_mask(template: Tree, seed: int, round_no: int) -> dict[str, np.ndarray]:
    """The self mask ``STD·PRG_self(b_i^r)`` (a domain apart from the pair
    stream), as ``{path: fp32 array}``."""
    shapes = _shapes(template)
    std = Settings.SECAGG_MASK_STD
    return {
        k: std * _leaf_mask(seed, round_no, shapes[k], li, domain=_SELF_DOMAIN)
        for li, k in enumerate(sorted(shapes))
    }


def self_mask_correction(
    template: Tree, contributors: list[str], seeds: dict[str, int], weights: dict[str, int], round_no: int,
) -> dict[str, np.ndarray]:
    """``Σ_{i∈contributors} w_i·STD·PRG_self(b_i^r)``, the self-mask term
    left in the weighted sum; subtract it by
    :func:`apply_dropout_correction`."""
    shapes = _shapes(template)
    keys = sorted(shapes)
    std = Settings.SECAGG_MASK_STD
    out = {k: np.zeros(shapes[k], np.float32) for k in keys}
    for i in contributors:
        s = std * float(weights[i])
        for li, k in enumerate(keys):
            out[k] += s * _leaf_mask(seeds[i], round_no, shapes[k], li, domain=_SELF_DOMAIN)
    return out


def dropout_correction(
    template: Tree,
    survivors: list[str],
    missing: list[str],
    seeds: dict[tuple[str, str], int],
    weights: dict[str, int],
    round_no: int,
) -> dict[str, np.ndarray]:
    """The mask sum dropped members left uncancelled: for every survivor i
    and missing j, ``sign(i,j)·s_ij·PRG(seed_ij, round)``. ``seeds`` maps
    (survivor, missing) to the pair seed, ``weights`` every address to its
    announced sample count."""
    shapes = _shapes(template)
    keys = sorted(shapes)
    out = {k: np.zeros(shapes[k], np.float32) for k in keys}
    for i in survivors:
        for j in missing:
            sign = 1.0 if i < j else -1.0
            s = pair_scale(weights[i], weights[j])
            seed = seeds[(i, j)]
            for li, k in enumerate(keys):
                out[k] += (sign * s) * _leaf_mask(seed, round_no, shapes[k], li)
    return out


def apply_dropout_correction(params: Tree, correction: dict[str, np.ndarray], survivor_weight: float) -> Tree:
    """``params − correction / survivor_weight`` in fp32: the aggregate is
    the survivors' weighted mean, the correction a weighted sum."""
    return _add_host(params, correction, sign=-1.0, divisor=survivor_weight)


def masked_stack(params_stack: dict, weights: torch.Tensor, key: int, scale: Optional[float] = None) -> dict:
    """Pairwise masking of a node-stacked ``[N, ...]`` tree in torch, the
    protocol's math without a wire: one N(0, 1) block a pair and leaf
    (from a ``torch.Generator`` seeded by ``key``, the leaf and the pair),
    antisymmetric signs, pair scale ``scale·sqrt(w_i·w_j)`` applied as
    ``s_ij/w_i`` on node i. The weighted FedAvg of the result equals that
    of the input to fp32 rounding; each node's mask stays O(scale)."""
    if scale is None:
        scale = Settings.SECAGG_MASK_STD
    w = weights.to(torch.float32)
    n = w.shape[0]
    out = {}
    for li, (path, leaf) in enumerate(named_leaves(params_stack)[1]):
        mask = torch.zeros(leaf.shape, dtype=torch.float32, device=leaf.device)
        for i in range(n):
            for j in range(i + 1, n):
                gen = torch.Generator(device=leaf.device).manual_seed(hash((int(key), li, i, j)) & (2**63 - 1))
                z = torch.randn(leaf.shape[1:], generator=gen, dtype=torch.float32, device=leaf.device)
                s_ij = scale * torch.sqrt(w[i] * w[j])
                mask[i] += (s_ij / w[i]) * z
                mask[j] -= (s_ij / w[j]) * z
        out[path] = (leaf.to(torch.float32) + mask).to(leaf.dtype)
    return tree_unflatten(out)
