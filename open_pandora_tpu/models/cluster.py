"""DPC-KNN token clustering — static-shape JAX implementation.

Behavioral spec: /root/reference/ChatUniVi/model/cluster.py
(cluster_dpc_knn :111-171, merge_tokens :174-223, CTM :226-257; TCBlock is
an identity passthrough :280-287 and is not rebuilt) and the projection
driver /root/reference/ChatUniVi/model/arch.py:110-217:
  - image: 3 cascaded clusterings of the 256 CLIP patch tokens to
    64 -> 32 -> 16 centers; concat -> 112 tokens.
  - video: per-frame mean features clustered temporally into
    ceil(T/16) events; then per event, the event-frames' level-0/1/2
    spatial clusters are re-clustered to 64/32/16; concat over events in
    first-frame order -> 112 * n_events tokens.

Reformulation (SURVEY.md §7.2 item 2): cluster counts are static
(64/32/16, ceil(T/16)); the variable-size per-event frame groups become a
fixed-capacity token mask (the reference's own token_mask machinery,
cluster.py:131-149), so every shape is static under jit. Density tie-break
noise (cluster.py:142-144, torch.rand*1e-6) is replaced by a deterministic
index-scaled epsilon — same effect (strict ordering), reproducible.

Merging uses one-hot matmuls instead of index_add scatter.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp


def _cdist(x: jnp.ndarray) -> jnp.ndarray:
    """Pairwise euclidean distance, fp32 (cluster.py:130: cdist / sqrt(C))."""
    x = x.astype(jnp.float32)
    sq = jnp.sum(x * x, axis=-1)
    d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * jnp.einsum(
        "bnc,bmc->bnm", x, x, preferred_element_type=jnp.float32)
    return jnp.sqrt(jnp.maximum(d2, 0.0)) / (x.shape[-1] ** 0.5)


def cluster_dpc_knn(
    x: jnp.ndarray,
    cluster_num: int,
    k: int = 5,
    token_mask: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Returns (idx_cluster (B, N) in [0, cluster_num), centers_idx (B, K)).

    Follows cluster.py:111-171: kNN local density, density-peak distance
    score, topk centers, nearest-center assignment, centers self-assigned.
    """
    B, N, C = x.shape
    dist = _cdist(x)

    if token_mask is not None:
        tm = token_mask > 0
        dist = dist * tm[:, None, :] + (jnp.max(dist) + 1.0) * (~tm[:, None, :])

    # local density from k nearest distances (negative topk of -dist)
    dist_nearest = -jax.lax.top_k(-dist, k)[0]           # (B, N, k)
    density = jnp.exp(-jnp.mean(dist_nearest ** 2, axis=-1))
    # deterministic strict-ordering tie-break (replaces torch.rand*1e-6)
    density = density + jnp.arange(N, dtype=jnp.float32)[None, :] * 1e-6
    if token_mask is not None:
        density = density * (token_mask > 0)

    # distance to nearest higher-density point (or max dist for the peak)
    higher = density[:, None, :] > density[:, :, None]    # (B, N, N)
    dist_max = jnp.max(dist.reshape(B, -1), axis=-1)[:, None, None]
    d_parent = jnp.where(higher, dist, dist_max)
    d_score = jnp.min(d_parent, axis=-1)                  # (B, N)

    score = d_score * density
    centers = jax.lax.top_k(score, cluster_num)[1]        # (B, K)

    # assign every token to nearest center
    dist_to_centers = jnp.take_along_axis(
        dist, centers[:, :, None], axis=1)                # (B, K, N)
    idx_cluster = jnp.argmin(dist_to_centers, axis=1)     # (B, N)
    # centers merge to themselves
    self_idx = jnp.broadcast_to(jnp.arange(cluster_num)[None], centers.shape)
    idx_cluster = jax.vmap(lambda ic, c, s: ic.at[c].set(s))(
        idx_cluster, centers, self_idx)
    return idx_cluster, centers


def merge_tokens(
    x: jnp.ndarray,
    idx_cluster: jnp.ndarray,
    cluster_num: int,
    token_weight: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Weighted mean of tokens per cluster (cluster.py:174-223), as one-hot
    matmuls. x (B, N, C) -> (B, K, C)."""
    B, N, C = x.shape
    if token_weight is None:
        token_weight = jnp.ones((B, N), dtype=jnp.float32)
    onehot = jax.nn.one_hot(idx_cluster, cluster_num,
                            dtype=jnp.float32)           # (B, N, K)
    w = token_weight.astype(jnp.float32)
    all_weight = jnp.einsum("bnk,bn->bk", onehot, w) + 1e-6
    merged = jnp.einsum("bnk,bnc->bkc", onehot,
                        x.astype(jnp.float32) * w[:, :, None],
                        preferred_element_type=jnp.float32)
    return (merged / all_weight[:, :, None]).astype(x.dtype)


def ctm_down(x: jnp.ndarray, cluster_num: int, k: int,
             token_mask: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """One CTM stage: cluster + merge (CTM.forward, cluster.py:233-257).
    k is clamped like the reference when it exceeds the cluster count."""
    if k > cluster_num:
        k = min(3, max(cluster_num // 2, 1))
    idx, _ = cluster_dpc_knn(x, cluster_num, k, token_mask)
    w = None
    if token_mask is not None:
        w = (token_mask > 0).astype(jnp.float32)
    return merge_tokens(x, idx, cluster_num, w)


def project_image_tokens(feats: jnp.ndarray,
                         rates=(64, 32, 16)) -> jnp.ndarray:
    """Image branch (arch.py:112-132): cascade 256 -> 64 -> 32 -> 16,
    concat all three levels -> (B, 112, C)."""
    ks = (5, 3, 3)
    outs = []
    x = feats
    for r, k in zip(rates, ks):
        x = ctm_down(x, r, k)
        outs.append(x)
    return jnp.concatenate(outs, axis=1)


def project_video_tokens(
    frame_feats: jnp.ndarray,
    rates=(64, 32, 16),
    temporal_rate: float = 1.0 / 16.0,
) -> jnp.ndarray:
    """Video branch (arch.py:133-208). frame_feats (T, P, C) — per-frame CLIP
    patch tokens. Returns (1, 112 * E, C), E = ceil(T * temporal_rate).

    Reformulated with fixed-capacity masks: each event's token set is the
    full (T*level_tokens) grid with a frame-membership mask, so shapes stay
    static; merge weights zero out non-member frames (identical math to the
    reference's per-event gather + cluster, since masked tokens have density
    0 and weight 0).
    """
    T, P, C = frame_feats.shape
    E = max(math.ceil(T * temporal_rate), 1)
    ks = (5, 3, 3)

    # temporal event clustering on per-frame mean features (arch.py:134-152)
    cls_feats = jnp.mean(frame_feats, axis=1)[None]       # (1, T, C)
    k3 = 5 if 5 <= E else min(3, max(E // 2, 1))
    event_idx, _ = cluster_dpc_knn(cls_feats, E, k3)      # (1, T)
    event_idx = event_idx[0]                              # (T,)

    # order events by first frame occurrence (OrderedDict semantics,
    # arch.py:146-152): rank events by min frame index
    first_occ = jnp.min(
        jnp.where(event_idx[None, :] == jnp.arange(E)[:, None],
                  jnp.arange(T)[None, :], T + 1), axis=1)  # (E,)
    event_order = jnp.argsort(first_occ)                   # (E,)

    # per-frame spatial cascades (arch.py:163-166): batch over frames
    level_feats = []
    x = frame_feats
    for r, k in zip(rates, ks):
        x = ctm_down(x, r, k)
        level_feats.append(x)                              # (T, r, C)

    # per event: re-cluster member frames' level-l tokens to rates[l]
    outs = []
    for e in range(E):
        ev = event_order[e]
        member = (event_idx == ev)                         # (T,)
        for lf, r, k in zip(level_feats, rates, ks):
            toks = lf.reshape(1, -1, C)                    # (1, T*r, C)
            mask = jnp.repeat(member, lf.shape[1])[None]   # (1, T*r)
            outs.append(ctm_down(toks, r, k, token_mask=mask))
    return jnp.concatenate(outs, axis=1)                   # (1, 112*E, C)
