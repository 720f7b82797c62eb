"""Resampling kernels: single-device index generators and cross-shard
collective resampling.

Design notes:

- Index generation (systematic/stratified/multinomial/residual) lowers to a
  ``cumsum`` + ``searchsorted`` — a few fused passes over the weight
  vector, no host logic.
- ``collective_resample`` runs inside ``shard_map`` over the particle axis.
  Two modes trade exactness for interconnect traffic:

  * ``"local"`` — each shard resamples its own slice; the shard's total
    weight is retained as the (uniform) post-resampling weight of its
    particles, so the global collection stays properly weighted. Traffic:
    one scalar ``psum`` (for the normalizer). This is the
    local-resampling variant of distributed particle filters.
  * ``"all_gather"`` — exact global systematic resampling: log-weights are
    all-gathered (K floats between devices), every shard computes the global index
    vector and gathers its slice of source particles from an all-gathered
    particle buffer. Exact but O(K·particle_size) traffic; right when the
    per-particle state is small.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import jax.random as jr
import jax.tree_util as jtu
from jax import lax
from jax.scipy.special import logsumexp


def _normalize(log_weights):
    return log_weights - logsumexp(log_weights)


def effective_sample_size(log_weights) -> Any:
    """ESS = 1 / Σ ŵ² of the normalized weights."""
    lw = _normalize(log_weights)
    return jnp.exp(-logsumexp(2.0 * lw))


def systematic_counts(key, log_weights, n: int | None = None):
    """Per-source copy counts for systematic resampling, in O(K) arithmetic
    (no binary search): target ``j`` lands on source ``i`` iff
    ``cdf_{i-1} <= (j+u0)/n < cdf_i``, so the number of targets below
    ``cdf_i`` is ``ceil(n*cdf_i - u0)``. Paired with a monotonic
    ``jnp.repeat`` redistribution it replaces the binary-search
    ``searchsorted`` and the random gather.
    """
    k = log_weights.shape[0]
    n = k if n is None else n
    w = jnp.exp(_normalize(log_weights))
    cdf = jnp.cumsum(w)
    u0 = jr.uniform(key)
    t = jnp.clip(jnp.ceil(n * cdf - u0), 0, n).astype(jnp.int32)
    t = t.at[-1].set(n)  # guard fp roundoff in the last bucket
    return jnp.diff(jnp.concatenate([jnp.zeros(1, jnp.int32), t]))


def _packed_row_move(particles, k: int, total: int, move):
    """Apply a row-movement op to a particle pytree with all 4-byte leaves
    bit-packed into one (k, >=8) uint32 matrix.

    All 4-byte leaves are bit-packed into one (K, >=8) uint32 matrix
    (zero-padded to 8 columns), moved with a single row op, and unpacked
    with slices, so a multi-leaf state moves in one pass. Non-4-byte
    leaves fall back to per-leaf moves.

    ``move(x)`` maps a ``(k, ...)`` array to a ``(total, ...)`` array and
    must move rows identically for every leaf (a repeat-by-counts or an
    index gather).
    """
    leaves, treedef = jtu.tree_flatten(particles)

    def _packable(v):
        return (
            hasattr(v, "dtype")
            and jnp.ndim(v) >= 1
            and v.shape[0] == k
            and v.dtype.itemsize == 4
        )

    pack_idx = [i for i, v in enumerate(leaves) if _packable(v)]
    out = list(leaves)
    if len(pack_idx) >= 1:
        cols = []
        spans = []  # (leaf index, col start, n_cols, dtype, shape)
        start = 0
        for i in pack_idx:
            v = leaves[i]
            flat = jnp.reshape(v, (k, -1))
            u = jax.lax.bitcast_convert_type(flat, jnp.uint32)
            cols.append(u)
            spans.append((i, start, u.shape[1], v.dtype, v.shape))
            start += u.shape[1]
        if start < 8:  # pad to the vectorization-friendly width
            cols.append(jnp.zeros((k, 8 - start), jnp.uint32))
        packed = jnp.concatenate(cols, axis=1)
        moved = move(packed)
        for i, c0, nc, dtype, shape in spans:
            u = moved[:, c0 : c0 + nc]
            v = jax.lax.bitcast_convert_type(u, dtype)
            out[i] = jnp.reshape(v, (total,) + shape[1:])
    for i, v in enumerate(leaves):
        if i not in pack_idx:
            out[i] = move(v)
    return jtu.tree_unflatten(treedef, out)


def redistribute(particles, counts, n: int | None = None):
    """Copy particle ``i`` ``counts[i]`` times, contiguously — the
    redistribution step for any *monotonic* resampler (systematic,
    stratified). Uses the bit-packed row-repeat (``_packed_row_move``).
    """
    total = int(jnp.shape(counts)[0]) if n is None else n
    k = jnp.shape(counts)[0]
    return _packed_row_move(
        particles,
        k,
        total,
        lambda v: jnp.repeat(v, counts, axis=0, total_repeat_length=total),
    )


def systematic_indices(key, log_weights, n: int | None = None):
    """Systematic (low-variance) resampling indices (monotonic). Built from
    the counts formulation — see ``systematic_counts``."""
    k = log_weights.shape[0]
    n = k if n is None else n
    counts = systematic_counts(key, log_weights, n)
    return jnp.repeat(
        jnp.arange(k, dtype=jnp.int32), counts, total_repeat_length=n
    )


def stratified_counts(key, log_weights, n: int | None = None):
    """Per-source copy counts for stratified resampling (one uniform per
    stratum; the strata points are sorted, so a sort-based searchsorted of
    the CDF against them yields counts without random gathers)."""
    k = log_weights.shape[0]
    n = k if n is None else n
    w = jnp.exp(_normalize(log_weights))
    cdf = jnp.cumsum(w)
    us = (jnp.arange(n) + jr.uniform(key, (n,))) / n
    t = jnp.searchsorted(us, cdf, side="left", method="sort").astype(jnp.int32)
    t = t.at[-1].set(n)
    return jnp.diff(jnp.concatenate([jnp.zeros(1, jnp.int32), t]))


def stratified_indices(key, log_weights, n: int | None = None):
    """Stratified resampling indices (monotonic)."""
    k = log_weights.shape[0]
    n = k if n is None else n
    counts = stratified_counts(key, log_weights, n)
    return jnp.repeat(
        jnp.arange(k, dtype=jnp.int32), counts, total_repeat_length=n
    )


def multinomial_indices(key, log_weights, n: int | None = None):
    k = log_weights.shape[0]
    n = k if n is None else n
    return jr.categorical(key, _normalize(log_weights), shape=(n,))


def residual_indices(key, log_weights, n: int | None = None):
    """Residual resampling: deterministic copies for the integer parts of
    n·ŵ, multinomial for the remainder. Fixed-shape encoding: compute
    deterministic copy counts, fill the remainder multinomially."""
    k = log_weights.shape[0]
    n = k if n is None else n
    w = jnp.exp(_normalize(log_weights))
    counts = jnp.floor(n * w).astype(jnp.int32)
    n_det = jnp.sum(counts)
    resid = n * w - counts
    resid_logits = jnp.log(jnp.maximum(resid, 1e-37))
    # deterministic part: slot j maps to the particle whose cumulative count
    # bracket contains j
    slots = jnp.arange(n)
    det_idx = jnp.searchsorted(jnp.cumsum(counts), slots, side="right")
    rand_idx = jr.categorical(key, resid_logits, shape=(n,))
    return jnp.where(slots < n_det, jnp.clip(det_idx, 0, k - 1), rand_idx)


_METHODS = {
    "systematic": systematic_indices,
    "stratified": stratified_indices,
    "multinomial": multinomial_indices,
    "residual": residual_indices,
}

_COUNT_METHODS = {
    "systematic": systematic_counts,
    "stratified": stratified_counts,
}


def resample_indices(key, log_weights, n=None, method: str = "systematic"):
    return _METHODS[method](key, log_weights, n)


def packed_take(particles, idx, k: int):
    """Row-gather a particle pytree at ``idx`` via the bit-packed row
    movement of ``_packed_row_move``."""
    total = jnp.shape(idx)[0]
    return _packed_row_move(particles, k, total, lambda v: v[idx])


def resample_particles(key, particles, log_weights, n=None, method="systematic"):
    """Resample a particle pytree: monotonic methods use the gather-free
    counts+repeat path; others use a packed row-gather."""
    k = log_weights.shape[0]
    n = k if n is None else n
    if method in _COUNT_METHODS:
        counts = _COUNT_METHODS[method](key, log_weights, n)
        return redistribute(particles, counts, n)
    idx = _METHODS[method](key, log_weights, n)
    return packed_take(particles, idx, k)


# ----------------------------------------------------------------------
# collective (cross-shard) resampling — call inside shard_map
# ----------------------------------------------------------------------


def collective_weight_stats(log_weights, axis_name: str):
    """Global ``(ess, log_normalizer)`` of a sharded weight vector in TWO
    collectives: one scalar ``pmax`` for the stable shift, then one psum of
    a stacked pair ``(Σ exp(lw−m), Σ exp(2(lw−m)))`` — the fused form every
    per-step caller (adaptive-resampling PF) should use instead of separate
    ESS and normalizer reductions (3–5 collectives otherwise)."""
    global_max = lax.pmax(jnp.max(log_weights), axis_name)
    shifted = jnp.exp(log_weights - global_max)
    sums = lax.psum(
        jnp.stack([jnp.sum(shifted), jnp.sum(shifted * shifted)]), axis_name
    )
    ess = sums[0] * sums[0] / sums[1]
    k_global = log_weights.shape[0] * lax.axis_size(axis_name)
    log_norm = global_max + jnp.log(sums[0]) - jnp.log(k_global)
    return ess, log_norm


def collective_log_normalizer(log_weights, axis_name: str):
    """log Σ_global exp(lw) − log K_global, stably, with one pmax and one
    psum across devices."""
    local_max = jnp.max(log_weights)
    global_max = lax.pmax(local_max, axis_name)
    local_sum = jnp.sum(jnp.exp(log_weights - global_max))
    global_sum = lax.psum(local_sum, axis_name)
    k_local = log_weights.shape[0]
    k_global = k_local * lax.axis_size(axis_name)
    return global_max + jnp.log(global_sum) - jnp.log(k_global)


def collective_resample(
    key,
    particles: Any,
    log_weights,
    axis_name: str,
    *,
    method: str = "systematic",
    mode: str = "local",
    log_z_inc=None,
):
    """Resample a sharded particle collection inside ``shard_map``.

    Returns ``(new_particles, new_log_weights, log_marginal_increment)``
    where the increment is the global mean-weight normalizer (add it to a
    running logZ estimate). Callers that already paid for the global
    weight statistics this step (``collective_weight_stats``) pass the
    normalizer via ``log_z_inc`` so ``"local"`` mode adds ZERO extra
    collectives."""
    shard_idx = lax.axis_index(axis_name)
    k_local = log_weights.shape[0]
    if log_z_inc is None:
        log_z_inc = collective_log_normalizer(log_weights, axis_name)

    if mode == "local":
        # Per-shard resampling; the shard's mean weight is retained so the
        # global collection remains properly weighted (scalar traffic only).
        local_key = jr.fold_in(key, shard_idx)
        new_particles = resample_particles(
            local_key, particles, log_weights, k_local, method
        )
        shard_log_mean_w = logsumexp(log_weights) - jnp.log(k_local)
        new_log_weights = jnp.full(
            (k_local,), shard_log_mean_w - log_z_inc
        )
        return new_particles, new_log_weights, log_z_inc

    if mode == "all_gather":
        # Exact global systematic resampling.
        all_lw = lax.all_gather(log_weights, axis_name)  # (D, k_local)
        flat_lw = all_lw.reshape(-1)
        # Every shard computes the same global index vector from the shared
        # key (pass `key` replicated — P() — into the shard_map).
        all_idx = resample_indices(key, flat_lw, flat_lw.shape[0], method)
        my_slice = lax.dynamic_slice_in_dim(
            all_idx, shard_idx * k_local, k_local
        )
        all_particles = jtu.tree_map(
            lambda v: lax.all_gather(v, axis_name).reshape(
                (-1,) + v.shape[1:]
            ),
            particles,
        )
        new_particles = packed_take(
            all_particles, my_slice, flat_lw.shape[0]
        )
        new_log_weights = jnp.zeros((k_local,))
        return new_particles, new_log_weights, log_z_inc

    raise ValueError(f"Unknown collective resampling mode: {mode!r}")
