"""Sharded MCMC: chain batches over a device mesh with cross-chain
step-size adaptation.

No reference counterpart. Chains are embarrassingly parallel — the chain
axis shards with one ``NamedSharding`` and XLA partitions the vmapped
``lax.scan`` program; cross-chain statistics (mean accept rate for dual
averaging) compile to a ``psum`` automatically because they are reductions
over the sharded axis.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import jax
import jax.numpy as jnp
import jax.random as jr
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from typing import TYPE_CHECKING

from ..core.typing_ import PRNGKey
from ..generative.concepts import EditRequest
from ..generative.selection import Selection

if TYPE_CHECKING:
    # Annotation-only: parallel/ sits BELOW inference/ in the layer order
    # (tests/test_layering.py); the runtime import of run_chain is lazy.
    from ..inference.mcmc import MHChainResult


def run_chains_sharded(
    key: PRNGKey,
    make_trace: Callable[[PRNGKey], Any],
    request: EditRequest | Selection,
    n_steps: int,
    n_chains: int,
    mesh: Mesh,
    *,
    axis: str = "batch",
    record: Callable[[Any], Any] | None = None,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 0,
    max_segments: int | None = None,
) -> MHChainResult:
    """``inference.mcmc.run_chains`` with the chain axis sharded over
    ``mesh`` — same program, multi-chip execution.

    **Preemption-safe resume**: with ``checkpoint_dir`` set and
    ``checkpoint_every=k``, the run executes in segments of ``k`` steps
    and checkpoints the full chain state (traces, per-step per-chain
    accept flags, recorded history, step cursor) after each via the
    crash-atomic versioned machinery (``io.save_segment_state``); per-chain per-step PRNG
    keys are pre-derived from the caller key, so an interrupted run
    re-invoked with the SAME arguments resumes at the last completed
    segment and returns the BITWISE result of the uninterrupted
    checkpointed run. Sharded leaves checkpoint their shards (orbax);
    multi-host clusters save/restore collectively. ``max_segments``
    bounds how many NEW segments this call runs (a partial call returns
    the steps completed so far)."""
    import jax.tree_util as jtu

    from ..inference.mcmc import run_chain

    keys = jr.split(key, n_chains)
    if jax.process_count() > 1:
        # multi-controller: device_put cannot target non-addressable
        # devices; build the global key array from each process's host
        # copy (identical everywhere — same caller key) via the raw
        # uint32 key data
        import numpy as np

        kd = np.asarray(jr.key_data(keys))
        kd_sharding = NamedSharding(
            mesh, P(axis, *([None] * (kd.ndim - 1)))
        )
        kd_global = jax.make_array_from_callback(
            kd.shape, kd_sharding, lambda idx: kd[idx]
        )
        keys = jr.wrap_key_data(kd_global)
    else:
        keys = jax.device_put(keys, NamedSharding(mesh, P(axis)))
    if checkpoint_dir is None:
        return _run_chains_jit(keys, request, make_trace, n_steps, record)
    return _run_chains_checkpointed(
        keys, request, make_trace, n_steps, record,
        checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every or n_steps,
        max_segments=max_segments,
    )


@functools.partial(
    jax.jit, static_argnames=("make_trace", "n_steps", "record")
)
def _run_chains_jit(keys, request, make_trace, n_steps, record):
    # module-level jit (NOT a per-call closure): repeat calls with the
    # same callables and shapes hit the compile cache instead of paying
    # the 10–400 s remote re-compile per invocation (CLAUDE.md)
    import jax.tree_util as jtu

    from ..inference.mcmc import run_chain

    def one(k):
        k_init, k_run = jr.split(k)
        tr = make_trace(k_init)
        return run_chain(k_run, tr, request, n_steps, record=record)

    # chains-on-lanes internal layout (see inference.mcmc.run_chains:
    # 20x on small models), restored to chains-leading on the outputs
    res = jax.vmap(one, out_axes=-1)(keys)
    return jtu.tree_map(lambda v: jnp.moveaxis(v, -1, 0), res)


@functools.partial(jax.jit, static_argnames=("make_trace",))
def _init_chains_jit(keys, make_trace):
    """Chain init + per-step key schedule, chains-on-lanes. The key
    discipline matches ``run_chain``'s (k_init/k_run split per chain),
    with the whole (n_steps, n_chains) step-key table derived up front so
    segment boundaries never change the stream."""
    def one(k):
        k_init, k_run = jr.split(k)
        return make_trace(k_init), k_run

    traces, run_keys = jax.vmap(one, out_axes=(-1, 0))(keys)
    return traces, run_keys


@functools.partial(jax.jit, static_argnames=("n_steps",))
def _step_keys_jit(run_keys, n_steps):
    # (n_chains, n_steps) -> (n_steps, n_chains) for segment slicing
    return jnp.swapaxes(
        jax.vmap(lambda k: jr.split(k, n_steps))(run_keys), 0, 1
    )


@functools.partial(jax.jit, static_argnames=("record",))
def _run_segment_jit(traces, seg_keys, request, record):
    """One segment: scan over its step keys; chains stay on lanes.
    Per-step outputs keep the CHAIN axis (the non-checkpointed path's
    ``accept_rate`` is per-chain, and the checkpointed path must match
    that contract)."""
    from ..inference.mcmc import mh

    def step(trs, ks):
        trs, accepted = jax.vmap(
            lambda k, t: mh(k, t, request), in_axes=(0, -1), out_axes=(-1, 0)
        )(ks, trs)
        rec = (
            jax.vmap(record, in_axes=-1)(trs) if record is not None else None
        )
        return trs, (jnp.asarray(accepted, jnp.float32), rec)

    traces, (accs, hist) = jax.lax.scan(step, traces, seg_keys)
    return traces, accs, hist


def _request_fingerprint(request) -> str:
    """A stable string identifying an edit request for resume validation
    (treedef + concrete leaf values; array leaves — e.g. a warmup-adapted
    vector ``inv_mass`` — ravel into the fingerprint)."""
    import jax.tree_util as jtu
    import numpy as np

    leaves, treedef = jtu.tree_flatten(request)
    vals = [
        np.round(np.asarray(l, np.float64).ravel(), 9).tolist()
        for l in leaves
    ]
    return f"{treedef}|{vals}"


def _run_chains_checkpointed(
    keys, request, make_trace, n_steps, record, *, checkpoint_dir,
    checkpoint_every, max_segments,
):
    import jax.tree_util as jtu
    import numpy as np

    from ..inference.mcmc import MHChainResult
    from ..io import check_meta_matches, load_segment_state, \
        save_segment_state

    traces, run_keys = _init_chains_jit(keys, make_trace)
    step_keys = _step_keys_jit(run_keys, n_steps)
    n_chains = int(keys.shape[0])
    bounds = [
        (lo, min(lo + checkpoint_every, n_steps))
        for lo in range(0, n_steps, checkpoint_every)
    ]
    run_identity = {
        "n_steps": int(n_steps),
        "seg_size": int(checkpoint_every),
        "n_chains": n_chains,
        "request": _request_fingerprint(request),
    }
    start_seg = 0
    accs_parts, hist_parts = [], []

    def make_template(meta):
        check_meta_matches(checkpoint_dir, meta, run_identity)
        steps_done = meta["steps_done"]
        hist_tpl = None
        if record is not None and steps_done:
            seg_shapes = jax.eval_shape(
                _run_segment_jit, traces, step_keys[:steps_done],
                request, record,
            )[2]
            hist_tpl = jtu.tree_map(
                lambda s: jnp.zeros(s.shape, s.dtype), seg_shapes
            )
        return {
            "traces": traces,
            # per-step PER-CHAIN accept flags
            "accs": jnp.zeros((steps_done, n_chains), jnp.float32),
            "hist": hist_tpl,
        }

    restored = load_segment_state(checkpoint_dir, make_template)
    if restored is not None:
        state, meta = restored
        traces = state["traces"]
        if meta["steps_done"]:
            # host numpy: restored accumulators may sit on a different
            # device set than fresh segment outputs (mesh-replicated)
            accs_parts.append(np.asarray(state["accs"]))
            if record is not None:
                hist_parts.append(jtu.tree_map(np.asarray, state["hist"]))
        start_seg = meta["next_segment"]
    ran = 0
    for si in range(start_seg, len(bounds)):
        if max_segments is not None and ran >= max_segments:
            break
        lo, hi = bounds[si]
        traces, accs_i, hist_i = _run_segment_jit(
            traces, step_keys[lo:hi], request, record
        )
        accs_parts.append(accs_i)
        if record is not None:
            hist_parts.append(hist_i)
        ran += 1
        accs_all = jnp.concatenate(accs_parts, axis=0)
        state = {
            "traces": traces,
            "accs": accs_all,
            "hist": (
                jtu.tree_map(
                    lambda *xs: jnp.concatenate(xs, axis=0), *hist_parts
                )
                if record is not None
                else None
            ),
        }
        save_segment_state(
            checkpoint_dir, state,
            {
                "next_segment": si + 1,
                "steps_done": int(accs_all.shape[0]),
                **run_identity,
            },
        )
    if not accs_parts:
        raise ValueError(
            "no chain segments ran (max_segments=0 on a fresh run?) — "
            "nothing to return; run at least one segment"
        )
    accs = jnp.concatenate(accs_parts, axis=0)  # (steps_done, n_chains)
    history = None
    if record is not None and hist_parts:
        history = jtu.tree_map(
            lambda *xs: jnp.concatenate(xs, axis=0), *hist_parts
        )
        # (steps, chains, ...) -> chains-leading, matching run_chains
        history = jtu.tree_map(lambda v: jnp.swapaxes(v, 0, 1), history)
    return MHChainResult(
        jtu.tree_map(lambda v: jnp.moveaxis(v, -1, 0), traces),
        # per-chain accept rate, matching the non-checkpointed contract
        jnp.mean(accs, axis=0),
        history,
    )


# Step-size adaptation lives in the unified adaptation module
# (kernels/adaptation.py), shared with the column kernels; re-exported
# here for backwards compatibility.
from ..kernels.adaptation import (  # noqa: E402
    StepSizeAdaptState,
    dual_averaging_update,
)


def warmup_adapt_step_size(
    key: PRNGKey,
    traces: Any,
    make_request: Callable[[Any], EditRequest],
    n_warmup: int,
    *,
    eps0: float = 0.1,
    target_accept: float = 0.8,
) -> tuple[Any, Any]:
    """Adapt a global HMC step size over a *batch* of chains by dual
    averaging on the cross-chain mean accept probability.

    ``traces`` is a vmapped/sharded batch of chain states;
    ``make_request(eps)`` builds the HMC request at a step size. Under a
    sharded chain axis the ``jnp.mean`` over chains compiles to an
    ``psum``. Returns ``(adapted_traces, eps)``.
    """

    def warm_step(carry, kk):
        traces, adapt = carry
        eps = jnp.exp(adapt.log_eps)

        def one(k, tr):
            # Independent edit/accept keys: fold_in(k, 1) == split(k)[1] is
            # the sub-key HMC.edit uses for momenta, so the accept uniform
            # must come from a separate split (advisor round-1 finding).
            k_edit, k_acc = jr.split(k)
            new_tr, alpha, _, _ = tr.edit(k_edit, make_request(eps))
            # a diverged leapfrog yields alpha = NaN; count it as a
            # rejection (prob 0) or one poisoned chain makes mean_accept
            # — and then the dual-averaged eps — NaN for the rest of
            # warmup (the column kernels guard this in-kernel)
            accept_prob = jnp.where(
                jnp.isnan(alpha), 0.0, jnp.minimum(1.0, jnp.exp(alpha))
            )
            log_u = jnp.log(jr.uniform(k_acc))
            accept = log_u < alpha
            out = jax.tree_util.tree_map(
                lambda new, old: jnp.where(accept, new, old), new_tr, tr
            )
            return out, accept_prob

        traces, accept_probs = jax.vmap(one)(
            jr.split(kk, _leading_size(traces)), traces
        )
        mean_accept = jnp.mean(accept_probs)  # psum over sharded chain axis
        adapt = dual_averaging_update(
            adapt, mean_accept, target_accept=target_accept
        )
        return (traces, adapt), mean_accept

    adapt0 = StepSizeAdaptState.init(eps0)
    (traces, adapt), accept_hist = lax.scan(
        warm_step, (traces, adapt0), jr.split(key, n_warmup)
    )
    return traces, jnp.exp(adapt.log_eps_bar)


def _leading_size(tree) -> int:
    import jax.tree_util as jtu

    for leaf in jtu.tree_leaves(tree):
        return leaf.shape[0]
    raise ValueError("empty tree")
