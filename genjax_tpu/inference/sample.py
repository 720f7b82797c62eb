"""``sample_posterior``: the one-call production sampling driver.

No reference counterpart (the reference ships moves, not drivers —
mcmc.py docstring). This ties the framework's pieces into the workflow a
practitioner actually runs: prior-initialize a chain batch, adapt step
size (and diagonal mass) during warmup, draw thinned samples, and report
split-R̂ / ESS per parameter — all as a handful of compiled programs whose
chain axis shards over a ``Mesh`` for multi-chip runs.

Structure: chains batch with the chain axis LAST internally (see
``inference.mcmc.run_chains``), restored to the conventional
chains-leading shape on the outputs; warmup is one ``lax.scan`` of
windows (``inference.adaptation``); sampling is one ``lax.scan`` of
transitions recording the selected choices; diagnostics are cross-chain
reductions (collectives when sharded).
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import jax.random as jr
import jax.tree_util as jtu
from jax import lax

from ..core.diff import Diff
from ..core.pytree import Pytree
from ..core.typing_ import PRNGKey
from ..generative.choice_map import ChoiceMap
from ..generative.gfi import GenerativeFunction
from ..generative.selection import Selection
from .adaptation import adapt_window
from .diagnostics import ess, split_rhat


@Pytree.dataclass
class PosteriorSamples(Pytree):
    """Thinned posterior draws plus convergence diagnostics.

    ``positions``: dict of selected address path -> array with shape
    ``(n_chains, n_samples, *event_shape)``. ``rhat``/``ess`` hold the
    same paths' split-R̂ and bulk effective sample size (over the raveled
    event dims). ``eps``/``inv_mass`` are the adapted kernel settings.
    """

    positions: Any
    rhat: Any
    ess: Any
    accept_rate: Any
    divergence_rate: Any
    eps: Any
    inv_mass: Any

    @staticmethod
    def _read(tree, addr):
        from ..generative.mask import Mask

        path = addr if isinstance(addr, tuple) else (addr,)
        v = tree.get_submap(*path).get_value()
        if isinstance(v, Mask):
            return v.value
        return v

    def __getitem__(self, addr):
        """Draws at ``addr``: shape (n_chains, n_samples, *event)."""
        return self._read(self.positions, addr)

    def rhat_of(self, addr):
        return self._read(self.rhat, addr)

    def ess_of(self, addr):
        return self._read(self.ess, addr)



def _column_diagnostics(arr, n_samples):
    """Shared split-R̂ / bulk-ESS over draws shaped (chains, samples, dim)
    — the one place the diagnostics configuration (max_lag) lives."""

    @jax.jit
    def _diag(arr):
        r = jax.vmap(split_rhat, in_axes=2)(arr)
        e = jax.vmap(
            lambda x: ess(x, max_lag=min(n_samples - 1, 64)), in_axes=2
        )(arr)
        return r, e

    return _diag(arr)


def sample_posterior(
    key: PRNGKey,
    model: GenerativeFunction,
    constraint: ChoiceMap,
    args: tuple,
    selection: Selection,
    *,
    n_chains: int = 1024,
    n_warmup: int = 300,
    n_samples: int = 100,
    thin: int = 1,
    algorithm: str = "nuts",
    eps0: float = 0.1,
    L: int = 8,
    max_depth: int = 8,
    target_accept: float = 0.8,
    n_rungs: int = 6,
    mesh=None,
    axis: str = "batch",
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 0,
    max_segments: int | None = None,
) -> PosteriorSamples:
    """Sample ``p(selection | constraint)`` with adaptive NUTS, HMC, or
    ChEES.

    ``algorithm="nuts"``/``"hmc"`` run trace-based edit requests: warmup
    splits into up to 6 windows totalling exactly ``n_warmup``
    transitions (``n_warmup=0`` disables adaptation, keeping ``eps0`` and
    the identity mass): each window runs transitions at the current
    settings, nudges the step size toward ``target_accept``, and
    re-estimates the diagonal inverse mass from cross-chain variance of
    the raveled selected choices. Sampling then records one draw per
    ``thin`` transitions. With ``mesh``, the chain batch shards over it.

    ``algorithm="hmc_sweep"`` is the THROUGHPUT form of ``"hmc"``
    (round 5): the same Markov chain, driven batch-first — the selected
    choices of all chains ravel once into a ``(d, n_chains)`` column
    block, warmup windows and sampling run as column sweeps with bulk
    momenta (the ``run_chains_hmc`` pattern: the density is still the
    GFI's own ``assess`` over each chain's frozen complement, so
    indexed selections and per-chain constraints work), and traces are
    rebuilt once per segment (``bench.py gfi`` compares it with the
    hand-packed column kernel and the per-transition ``"hmc"`` path).
    Divergences surface as
    rejections (``divergence_rate`` is 0 by construction). Supports
    ``checkpoint_dir`` resume like ``"hmc"``.

    ``algorithm="chees"`` runs the fused column kernel
    (``kernels.chees_hmc``): trajectory length, step size, AND mass adapt
    jointly from cross-chain statistics — the highest-ESS/sec path for
    statically-addressed continuous selections (ARCHITECTURE §3). Its
    optimal acceptance target is 0.651; ``target_accept`` is forwarded,
    so pass 0.651 explicitly unless you want this driver's 0.8 default.

    ``algorithm="pt"`` runs replica-exchange (parallel-tempering) HMC on
    the column layout (``kernels.pt_hmc``) over an ``n_rungs`` geometric
    temperature ladder — the turn-key choice for MULTIMODAL posteriors,
    where single-temperature chains stay trapped in the mode they
    initialize in. Draws come from the cold rung; ``eps``/``inv_mass``/
    ``accept_rate`` report the cold rung's adapted settings.

    ``algorithm="dense_hmc"`` runs the dense-metric column kernel
    (``kernels.dense_mass``): warmup estimates the FULL posterior
    covariance from the cross-chain spread and preconditions the
    integrator with it — the right choice for strongly CORRELATED
    posteriors, where every diagonal-metric algorithm above caps the
    step size at the smallest conditional scale. The returned
    ``inv_mass`` is the adapted metric's diagonal (marginal variances).

    ``algorithm="dense_nuts"`` combines the dense metric with NUTS (the
    Stan ``dense_e`` pairing): roughly half the ``n_warmup`` budget
    estimates the full covariance with dense-HMC windows, the chain
    cloud is whitened (``kernels.dense_mass.whiten_logdensity``), and
    the other half adapts the white-space NUTS step size; sampling runs
    column NUTS in white coordinates and maps draws back. ``inv_mass``
    reports the metric's diagonal; the returned ``eps`` is the
    WHITE-space step size (not comparable to the original-space eps of
    the other algorithms). ``n_warmup=0`` disables adaptation (identity
    metric, ``eps0``).

    **Preemption-safe resume** (``algorithm="nuts"``/``"hmc"``): with
    ``checkpoint_dir`` set and ``checkpoint_every=k``, the run executes
    sampling in segments of ``k`` draws and checkpoints the FULL sampler
    state (chain traces, adapted ``eps``/``inv_mass``, draws-so-far,
    segment cursor) to disk after warmup and after every segment
    (``genjax_tpu.io`` orbax serialization — sharded leaves save their
    shards). If the process dies, calling ``sample_posterior`` again
    with the SAME arguments and key resumes from the last completed
    segment and produces the BITWISE-identical result of the
    uninterrupted run: per-draw PRNG keys are pre-split from the caller
    key, so segment boundaries never change the stream (a run with
    ``checkpoint_every=0`` is also bitwise-identical — segmentation is
    pure restartability). A preemption DURING warmup restarts warmup
    (warmup is one compiled program; its state is checkpointed at the
    warmup/sampling boundary). ``max_segments`` bounds how many NEW
    segments this call runs (time-budgeted slices on preemptible quota);
    a partial call returns the draws accumulated so far.
    """
    from .mcmc import mh
    from .requests.hmc import HMC
    from .requests.nuts import NUTS

    if checkpoint_dir is not None and algorithm not in (
        "nuts", "hmc", "hmc_sweep"
    ):
        raise ValueError(
            "checkpoint_dir/resume is supported for the trace-path "
            "algorithms ('nuts'/'hmc'/'hmc_sweep'); the column kernels "
            "(chees/pt/dense_hmc/dense_nuts) run warmup+sampling as "
            "single compiled programs with no segment boundary to "
            "checkpoint at."
        )

    if algorithm == "dense_nuts":
        return _sample_posterior_dense_nuts(
            key, model, constraint, args, selection,
            n_chains=n_chains, n_warmup=n_warmup, n_samples=n_samples,
            thin=thin, eps0=eps0, max_depth=max_depth,
            target_accept=target_accept, mesh=mesh, axis=axis,
        )
    if algorithm == "dense_hmc":
        return _sample_posterior_dense(
            key, model, constraint, args, selection,
            n_chains=n_chains, n_warmup=n_warmup, n_samples=n_samples,
            thin=thin, eps0=eps0, L=L, target_accept=target_accept,
            mesh=mesh, axis=axis,
        )
    if algorithm == "chees":
        return _sample_posterior_chees(
            key, model, constraint, args, selection,
            n_chains=n_chains, n_warmup=n_warmup, n_samples=n_samples,
            thin=thin, eps0=eps0, target_accept=target_accept,
            mesh=mesh, axis=axis,
        )
    if algorithm == "pt":
        return _sample_posterior_pt(
            key, model, constraint, args, selection,
            n_chains=n_chains, n_warmup=n_warmup, n_samples=n_samples,
            thin=thin, eps0=eps0, L=L, target_accept=target_accept,
            n_rungs=n_rungs, mesh=mesh, axis=axis,
        )

    if algorithm not in ("nuts", "hmc", "hmc_sweep"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    if n_samples <= 0:
        # fail fast: the fused path would otherwise run the FULL warmup
        # before dying on an empty sampling phase
        raise ValueError(f"n_samples must be >= 1, got {n_samples}")
    k_init, k_warm, k_run = jr.split(key, 3)
    init_keys = jr.split(k_init, n_chains)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        init_keys = jax.device_put(init_keys, NamedSharding(mesh, P(axis)))

    def make_request(eps, inv_mass):
        if algorithm == "nuts":
            return NUTS(selection, eps, max_depth=max_depth, inv_mass=inv_mass)
        if algorithm == "hmc":
            return HMC(selection, eps, L=L, inv_mass=inv_mass)
        raise ValueError(f"unknown algorithm {algorithm!r}")

    def transition(k, tr, eps, inv_mass):
        if algorithm == "nuts":
            req = make_request(eps, inv_mass)
            nd = Diff.tree_diff_no_change(tr.get_args())
            new_tr, _w, _rd, _bwd, info = req.edit_with_info(k, tr, nd)
            # "accept rate" for NUTS is its internal accept statistic;
            # divergences surface separately
            return new_tr, (
                info.accept_prob,
                jnp.asarray(info.diverged, jnp.float32),
            )
        new_tr, accepted = mh(k, tr, make_request(eps, inv_mass))
        return new_tr, (
            jnp.asarray(accepted, jnp.float32),
            jnp.asarray(0.0),
        )

    def ravel_selected(tr):
        from .requests.grad_view import split_ravel

        flat, _ = split_ravel(tr.get_choices().filter_eager(selection))
        return flat

    @jax.jit
    def warm(init_keys, k_warm):
        # chains-last internal layout: the chain axis batches LAST (see
        # inference.mcmc.run_chains)
        traces = jax.vmap(
            lambda k: model.generate(k, constraint, args)[0], out_axes=-1
        )(init_keys)
        d = jax.vmap(ravel_selected, in_axes=-1)(traces).shape[1]

        # ---- warmup: step-size + mass adaptation over up to 6 windows
        # totalling exactly n_warmup transitions. n_warmup=0 disables
        # adaptation entirely (the caller's eps0 and identity mass are
        # kept); window sizes differ by at most one, so the Python-level
        # unroll stays tiny while honoring the requested budget. ----
        n_windows = min(6, n_warmup)
        eps = jnp.asarray(eps0, jnp.float32)
        inv_mass = jnp.ones((d,))
        if n_windows > 0:
            base, rem = divmod(n_warmup, n_windows)
            wkeys = jr.split(k_warm, n_windows)
            for wi in range(n_windows):
                steps_this_window = base + (1 if wi < rem else 0)

                def step(traces, kk, eps=eps, inv_mass=inv_mass):
                    ks = jr.split(kk, n_chains)
                    traces, (accs, _divs) = jax.vmap(
                        lambda k, t: transition(k, t, eps, inv_mass),
                        in_axes=(0, -1),
                        out_axes=(-1, (0, 0)),
                    )(ks, traces)
                    return traces, jnp.mean(accs)

                traces, accs = lax.scan(
                    step, traces, jr.split(wkeys[wi], steps_this_window)
                )
                positions = jax.vmap(ravel_selected, in_axes=-1)(traces)
                eps, inv_mass = adapt_window(
                    eps, inv_mass, jnp.mean(accs), positions,
                    target_accept=target_accept, chain_axis=0,
                )
        return traces, eps, inv_mass

    # ---- the "hmc_sweep" batch-first pair: same signatures as
    # warm/sample_segment, but warmup windows and sampling run as
    # column sweeps over the raveled selected values (the shared
    # trace<->column bridge, grad_view.column_view), with traces
    # rebuilt once per phase ----
    from .requests.grad_view import column_view

    @jax.jit
    def warm_sweep(init_keys, k_warm):
        from ..kernels.hmc import _reference_hmc

        traces = jax.vmap(
            lambda k: model.generate(k, constraint, args)[0], out_axes=-1
        )(init_keys)
        z, ld, write_back = column_view(traces, selection, chain_axis=-1)
        # same window contract as the trace-path warm(): up to 6 windows
        # totalling EXACTLY n_warmup transitions
        n_windows = min(6, n_warmup)
        eps = jnp.asarray(eps0, jnp.float32)
        inv_mass = jnp.ones((z.shape[0],), jnp.float32)
        if n_windows > 0:
            base, rem = divmod(n_warmup, n_windows)
            seed_w = jr.randint(jr.fold_in(k_warm, 3), (), 0, 2**30)
            for wi in range(n_windows):
                steps_this_window = base + (1 if wi < rem else 0)
                z, acc = _reference_hmc(
                    ld, z, seed_w + wi, n_steps=steps_this_window,
                    eps=eps, L=L, inv_mass=inv_mass,
                )
                eps, inv_mass = adapt_window(
                    eps, inv_mass, acc, z, target_accept=target_accept,
                )
        traces = write_back(z, jr.fold_in(k_warm, 9))
        return traces, eps, inv_mass

    @jax.jit
    def sample_segment_sweep(traces, seg_keys, eps, inv_mass):
        from ..kernels.hmc import _reference_hmc

        z0, ld, write_back = column_view(traces, selection, chain_axis=-1)

        def draw_step(z, kk):
            z, acc = _reference_hmc(
                ld, z, jr.randint(kk, (), 0, 2**30), n_steps=thin,
                eps=eps, L=L, inv_mass=inv_mass,
            )
            return z, (jnp.transpose(z), acc, jnp.asarray(0.0))

        z, (draws, accs, divs) = lax.scan(draw_step, z0, seg_keys)
        traces = write_back(z, jr.fold_in(seg_keys[-1], 17))
        return traces, draws, accs, divs

    @jax.jit
    def sample_segment(traces, seg_keys, eps, inv_mass):
        # one segment of draws; per-draw keys arrive PRE-SPLIT from the
        # caller key, so segment boundaries never change the stream
        # (resume-bitwise guarantee)
        def sample_step(traces, kk):
            def inner(traces, k2):
                ks = jr.split(k2, n_chains)
                traces, (accs, divs) = jax.vmap(
                    lambda k, t: transition(k, t, eps, inv_mass),
                    in_axes=(0, -1),
                    out_axes=(-1, (0, 0)),
                )(ks, traces)
                return traces, (jnp.mean(accs), jnp.mean(divs))

            traces, (accs, divs) = lax.scan(
                inner, traces, jr.split(kk, thin)
            )
            return traces, (
                jax.vmap(ravel_selected, in_axes=-1)(traces),
                jnp.mean(accs),
                jnp.mean(divs),
            )

        traces, (draws, accs, divs) = lax.scan(
            sample_step, traces, seg_keys
        )
        return traces, draws, accs, divs

    if algorithm == "hmc_sweep":
        warm = warm_sweep
        sample_segment = sample_segment_sweep

    # ---- segmented sampling with optional checkpoint/resume ----------
    seg_size = (
        checkpoint_every
        if (checkpoint_dir is not None and checkpoint_every > 0)
        else n_samples
    )
    sample_keys = jr.split(k_run, n_samples)

    if checkpoint_dir is None and max_segments is None:
        # no segmentation requested: fuse warmup + sampling into ONE
        # compiled program (jit-of-jit inlines), halving the remote
        # compile count vs the segmented path — numerically identical
        # (same ops, same key streams; the bitwise-invariance test
        # covers it)
        @jax.jit
        def run_fused(init_keys, k_warm, sample_keys):
            traces, eps, inv_mass = warm(init_keys, k_warm)
            traces, draws, accs, divs = sample_segment(
                traces, sample_keys, eps, inv_mass
            )
            return traces, draws, accs, divs, eps, inv_mass

        traces, draws, accs, divs, eps, inv_mass = run_fused(
            init_keys, k_warm, sample_keys
        )
        draws_parts, accs_parts, divs_parts = [draws], [accs], [divs]
        return _finish_trace_result(
            traces, draws_parts, accs_parts, divs_parts, selection,
            eps, inv_mass,
        )
    bounds = [
        (lo, min(lo + seg_size, n_samples))
        for lo in range(0, n_samples, seg_size)
    ]
    start_seg = 0
    draws_parts, accs_parts, divs_parts = [], [], []
    traces = eps = inv_mass = None
    # the FULL run identity rides in the checkpoint meta: a resume with
    # different dynamics (algorithm, step sizes, thin, key, ...) is
    # refused instead of silently mixing two samplers
    run_identity = {
        "n_samples": int(n_samples),
        "seg_size": int(seg_size),
        "n_chains": int(n_chains),
        "n_warmup": int(n_warmup),
        "thin": int(thin),
        "algorithm": algorithm,
        "eps0": float(eps0),
        "L": int(L),
        "max_depth": int(max_depth),
        "target_accept": float(target_accept),
        "key_fingerprint": _key_fingerprint(key),
    }
    if checkpoint_dir is not None:
        restored = _restore_sampler_state(
            checkpoint_dir, model, constraint, args, init_keys,
            n_chains=n_chains, run_identity=run_identity,
        )
        if restored is not None:
            import numpy as np

            traces, eps, inv_mass, prior_draws, prior_accs, prior_divs, \
                start_seg = restored
            if prior_draws.shape[0]:
                # host numpy: restored accumulators may sit on a
                # different device set than fresh segment outputs
                draws_parts.append(np.asarray(prior_draws))
                accs_parts.append(np.asarray(prior_accs))
                divs_parts.append(np.asarray(prior_divs))
    if traces is None:
        traces, eps, inv_mass = warm(init_keys, k_warm)
        if checkpoint_dir is not None:
            _save_sampler_state(
                checkpoint_dir, traces, eps, inv_mass,
                draws_parts, accs_parts, divs_parts, 0,
                run_identity=run_identity,
            )
    ran = 0
    for si in range(start_seg, len(bounds)):
        if max_segments is not None and ran >= max_segments:
            break
        lo, hi = bounds[si]
        traces, draws_i, accs_i, divs_i = sample_segment(
            traces, sample_keys[lo:hi], eps, inv_mass
        )
        draws_parts.append(draws_i)
        accs_parts.append(accs_i)
        divs_parts.append(divs_i)
        ran += 1
        if checkpoint_dir is not None:
            _save_sampler_state(
                checkpoint_dir, traces, eps, inv_mass,
                draws_parts, accs_parts, divs_parts, si + 1,
                run_identity=run_identity,
            )
    return _finish_trace_result(
        traces, draws_parts, accs_parts, divs_parts, selection,
        eps, inv_mass,
    )


def _finish_trace_result(
    traces, draws_parts, accs_parts, divs_parts, selection, eps, inv_mass
) -> PosteriorSamples:
    """Shared results packaging for the trace-path drivers: concatenate
    segment draws, run diagnostics, and unravel per-dim values back onto
    the selection's pytree."""
    if not draws_parts:
        raise ValueError(
            "no sampling segments ran (max_segments=0 on a fresh run?) — "
            "nothing to return; run at least one segment"
        )
    draws = jnp.concatenate(draws_parts, axis=0)
    n_done = draws.shape[0]
    accept_rate = jnp.mean(jnp.concatenate(accs_parts))
    divergence_rate = jnp.mean(jnp.concatenate(divs_parts))
    # draws: (n_done, n_chains, d) -> (n_chains, n_done, d)
    draws = jnp.transpose(draws, (1, 0, 2))

    # unpack draws back to per-address arrays + diagnostics (host-side
    # bookkeeping over static structure; the heavy reductions stay jitted)
    template = jtu.tree_map(lambda l: l[..., 0], traces)
    from .requests.grad_view import split_ravel

    _flat0, rebuild = split_ravel(
        template.get_choices().filter_eager(selection)
    )

    def unravel(z):
        # positions carry only the sampled (continuous) leaves; blank the
        # fixed non-differentiable leaves so per-draw trees don't replicate
        # template values
        return rebuild(z, nongrad_fill=lambda _l: None)

    rhat_flat, ess_flat = _column_diagnostics(draws, n_done)

    def unflatten_axis(flat_by_dim):
        """Map per-raveled-dim values back onto the selection's pytree."""
        return unravel(jnp.asarray(flat_by_dim, jnp.float32))

    positions = jax.vmap(jax.vmap(unravel))(draws)
    return PosteriorSamples(
        positions=positions,
        rhat=unflatten_axis(rhat_flat),
        ess=unflatten_axis(ess_flat),
        accept_rate=accept_rate,
        divergence_rate=divergence_rate,
        eps=eps,
        inv_mass=inv_mass,
    )


# ----------------------------------------------------------------------
# checkpoint/resume plumbing (sample_posterior nuts/hmc path)
# ----------------------------------------------------------------------


def _save_sampler_state(
    checkpoint_dir, traces, eps, inv_mass, draws_parts, accs_parts,
    divs_parts, next_segment, *, run_identity,
):
    """Checkpoint the full sampler state via the shared crash-atomic
    segmented-state machinery (``io.save_segment_state``): versioned
    state dir + atomically-flipped meta, so a preemption at any point
    leaves a resumable pair. The meta records the full RUN IDENTITY
    (algorithm, step sizes, thin, key fingerprint, geometry) so a resume
    with different dynamics is refused, not silently mixed."""
    from ..io import save_segment_state

    n_done = sum(int(p.shape[0]) for p in draws_parts)
    state = {
        "traces": traces,
        "eps": eps,
        "inv_mass": inv_mass,
    }
    if n_done:
        # orbax refuses zero-size arrays; the warmup-boundary checkpoint
        # simply omits the (empty) draw accumulators — meta's n_done
        # tells the restore whether to expect them
        state["draws"] = jnp.concatenate(draws_parts, axis=0)
        state["accs"] = jnp.concatenate(accs_parts)
        state["divs"] = jnp.concatenate(divs_parts)
    meta = {
        "next_segment": int(next_segment),
        "n_done": n_done,
        "d": int(inv_mass.shape[0]),
        **run_identity,
    }
    save_segment_state(checkpoint_dir, state, meta)


def _restore_sampler_state(
    checkpoint_dir, model, constraint, args, init_keys, *, n_chains,
    run_identity,
):
    """Resume point lookup: returns ``None`` when no checkpoint exists,
    else ``(traces, eps, inv_mass, draws, accs, divs, next_segment)``,
    refusing checkpoints whose recorded run identity differs. The trace
    template is rebuilt from code (structure is static — SURVEY §5
    'nearly free via pytree serialization') by executing the init
    program; leaves come from the checkpoint."""
    from ..io import check_meta_matches, load_segment_state

    def make_template(meta):
        check_meta_matches(checkpoint_dir, meta, run_identity)
        # template = the EXECUTED init program (cheap: one vmapped
        # generate): leaves carry the correct global shapes AND
        # shardings (mesh runs restore sharded), and the treedef is
        # exactly the run's
        traces_tpl = jax.jit(
            lambda ks: jax.vmap(
                lambda k: model.generate(k, constraint, args)[0],
                out_axes=-1,
            )(ks)
        )(init_keys)
        n_done, d = meta["n_done"], meta["d"]
        template = {
            "traces": traces_tpl,
            "eps": jnp.zeros((), jnp.float32),
            "inv_mass": jnp.zeros((d,)),
        }
        if n_done:
            template["draws"] = jnp.zeros((n_done, n_chains, d))
            # accs/divs are per-draw scalars: length n_done
            template["accs"] = jnp.zeros((n_done,), jnp.float32)
            template["divs"] = jnp.zeros((n_done,), jnp.float32)
        return template

    out = load_segment_state(checkpoint_dir, make_template)
    if out is None:
        return None
    state, meta = out
    d = meta["d"]
    empty = jnp.zeros((0,), jnp.float32)
    return (
        state["traces"],
        state["eps"],
        state["inv_mass"],
        state.get("draws", jnp.zeros((0, n_chains, d))),
        state.get("accs", empty),
        state.get("divs", empty),
        meta["next_segment"],
    )


def _key_fingerprint(key) -> int:
    """A stable int identifying a PRNG key for resume validation."""
    import numpy as np

    data = np.asarray(jr.key_data(key)).ravel()
    return int(np.bitwise_xor.reduce(data.astype(np.uint32)))


def _static_value_paths(chm, prefix=()):
    """Paths of every value-bearing node reachable through STATIC address
    components (the ``ColumnPacker`` address contract)."""
    v = chm.get_value()
    if v is not None:
        if not prefix:
            raise ValueError(
                "sample_posterior column algorithms (chees/pt) need an ADDRESSED "
                "model (the selection resolved to a root value — e.g. a "
                "bare Distribution); use algorithm='nuts' or 'hmc'."
            )
        return [prefix if len(prefix) > 1 else prefix[0]]
    out = []
    for a in chm.static_addresses():
        out.extend(_static_value_paths(chm.get_submap(a), prefix + (a,)))
    if not out and not chm.static_is_empty():
        raise ValueError(
            "sample_posterior column algorithms (chees/pt) need a statically "
            "addressed selection (no scan/vmap index levels); use "
            "algorithm='nuts' or 'hmc' for indexed selections."
        )
    return out



def _column_prep(model, constraint, args, selection, k_init, n_chains,
                 mesh, axis):
    """Shared setup for the column-kernel drivers (chees/pt/dense_hmc):
    resolve the selection to packer paths, build the column log-density,
    prior-initialize the chain columns, and shard them if a mesh is
    given. Returns ``(packer, ld, q0)``."""
    from ..kernels.model_interface import ColumnPacker, column_logdensity

    shape_chm = (
        model.get_zero_trace(*args).get_choices().filter_eager(selection)
    )
    paths = _static_value_paths(shape_chm)
    packer = ColumnPacker(model, constraint, args, paths)
    ld = column_logdensity(model, constraint, args, packer)

    @jax.jit
    def init(k):
        def one(kk):
            tr, _ = model.generate(kk, constraint, args)
            return packer.pack(tr.get_choices())

        return jax.vmap(one, out_axes=1)(jr.split(k, n_chains))

    q0 = init(k_init)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        q0 = jax.device_put(q0, NamedSharding(mesh, P(None, axis)))
    return packer, ld, q0


def _column_result(draws_all, packer, n_samples, thin, *, accept_rate,
                   divergence_rate, eps, inv_mass):
    """Shared results packaging for the column drivers: thin the
    collected ``(n_steps, D_padded, N)`` draws, unpack positions per
    chain, run split-R̂/ESS over the real (unpadded) dims, and map the
    per-dim diagnostics back onto the selection's pytree."""
    draws = draws_all[thin - 1 :: thin]  # (n_samples, D_padded, N)

    per_chain = jnp.moveaxis(draws, 2, 0)  # (N, n_samples, D_padded)
    positions = jax.vmap(jax.vmap(packer.unpack))(per_chain)

    real = draws[:, : packer.dim, :]
    arr = jnp.transpose(real, (2, 0, 1))  # (chains, samples, dim)
    rhat_flat, ess_flat = _column_diagnostics(arr, n_samples)
    pad = packer.padded_dim - packer.dim

    def unflatten(flat):
        return packer.unpack(
            jnp.pad(jnp.asarray(flat, jnp.float32), (0, pad))
        )

    return PosteriorSamples(
        positions=positions,
        rhat=unflatten(rhat_flat),
        ess=unflatten(ess_flat),
        accept_rate=accept_rate,
        divergence_rate=divergence_rate,
        eps=eps,
        inv_mass=inv_mass,
    )


def _sample_posterior_chees(
    key, model, constraint, args, selection, *,
    n_chains, n_warmup, n_samples, thin, eps0, target_accept, mesh, axis,
) -> PosteriorSamples:
    from ..kernels.chees import chees_hmc

    k_init, k_run = jr.split(key)
    packer, ld, q0 = _column_prep(
        model, constraint, args, selection, k_init, n_chains, mesh, axis
    )

    n_steps = n_samples * thin
    q, info = jax.jit(
        lambda q0, k: chees_hmc(
            ld, q0, k, n_warmup=n_warmup, n_steps=n_steps, eps0=eps0,
            target_accept=target_accept, collect=True,
        )
    )(q0, k_run)
    return _column_result(
        info.draws, packer, n_samples, thin,
        accept_rate=info.accept_rate,
        divergence_rate=info.divergence_rate,
        eps=info.eps,
        inv_mass=info.inv_mass[: packer.dim],
    )


def _sample_posterior_dense(
    key, model, constraint, args, selection, *,
    n_chains, n_warmup, n_samples, thin, eps0, L, target_accept, mesh,
    axis,
) -> PosteriorSamples:
    """Dense-metric column driver: full cross-chain covariance warmup
    (``kernels.dense_mass``). Warmup follows the driver contract: up to 6
    windows totalling EXACTLY ``n_warmup`` transitions (``n_warmup=0``
    disables adaptation, keeping ``eps0`` and the identity metric).
    Divergences surface as rejections (NaN trajectories are rejected
    in-kernel), so ``divergence_rate`` is 0 by construction here."""
    from ..kernels.dense_mass import (
        hmc_sweep_dense_cols,
        warmup_column_dense,
    )

    k_init, k_warm, k_run = jr.split(key, 3)
    packer, ld, q0 = _column_prep(
        model, constraint, args, selection, k_init, n_chains, mesh, axis
    )

    if n_warmup > 0:
        # up to 6 equal windows + one remainder window: the adaptation
        # budget is exactly n_warmup transitions
        n_phases = min(6, n_warmup)
        steps_per_phase = n_warmup // n_phases
        leftover = n_warmup - n_phases * steps_per_phase
        q0, eps, cov_chol = warmup_column_dense(
            ld, q0, k_warm, n_phases=n_phases,
            steps_per_phase=steps_per_phase, eps0=eps0, L=L,
            target_accept=target_accept,
        )
        if leftover:
            q0, _acc = jax.jit(
                lambda q0, cov_chol, eps: hmc_sweep_dense_cols(
                    ld, q0, jr.fold_in(k_warm, 999), n_steps=leftover,
                    eps=eps, L=L, cov_chol=cov_chol,
                )
            )(q0, cov_chol, eps)
    else:
        eps = jnp.asarray(eps0, jnp.float32)
        cov_chol = jnp.eye(q0.shape[0], dtype=jnp.float32)

    n_steps = n_samples * thin
    # eps/cov_chol ride as traced jit ARGUMENTS: re-running the driver
    # with a different adapted eps hits the compile cache instead of
    # recompiling per call
    q, accept, draws_all = jax.jit(
        lambda q0, k, cov_chol, eps: hmc_sweep_dense_cols(
            ld, q0, k, n_steps=n_steps, eps=eps, L=L,
            cov_chol=cov_chol, collect=True,
        )
    )(q0, k_run, cov_chol, eps)
    sigma = cov_chol @ cov_chol.T
    return _column_result(
        draws_all, packer, n_samples, thin,
        accept_rate=accept,
        divergence_rate=jnp.asarray(0.0),
        eps=eps,
        inv_mass=jnp.diag(sigma)[: packer.dim],
    )


def _sample_posterior_dense_nuts(
    key, model, constraint, args, selection, *,
    n_chains, n_warmup, n_samples, thin, eps0, max_depth, target_accept,
    mesh, axis,
) -> PosteriorSamples:
    """Dense-metric NUTS via whitening (Stan's dense_e + NUTS pairing).
    Warmup budget: ~n_warmup/2 dense-HMC transitions estimate the full
    covariance, then ~n_warmup/2 white-space NUTS transitions adapt eps
    (window-rounded; n_warmup=0 disables adaptation entirely). The
    returned ``eps`` is the WHITE-space step size (the integrator runs
    in whitened coordinates) — not comparable to the original-space eps
    of the other algorithms; ``inv_mass`` is the metric's original-space
    diagonal."""
    from ..kernels.adaptation import windowed_warmup
    from ..kernels.dense_mass import warmup_column_dense
    from ..kernels.nuts import nuts_sweep_cols

    k_init, k_warm, k_run = jr.split(key, 3)
    packer, ld, q0 = _column_prep(
        model, constraint, args, selection, k_init, n_chains, mesh, axis
    )
    d = q0.shape[0]

    if n_warmup > 0:
        n_a = max(1, n_warmup // 2)
        n_phases_a = min(4, n_a)
        q0, _eps_hmc, cov_chol = warmup_column_dense(
            ld, q0, k_warm, n_phases=n_phases_a,
            steps_per_phase=max(1, n_a // n_phases_a), eps0=eps0, L=5,
            target_accept=target_accept,
        )
        n_b = max(1, n_warmup - n_a)
        n_phases_b = min(6, n_b)
    else:
        cov_chol = jnp.eye(d, dtype=jnp.float32)
        n_b = 0
        n_phases_b = 0

    # seed ints for the white-space NUTS streams, derived from the
    # caller's key and passed as TRACED jit arguments (with cov_chol) so
    # repeat driver calls hit the compile cache instead of re-baking the
    # adapted metric/seed as program constants. seed_w stays in a bounded
    # range because the warmup stream constant is (seed_w+1)*1_000_003 in
    # int32; 2**11 is the widest power of two that keeps it < 2**31.
    seed_w = jr.randint(jr.fold_in(k_warm, 7), (), 0, 2**11)
    seed_r = jr.randint(jr.fold_in(k_run, 7), (), 0, 2**30)
    n_steps = n_samples * thin

    @jax.jit
    def run_white(q0, cov_chol, seed_w, seed_r):
        # whitening, white-space warmup, and sampling in ONE compiled
        # program with every call-varying value traced
        def white_ld(u):
            return ld(cov_chol @ u)

        u0 = jax.scipy.linalg.solve_triangular(cov_chol, q0, lower=True)
        if n_b:
            def sweep(u, idx, eps, inv_mass):
                u, acc, _l = nuts_sweep_cols(
                    white_ld, u, (seed_w + 1) * 1_000_003 + idx,
                    n_steps=max(1, n_b // n_phases_b), eps=eps,
                    max_depth=max_depth, inv_mass=inv_mass,
                )
                return u, acc

            u0, eps_w, inv_mass_w, _accs = windowed_warmup(
                sweep, u0, n_windows=n_phases_b, eps0=eps0,
                target_accept=target_accept,
            )
        else:
            eps_w = jnp.asarray(eps0, jnp.float32)
            inv_mass_w = jnp.ones((q0.shape[0],), jnp.float32)
        u, acc, _leaps, draws_u, div = nuts_sweep_cols(
            white_ld, u0, seed_r, n_steps=n_steps, eps=eps_w,
            max_depth=max_depth, inv_mass=inv_mass_w, collect=True,
        )
        # map the white draws back: q = L u, batched over steps
        draws_all = jnp.einsum("ij,sjn->sin", cov_chol, draws_u)
        return acc, div, eps_w, draws_all

    acc, div, eps_w, draws_all = run_white(q0, cov_chol, seed_w, seed_r)

    sigma = cov_chol @ cov_chol.T
    return _column_result(
        draws_all, packer, n_samples, thin,
        accept_rate=acc,
        divergence_rate=div,
        eps=eps_w,
        inv_mass=jnp.diag(sigma)[: packer.dim],
    )


def _sample_posterior_pt(
    key, model, constraint, args, selection, *,
    n_chains, n_warmup, n_samples, thin, eps0, L, target_accept,
    n_rungs, mesh, axis,
) -> PosteriorSamples:
    from ..kernels.pt import geometric_ladder, pt_hmc

    k_init, k_run = jr.split(key)
    packer, ld, q0 = _column_prep(
        model, constraint, args, selection, k_init, n_chains, mesh, axis
    )

    n_steps = n_samples * thin
    _q, info = jax.jit(
        lambda q0, k: pt_hmc(
            ld, q0, k, betas=geometric_ladder(n_rungs),
            n_warmup=n_warmup, n_steps=n_steps, eps0=eps0, L=L,
            target_accept=target_accept, collect=True,
        )
    )(q0, k_run)
    return _column_result(
        info.draws, packer, n_samples, thin,
        accept_rate=info.accept_rate[0],  # cold rung
        # The PT kernel classifies non-finite proposals as rejections
        # (never as divergences), so this is identically 0 by construction.
        divergence_rate=jnp.asarray(0.0),
        eps=info.eps[0],
        inv_mass=info.inv_mass[0, : packer.dim],
    )


@Pytree.dataclass
class LogdensitySamples(Pytree):
    """Draws + diagnostics from :func:`sample_logdensity`. ``draws`` is
    ``(n_chains, n_samples, D)``; ``rhat``/``ess`` are per-dimension."""

    draws: Any
    rhat: Any
    ess: Any
    accept_rate: Any
    divergence_rate: Any
    eps: Any
    inv_mass: Any


def sample_logdensity(
    key,
    logdensity_cols,
    q0,
    *,
    n_warmup: int = 300,
    n_samples: int = 100,
    thin: int = 1,
    eps0: float = 0.05,
    target_accept: float = 0.651,
) -> LogdensitySamples:
    """The one-call adaptive driver for a RAW column log-density
    ``(D, N) -> (N,)`` — for targets that do not come from a ``@gen``
    model, most importantly `parallel.data_sharded_logdensity` (big-data
    posteriors over a chains×data mesh) and hand-written potentials.

    Runs ChEES-adaptive HMC (``kernels.chees_hmc``: step size, diagonal
    mass, AND trajectory length adapted jointly from cross-chain
    statistics) from the given ``q0`` (D, N) start columns, then collects
    ``n_samples`` thinned draws with split-R̂/ESS per dimension. The
    log-density's only contract is that ``jax.vjp`` works, so sharded
    (``shard_map``/``psum``) densities drop straight in.
    """
    from ..kernels.chees import chees_hmc

    q0 = jnp.asarray(q0, jnp.float32)
    n_steps = n_samples * thin
    q, info = jax.jit(
        lambda q0, k: chees_hmc(
            logdensity_cols, q0, k, n_warmup=n_warmup, n_steps=n_steps,
            eps0=eps0, target_accept=target_accept, collect=True,
        )
    )(q0, key)
    draws = info.draws[thin - 1 :: thin]  # (n_samples, D, N)
    arr = jnp.transpose(draws, (2, 0, 1))  # (chains, samples, D)

    rhat_d, ess_d = _column_diagnostics(arr, n_samples)
    return LogdensitySamples(
        draws=arr,
        rhat=rhat_d,
        ess=ess_d,
        accept_rate=info.accept_rate,
        divergence_rate=info.divergence_rate,
        eps=info.eps,
        inv_mass=info.inv_mass,
    )
