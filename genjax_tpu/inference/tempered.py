"""Tempered SMC (SMC samplers): anneal from the prior to the posterior
through a likelihood-temperature ladder, with resampling and MCMC
rejuvenation at each rung.

Builds on the reference's ``ChangeTarget`` reweighting idea (smc.py:360)
but as a complete driver the reference lacks: the whole ladder is one
``lax.scan``; per-rung incremental weights are ``beta_{t} - beta_{t-1}``
times the log-likelihood; rejuvenation is any edit request applied per
particle.

Batching: particles are a vmapped batch (shard the axis for multi-chip);
resampling uses the gather-free counts+repeat path.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import jax.random as jr
import jax.tree_util as jtu
from jax import lax
from jax.scipy.special import logsumexp

from ..core.pytree import Pytree
from ..core.typing_ import PRNGKey
from ..generative.choice_map import ChoiceMap
from ..generative.concepts import EditRequest
from ..generative.gfi import GenerativeFunction
from ..generative.selection import Selection
from ..parallel.resampling import effective_sample_size, resample_particles


@Pytree.dataclass
class TemperedSMCResult(Pytree):
    traces: Any  # batched traces at beta=1
    log_weights: Any
    log_marginal: Any
    ess_history: Any
    accept_history: Any



def _to_rows(tree):
    return jtu.tree_map(lambda v: jnp.moveaxis(v, -1, 0), tree)


def _to_lanes(tree):
    return jtu.tree_map(lambda v: jnp.moveaxis(v, 0, -1), tree)


def _resample_block(resample_key, traces, llhs, log_w, log_z, k, method):
    """Resample (lanes layout in, lanes layout out) and fold the current
    normalizer into log_z — the one place the evidence increment lives."""
    inc = logsumexp(log_w) - jnp.log(k)
    rows, llhs = resample_particles(
        resample_key, (_to_rows(traces), llhs), log_w, k, method
    )
    return _to_lanes(rows), llhs, jnp.zeros((k,)), log_z + inc


def tempered_smc(
    key: PRNGKey,
    model: GenerativeFunction,
    constraint: ChoiceMap,
    args: tuple,
    *,
    n_particles: int,
    betas,
    rejuvenation: EditRequest | Selection | None = None,
    n_rejuvenation: int = 1,
    ess_threshold: float = 0.5,
    method: str = "systematic",
) -> TemperedSMCResult:
    """Run tempered SMC over the ladder ``betas`` (ascending, ending at 1).

    The tempered target at rung ``t`` is
    ``prior(z) * likelihood(z)^beta_t``; since ``generate`` under the
    constraint returns weight = log-likelihood of the constrained choices,
    the incremental weight at each rung is ``(beta_t - beta_{t-1}) * llh``.
    """
    betas = jnp.asarray(betas)
    k = n_particles

    # The tempered-target correction alpha = w - (1-beta)*dllh composes
    # around PROPOSAL-style requests whose returned weight is the
    # full-posterior MH log-alpha of a not-yet-accepted move (HMC, MALA,
    # Rejuvenate); NUTS accepts internally, hence the shared rejection.
    _validate_rejuvenation(rejuvenation)

    # Distinct parents for particle-init keys vs per-rung keys: with
    # fold_in(key, t) == split(key, k)[t] in this JAX version, deriving
    # rung keys directly from ``key`` would make rung t's resampling /
    # rejuvenation randomness an exact function of particle t's init draw.
    init_key, ladder_key = jr.split(key)

    # initialize at beta = 0: particles from the prior, llh recorded.
    # Particle axis on the LANES (last axis) for the model-evaluation work
    # (see ARCHITECTURE §2: small per-particle event dims waste lanes
    # behind a leading batch axis); resampling transposes to rows, where
    # contiguous movement is fast, and back.
    init_keys = jr.split(init_key, k)

    def init_one(kk):
        tr, llh = model.generate(kk, constraint, args)
        return tr, llh

    traces, llhs = jax.vmap(init_one, out_axes=(-1, 0))(init_keys)
    rejuvenate = _make_rejuvenator(
        constraint, rejuvenation, n_rejuvenation, k
    )

    def rung(state, inp):
        traces, llhs, log_w, log_z = state
        t, beta_prev, beta = inp
        rung_key = jr.fold_in(ladder_key, t)
        log_w = log_w + (beta - beta_prev) * llhs

        ess = effective_sample_size(log_w)

        traces, llhs, log_w, log_z = lax.cond(
            ess < ess_threshold * k,
            lambda o: _resample_block(
                jr.fold_in(rung_key, 1), *o, k=k, method=method
            ),
            lambda o: o,
            (traces, llhs, log_w, log_z),
        )

        # MCMC rejuvenation targeting the tempered posterior
        # prior(z) * llh(z)^beta — shared sweep (see _make_rejuvenator for
        # the Regenerate→MH-alpha conversion notes).
        traces, llhs, accept_rate = rejuvenate(
            traces, llhs, beta, jr.fold_in(rung_key, 2)
        )

        return (traces, llhs, log_w, log_z), (ess, accept_rate)

    beta_prevs = jnp.concatenate([jnp.zeros(1), betas[:-1]])
    init_state = (traces, llhs, jnp.zeros((k,)), jnp.asarray(0.0))
    (traces, llhs, log_w, log_z), (ess_hist, acc_hist) = lax.scan(
        rung,
        init_state,
        (jnp.arange(betas.shape[0]), beta_prevs, betas),
    )
    log_marginal = log_z + logsumexp(log_w) - jnp.log(k)
    # restore the conventional particles-leading layout on the outputs
    return TemperedSMCResult(
        _to_rows(traces), log_w, log_marginal, ess_hist, acc_hist
    )


@Pytree.dataclass
class AdaptiveTemperedSMCResult(Pytree):
    traces: Any
    log_weights: Any
    log_marginal: Any
    beta_history: Any  # (max_rungs,); idle tail repeats the final beta
    final_beta: Any  # 1.0 on success — if < 1 the ladder EXHAUSTED
    #   max_rungs and log_marginal estimates the partially tempered
    #   target's normalizer, NOT the evidence: raise max_rungs or lower
    #   cess_target
    n_rungs: Any
    ess_history: Any  # 0.0 after termination (mask by n_rungs)
    accept_history: Any


def adaptive_tempered_smc(
    key: PRNGKey,
    model: GenerativeFunction,
    constraint: ChoiceMap,
    args: tuple,
    *,
    n_particles: int,
    cess_target: float = 0.9,
    max_rungs: int = 64,
    n_bisect: int = 30,
    rejuvenation: EditRequest | Selection | None = None,
    n_rejuvenation: int = 1,
    ess_threshold: float = 0.5,
    method: str = "systematic",
) -> AdaptiveTemperedSMCResult:
    """Tempered SMC with the ladder chosen ON-LINE (Zhou, Johansen &
    Aston 2016): each rung's temperature increment is found by bisection
    so the CONDITIONAL ESS of the incremental weights stays at
    ``cess_target``·N — steep likelihoods get dense rungs automatically,
    flat ones are crossed in a few. Fixed shapes throughout: one
    ``lax.scan`` of ``max_rungs`` steps with no-op masking after β
    reaches 1, so the adaptive program jits exactly like the fixed-ladder
    one. Same rejuvenation semantics as :func:`tempered_smc`."""
    k = n_particles
    if not 0.0 < cess_target < 1.0:
        raise ValueError(
            f"cess_target must be in (0, 1), got {cess_target} — at 1.0 "
            "the bisection returns a zero temperature increment forever"
        )
    _validate_rejuvenation(rejuvenation)
    init_key, ladder_key = jr.split(key)

    def init_one(kk):
        tr, llh = model.generate(kk, constraint, args)
        return tr, llh

    traces, llhs = jax.vmap(init_one, out_axes=(-1, 0))(
        jr.split(init_key, k)
    )

    def cess(log_w, llhs, delta):
        """Conditional ESS of incremental weights exp(delta·llh) under the
        current normalized weights (Zhou et al. 2016 eq. 3.2)."""
        logW = log_w - logsumexp(log_w)
        lu = delta * llhs
        num = 2.0 * logsumexp(logW + lu)
        den = logsumexp(logW + 2.0 * lu)
        return k * jnp.exp(num - den)

    def choose_delta(log_w, llhs, beta):
        """Bisect delta in (0, 1−beta] so CESS ≈ cess_target·k."""
        hi0 = 1.0 - beta
        target = cess_target * k

        def body(_, bounds):
            lo, hi = bounds
            mid = 0.5 * (lo + hi)
            too_big = cess(log_w, llhs, mid) < target
            return jnp.where(too_big, lo, mid), jnp.where(too_big, mid, hi)

        full = cess(log_w, llhs, hi0) >= target
        lo, hi = lax.fori_loop(0, n_bisect, body, (jnp.asarray(0.0), hi0))
        return jnp.where(full, hi0, lo)

    rejuvenate = _make_rejuvenator(
        constraint, rejuvenation, n_rejuvenation, k
    )

    def rung(state, t):
        traces, llhs, log_w, log_z, beta, done = state
        rung_key = jr.fold_in(ladder_key, t)

        def active(operand):
            traces, llhs, log_w, log_z, beta, _ = operand
            delta = choose_delta(log_w, llhs, beta)
            beta_new = jnp.minimum(beta + delta, 1.0)
            log_w = log_w + delta * llhs
            ess = effective_sample_size(log_w)

            traces, llhs, log_w, log_z = lax.cond(
                ess < ess_threshold * k,
                lambda o: _resample_block(
                    jr.fold_in(rung_key, 1), *o, k=k, method=method
                ),
                lambda o: o,
                (traces, llhs, log_w, log_z),
            )
            traces, llhs, acc = rejuvenate(
                traces, llhs, beta_new, jr.fold_in(rung_key, 2)
            )
            return (
                (traces, llhs, log_w, log_z, beta_new, beta_new >= 1.0),
                (beta_new, ess, acc, jnp.asarray(1.0)),
            )

        def idle(operand):
            traces, llhs, log_w, log_z, beta, done = operand
            return (
                (traces, llhs, log_w, log_z, beta, done),
                # finite idle sentinels: mask histories by n_rungs
                (beta, jnp.asarray(0.0), jnp.asarray(0.0), jnp.asarray(0.0)),
            )

        return lax.cond(done, idle, active, state)

    init_state = (
        traces,
        llhs,
        jnp.zeros((k,)),
        jnp.asarray(0.0),
        jnp.asarray(0.0),
        jnp.asarray(False),
    )
    (traces, llhs, log_w, log_z, final_beta, _done), (
        beta_hist,
        ess_hist,
        acc_hist,
        active_hist,
    ) = lax.scan(rung, init_state, jnp.arange(max_rungs))
    log_marginal = log_z + logsumexp(log_w) - jnp.log(k)
    return AdaptiveTemperedSMCResult(
        traces=_to_rows(traces),
        log_weights=log_w,
        log_marginal=log_marginal,
        beta_history=beta_hist,
        final_beta=final_beta,
        n_rungs=jnp.sum(active_hist),
        ess_history=ess_hist,
        accept_history=acc_hist,
    )


def _validate_rejuvenation(rejuvenation):
    if rejuvenation is not None and not isinstance(rejuvenation, Selection):
        from ..generative.concepts import DiffAnnotate
        from .requests.nuts import NUTS as _NUTS

        inner_req = rejuvenation
        while isinstance(inner_req, DiffAnnotate):
            inner_req = inner_req.request
        if isinstance(inner_req, _NUTS):
            raise ValueError(
                "tempered-SMC rejuvenation does not support NUTS: it "
                "accepts internally, so the tempered-target MH "
                "correction cannot be composed around it. Use HMC, "
                "MALA, Rejuvenate, or a Selection (prior Regenerate)."
            )


def _make_rejuvenator(constraint, rejuvenation, n_rejuvenation, k):
    """Shared tempered-target rejuvenation sweep: ``(traces, llhs, beta,
    key) -> (traces, llhs, accept_rate)`` — the MH correction
    ``alpha = w − (1 − beta)·Δllh`` documented in :func:`tempered_smc`."""
    if rejuvenation is None:
        return lambda traces, llhs, beta, key: (
            traces,
            llhs,
            jnp.asarray(0.0),
        )

    from ..generative.concepts import Regenerate

    request = (
        Regenerate(rejuvenation)
        if isinstance(rejuvenation, Selection)
        else rejuvenation
    )
    is_prior_regen = isinstance(request, Regenerate)

    def rejuvenate(traces, llhs, beta, key):
        def rejuv_once(carry, kk):
            traces, llhs = carry

            def per_particle(kp, tr, llh):
                new_tr, w, _rd, _bwd = tr.edit(jr.fold_in(kp, 0), request)
                new_llh = _constrained_score(constraint, new_tr)
                dllh = new_llh - llh
                if is_prior_regen:
                    sel = request.selection
                    w = w - (
                        new_tr.project(jr.fold_in(kp, 2), sel)
                        - tr.project(jr.fold_in(kp, 3), sel)
                    )
                alpha = w - (1.0 - beta) * dllh
                accept = jnp.log(jr.uniform(jr.fold_in(kp, 1))) < alpha
                out_tr = jtu.tree_map(
                    lambda a, b: jnp.where(accept, a, b), new_tr, tr
                )
                out_llh = jnp.where(accept, new_llh, llh)
                return out_tr, out_llh, jnp.asarray(accept, jnp.float32)

            pkeys = jr.split(kk, k)
            traces, llhs, accs = jax.vmap(
                per_particle, in_axes=(0, -1, 0), out_axes=(-1, 0, 0)
            )(pkeys, traces, llhs)
            return (traces, llhs), jnp.mean(accs)

        (traces, llhs), accs = lax.scan(
            rejuv_once, (traces, llhs), jr.split(key, n_rejuvenation)
        )
        return traces, llhs, jnp.mean(accs)

    return rejuvenate


def _constrained_score(constraint, trace):
    """Log-likelihood of the constrained (observation) choices under the
    trace's latents: the trace score projected onto the constraint's
    addresses (exact for exact-density models)."""
    return trace.project(jr.key(0), constraint.get_selection())


def geometric_ladder(n: int, power: float = 3.0):
    """An ascending temperature ladder in (0, 1], denser near 0."""
    return (jnp.arange(1, n + 1) / n) ** power
