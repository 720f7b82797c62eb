"""``LinearGaussianSSM``: exact-posterior distribution over the latent
path of a (multivariate) linear-Gaussian state-space model.

The continuous analog of ``DiscreteHMM`` (reference
``/root/reference/src/genjax/_src/generative_functions/distributions/
custom/discrete_hmm.py`` — the reference has no linear-Gaussian
counterpart): Kalman forward filtering, RTS smoothing, and
forward-filtering backward-sampling (FFBS), all exact, packaged both as
plain functions and as a ``Distribution`` whose ``random_weighted`` draws
a whole latent path from the true posterior with its exact density.

Model:  z_0 ~ N(mu0, P0);  z_t = A z_{t-1} + w_t, w_t ~ N(0, Q);
        y_t = C z_t + v_t, v_t ~ N(0, R),  observations t = 0..T-1 on z_t
        (the first observation is of z_0 — i.e. y_0 ~ N(C z_0, R)).

Formulation: each pass is one ``lax.scan`` whose per-step work is dense
(Dz, Dz) matmuls and solves — matmul-bound for large state dims, and the
whole FFBS (two scans) jits into a single program. Serves as the exact
testbed for particle filters, particle Gibbs, and SMC² (which all
hand-roll scalar Kalman recursions in their tests otherwise).
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import jax.random as jr
import jax.tree_util as jtu
from jax import lax

from ..core.pytree import Pytree
from ..core.typing_ import PRNGKey
from .distribution import Distribution

_LOG_2PI = 1.8378770664093453


@Pytree.dataclass
class LGSSMParams(Pytree):
    """Dense LGSSM parameters (all dynamic — jit/vmap/grad over them)."""

    A: Any  # (Dz, Dz) transition
    Q: Any  # (Dz, Dz) transition noise covariance
    C: Any  # (Dy, Dz) observation matrix
    R: Any  # (Dy, Dy) observation noise covariance
    mu0: Any  # (Dz,) initial mean
    P0: Any  # (Dz, Dz) initial covariance

    @staticmethod
    def scalar(a, q, c=1.0, r=1.0, mu0=0.0, p0=None):
        """1-D convenience constructor from scalar coefficients;
        ``q``/``r``/``p0`` are VARIANCES. ``p0`` defaults to ``q``."""
        one = lambda v: jnp.asarray(v, jnp.float32).reshape(1, 1)
        return LGSSMParams(
            A=one(a),
            Q=one(q),
            C=one(c),
            R=one(r),
            mu0=jnp.asarray(mu0, jnp.float32).reshape(1),
            P0=one(q if p0 is None else p0),
        )


def _mvn_logpdf(x, mean, cov):
    d = x.shape[-1]
    chol = jnp.linalg.cholesky(cov)
    a = jax.scipy.linalg.solve_triangular(chol, x - mean, lower=True)
    return (
        -0.5 * jnp.sum(a * a)
        - jnp.sum(jnp.log(jnp.diag(chol)))
        - 0.5 * d * _LOG_2PI
    )


def kalman_update(mean_pred, cov_pred, C, R, y):
    """One Kalman measurement update: returns ``(mean_f, cov_f, ll)`` with
    ``ll`` the exact predictive density ``log p(y | pred)``. Shared by
    :func:`kalman_filter` and the Rao-Blackwellized PF
    (`parallel/rbpf.py`) so the numerically delicate gain/covariance
    algebra lives in one place."""
    s = C @ cov_pred @ C.T + R
    resid = y - C @ mean_pred
    ll = _mvn_logpdf(resid, jnp.zeros_like(resid), s)
    gain = jnp.linalg.solve(s, C @ cov_pred).T
    mean_f = mean_pred + gain @ resid
    cov_f = cov_pred - gain @ s @ gain.T
    return mean_f, cov_f, ll


def kalman_filter(params: LGSSMParams, ys):
    """Forward pass. ``ys``: (T, Dy). Returns ``(filtered_means (T, Dz),
    filtered_covs (T, Dz, Dz), log_marginal)`` where ``log_marginal`` is
    the exact ``log p(y_{0:T-1})``."""
    A, Q, C, R = params.A, params.Q, params.C, params.R

    def step(carry, y):
        mean_pred, cov_pred = carry
        mean_f, cov_f, ll = kalman_update(mean_pred, cov_pred, C, R, y)
        # predict next
        return (A @ mean_f, A @ cov_f @ A.T + Q), (mean_f, cov_f, ll)

    (_, _), (means, covs, lls) = lax.scan(
        step, (params.mu0, params.P0), ys
    )
    return means, covs, jnp.sum(lls)


def kalman_filter_parallel(params: LGSSMParams, ys):
    """Temporally PARALLEL Kalman filtering (Särkkä & García-Fernández
    2021) via ``lax.associative_scan``: each step becomes a five-matrix
    filtering element ``(A, b, C, eta, J)`` whose composition is
    associative, so the T-long sequential dependency chain of
    :func:`kalman_filter` collapses to O(log T) DEPTH of batched (Dz, Dz)
    matmuls/solves — the parallel formulation for long series. Returns
    ``(filtered_means, filtered_covs)`` equal to the sequential filter's
    (up to roundoff); the log-marginal needs the sequential pass (or the
    paper's extended elements).
    """
    A, Q, C, R = params.A, params.Q, params.C, params.R
    dz = params.mu0.shape[0]
    I = jnp.eye(dz)

    # --- generic element for steps 1..T-1 ---
    S = C @ Q @ C.T + R

    def make_element(y):
        K = jnp.linalg.solve(S, C @ Q).T  # Q C^T S^{-1}
        A_e = (I - K @ C) @ A
        b_e = K @ y
        C_e = (I - K @ C) @ Q
        HtSi = jnp.linalg.solve(S, C).T  # C^T S^{-1}
        eta_e = A.T @ HtSi @ y
        J_e = A.T @ HtSi @ C @ A
        return A_e, b_e, C_e, eta_e, J_e

    elems = jax.vmap(make_element)(ys[1:])

    # --- first element: the prior-and-update at step 0 ---
    S0 = C @ params.P0 @ C.T + R
    K0 = jnp.linalg.solve(S0, C @ params.P0).T
    b0 = params.mu0 + K0 @ (ys[0] - C @ params.mu0)
    C0 = params.P0 - K0 @ C @ params.P0
    first = (
        jnp.zeros((dz, dz)),
        b0,
        C0,
        jnp.zeros(dz),
        jnp.zeros((dz, dz)),
    )
    elems = jtu.tree_map(
        lambda f, r: jnp.concatenate([f[None], r], axis=0), first, elems
    )

    def combine(e_i, e_j):
        A_i, b_i, C_i, eta_i, J_i = e_i
        A_j, b_j, C_j, eta_j, J_j = e_j
        # batched over the scan's tree levels: leading dims ride along
        G = jnp.linalg.solve(
            jnp.swapaxes(I + C_i @ J_j, -1, -2), jnp.swapaxes(A_j, -1, -2)
        )
        G = jnp.swapaxes(G, -1, -2)  # A_j (I + C_i J_j)^{-1}
        E = jnp.linalg.solve(
            jnp.swapaxes(I + J_j @ C_i, -1, -2), A_i
        )  # ((I + J_j C_i)^{-T})^{-1}... transpose trick below
        # A_i^T (I + J_j C_i)^{-1} == solve((I + J_j C_i)^T, A_i)^T
        E = jnp.swapaxes(E, -1, -2)
        A_ij = G @ A_i
        b_ij = (G @ (b_i[..., :, None] + C_i @ eta_j[..., :, None]))[
            ..., :, 0
        ] + b_j
        C_ij = G @ C_i @ jnp.swapaxes(A_j, -1, -2) + C_j
        eta_ij = (
            E @ (eta_j[..., :, None] - J_j @ b_i[..., :, None])
        )[..., :, 0] + eta_i
        J_ij = E @ J_j @ A_i + J_i
        return A_ij, b_ij, C_ij, eta_ij, J_ij

    prefix = lax.associative_scan(combine, elems)
    _, means, covs, _, _ = prefix
    return means, covs


def kalman_smoother_parallel(params: LGSSMParams, ys):
    """Temporally PARALLEL RTS smoothing: the backward recursion
    ``x_k | x_{k+1}, y_{0:k} ~ N(E_k x_{k+1} + g_k, L_k)`` composes
    associatively (``combine(a, b) = (E_a E_b, E_a g_b + g_a,
    E_a L_b E_aᵀ + L_a)``), so after a parallel filtering pass the
    smoothed marginals come from one reversed ``associative_scan`` —
    O(log T) total depth. Returns ``(smoothed_means, smoothed_covs)``
    equal to :func:`kalman_smoother`'s (up to roundoff)."""
    A, Q = params.A, params.Q
    means_f, covs_f = kalman_filter_parallel(params, ys)

    def make_element(m_f, P_f):
        cov_pred = A @ P_f @ A.T + Q
        E = jnp.linalg.solve(cov_pred, A @ P_f).T  # P_f Aᵀ cov_pred⁻¹
        g = m_f - E @ A @ m_f
        L = P_f - E @ A @ P_f
        return E, g, L

    E_r, g_r, L_r = jax.vmap(make_element)(means_f[:-1], covs_f[:-1])
    dz = params.mu0.shape[0]
    last = (jnp.zeros((dz, dz)), means_f[-1], covs_f[-1])
    elems = jtu.tree_map(
        lambda r, f: jnp.concatenate([r, f[None]], axis=0),
        (E_r, g_r, L_r),
        last,
    )

    def combine(a, b):
        E_a, g_a, L_a = a
        E_b, g_b, L_b = b
        return (
            E_a @ E_b,
            (E_a @ g_b[..., :, None])[..., :, 0] + g_a,
            E_a @ L_b @ jnp.swapaxes(E_a, -1, -2) + L_a,
        )

    # ordered suffix composition elem_k ⊗ … ⊗ elem_{T-1}: flip operands in
    # the reverse scan (same trick as hmm_tools.forward_backward_parallel)
    _, means_s, covs_s = lax.associative_scan(
        lambda a, b: combine(b, a), elems, reverse=True
    )
    return means_s, covs_s


def kalman_smoother(params: LGSSMParams, ys):
    """RTS smoothing. Returns ``(smoothed_means, smoothed_covs,
    log_marginal)``. (One RTS recursion lives in
    :func:`_smoother_with_lag1`; this is the lag-free view of it.)"""
    means_s, covs_s, _lag1, log_marginal = _smoother_with_lag1(params, ys)
    return means_s, covs_s, log_marginal


def ffbs(key: PRNGKey, params: LGSSMParams, ys):
    """Forward-filtering backward-sampling: one exact joint draw
    ``z_{0:T-1} ~ p(z | y)``. Returns ``(zs (T, Dz), log_marginal)``."""
    A, Q = params.A, params.Q
    means_f, covs_f, log_marginal = kalman_filter(params, ys)

    def draw(k, mean, cov):
        chol = jnp.linalg.cholesky(cov)
        return mean + chol @ jr.normal(k, mean.shape)

    k_last, k_rest = jr.split(key)
    z_last = draw(k_last, means_f[-1], covs_f[-1])

    def step(z_next, inp):
        k, mean_f, cov_f = inp
        cov_pred = A @ cov_f @ A.T + Q
        gain = jnp.linalg.solve(cov_pred, A @ cov_f).T
        mean_c = mean_f + gain @ (z_next - A @ mean_f)
        cov_c = cov_f - gain @ A @ cov_f
        # symmetrize for the Cholesky (pure roundoff asymmetry)
        cov_c = 0.5 * (cov_c + cov_c.T)
        z = draw(k, mean_c, cov_c)
        return z, z

    T = ys.shape[0]
    keys = jr.split(k_rest, T - 1)
    _, zs = lax.scan(
        step, z_last, (keys, means_f[:-1], covs_f[:-1]), reverse=True
    )
    zs = jnp.concatenate([zs, z_last[None]], axis=0)
    return zs, log_marginal


def kalman_predict(params: LGSSMParams, ys, horizon: int):
    """Exact h-step-ahead forecasting after assimilating ``ys``: returns
    ``(z_means (h, Dz), z_covs (h, Dz, Dz), y_means (h, Dy),
    y_covs (h, Dy, Dy))`` — the predictive laws of
    ``z_{T-1+k}, y_{T-1+k} | y_{0:T-1}`` for k = 1..horizon."""
    A, Q, C, R = params.A, params.Q, params.C, params.R
    means_f, covs_f, _ = kalman_filter(params, ys)

    def step(carry, _):
        mean, cov = carry
        mean, cov = A @ mean, A @ cov @ A.T + Q
        return (mean, cov), (mean, cov, C @ mean, C @ cov @ C.T + R)

    _, (z_means, z_covs, y_means, y_covs) = lax.scan(
        step, (means_f[-1], covs_f[-1]), None, length=horizon
    )
    return z_means, z_covs, y_means, y_covs


def _smoother_with_lag1(params: LGSSMParams, ys):
    """RTS smoothing plus the lag-one smoothed cross-covariances
    ``P_{t+1,t|T} = cov(z_{t+1}, z_t | y)`` the EM M-step needs."""
    A, Q = params.A, params.Q
    means_f, covs_f, log_marginal = kalman_filter(params, ys)

    def step(carry, inp):
        mean_next, cov_next = carry
        mean_f, cov_f = inp
        cov_pred = A @ cov_f @ A.T + Q
        gain = jnp.linalg.solve(cov_pred, A @ cov_f).T  # J_t
        mean_s = mean_f + gain @ (mean_next - A @ mean_f)
        cov_s = cov_f + gain @ (cov_next - cov_pred) @ gain.T
        # cov(z_{t+1}, z_t | y) = P_{t+1|T} J_t^T
        lag1 = cov_next @ gain.T
        return (mean_s, cov_s), (mean_s, cov_s, lag1)

    last = (means_f[-1], covs_f[-1])
    _, (means_s, covs_s, lag1) = lax.scan(
        step, last, (means_f[:-1], covs_f[:-1]), reverse=True
    )
    means_s = jnp.concatenate([means_s, means_f[-1:]], axis=0)
    covs_s = jnp.concatenate([covs_s, covs_f[-1:]], axis=0)
    return means_s, covs_s, lag1, log_marginal


def lgssm_em(
    params: LGSSMParams, ys, *, n_iters: int = 20, fit: tuple = ("A", "Q", "C", "R")
):
    """EM (Shumway & Stoffer 1982) for LGSSM parameters: each iteration is
    one Kalman smoothing pass (E-step) and closed-form updates of the
    selected matrices (M-step) — log-marginal ascent is guaranteed, and
    the whole fit is one ``lax.scan`` of dense matmuls.

    Returns ``(fitted_params, log_marginals (n_iters,))``. ``mu0``/``P0``
    are held fixed (they are weakly identified from one series); pass
    ``fit`` to freeze any of A/Q/C/R as well.
    """
    ys = jnp.asarray(ys)
    T = ys.shape[0]

    def one_iter(p, _):
        means_s, covs_s, lag1, lm = _smoother_with_lag1(p, ys)
        # sufficient statistics: E[z_t z_t^T | y] = P_t|T + m_t m_t^T
        ezz = covs_s + means_s[:, :, None] * means_s[:, None, :]
        # E[z_{t+1} z_t^T | y] = lag1_t + m_{t+1} m_t^T
        ezz1 = lag1 + means_s[1:, :, None] * means_s[:-1, None, :]
        s00 = jnp.sum(ezz[:-1], axis=0)
        s11 = jnp.sum(ezz[1:], axis=0)
        s10 = jnp.sum(ezz1, axis=0)
        A_new = jnp.linalg.solve(s00.T, s10.T).T if "A" in fit else p.A
        Q_new = (
            (s11 - A_new @ s10.T - s10 @ A_new.T + A_new @ s00 @ A_new.T)
            / (T - 1)
            if "Q" in fit
            else p.Q
        )
        syz = jnp.einsum("ti,tj->ij", ys, means_s)
        szz = jnp.sum(ezz, axis=0)
        C_new = jnp.linalg.solve(szz.T, syz.T).T if "C" in fit else p.C
        if "R" in fit:
            resid = ys - means_s @ C_new.T
            R_new = (
                jnp.einsum("ti,tj->ij", resid, resid)
                + C_new @ jnp.sum(covs_s, axis=0) @ C_new.T
            ) / T
        else:
            R_new = p.R
        sym = lambda m: 0.5 * (m + m.T)
        p_new = LGSSMParams(
            A=A_new, Q=sym(Q_new), C=C_new, R=sym(R_new),
            mu0=p.mu0, P0=p.P0,
        )
        return p_new, lm

    fitted, lms = lax.scan(one_iter, params, None, length=n_iters)
    return fitted, lms


def path_log_joint(params: LGSSMParams, zs, ys):
    """Exact ``log p(z_{0:T-1}, y_{0:T-1})``."""
    A, Q, C, R = params.A, params.Q, params.C, params.R
    lp = _mvn_logpdf(zs[0], params.mu0, params.P0)

    def trans(prev, z):
        return z, _mvn_logpdf(z, A @ prev, Q)

    _, lts = lax.scan(trans, zs[0], zs[1:])

    def obs(z, y):
        return _mvn_logpdf(y, C @ z, R)

    los = jax.vmap(obs)(zs, ys)
    return lp + jnp.sum(lts) + jnp.sum(los)


def exact_path_log_posterior(params: LGSSMParams, zs, ys, log_marginal=None):
    """``log p(z | y) = log p(z, y) − log p(y)`` (exact)."""
    if log_marginal is None:
        _, _, log_marginal = kalman_filter(params, ys)
    return path_log_joint(params, zs, ys) - log_marginal


@Pytree.dataclass
class _LGSSMLatentPathPosterior(Distribution):
    """Exact sampling + exact density for LGSSM latent paths given
    observations (the DiscreteHMM pattern — discrete_hmm.py:185 here).
    Args: ``(params, ys)``."""

    def random_weighted(self, key: PRNGKey, *args):
        params, ys = args
        zs, log_marginal = ffbs(key, params, ys)
        w = exact_path_log_posterior(params, zs, ys, log_marginal)
        return w, zs

    def estimate_logpdf(self, key: PRNGKey, v, *args):
        params, ys = args
        return exact_path_log_posterior(params, v, ys)

    def assess(self, chm, args):
        v = chm.get_value()
        from ..generative.mask import Mask

        if isinstance(v, Mask):
            v = v.value
        params, ys = args
        return exact_path_log_posterior(params, v, ys), v

    def data_logpdf(self, params, ys):
        """Exact ``log p(y_{0:T-1})``."""
        _, _, log_marginal = kalman_filter(params, ys)
        return log_marginal


LinearGaussianSSM = _LGSSMLatentPathPosterior()
