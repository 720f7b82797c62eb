"""Special math for the distribution catalog.

The reference gets these from TensorFlow Probability's substrate
(``/root/reference/src/genjax/_src/generative_functions/distributions/
tensorflow_probability/__init__.py``); here they are implemented directly on
XLA-friendly fixed-iteration algorithms (static shapes, no data-dependent
Python control flow — everything is elementwise).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.special import gammaln
import jax.random as jr


def _log_iv_hankel(v, x, num_terms: int = 10):
    """Hankel's large-argument expansion ``I_v(x) ~ e^x/sqrt(2 pi x) *
    sum_k (-1)^k a_k(v)/x^k`` — accurate for ``x >> v^2`` (used for
    small orders)."""
    t = jnp.ones_like(x)
    s = t
    for k in range(1, num_terms):
        t = t * -(4.0 * v * v - (2.0 * k - 1.0) ** 2) / (k * 8.0 * x)
        s = s + t
    return x - 0.5 * jnp.log(2.0 * jnp.pi * x) + jnp.log(jnp.maximum(s, 1e-30))


def _log_iv_uniform(v, x):
    """Olver's uniform large-order expansion (A&S 9.7.7): valid uniformly
    in ``x/v`` for large ``v`` (rel. error ~ v^-4 with three u_k terms)."""
    z = x / v
    s = jnp.sqrt(1.0 + z * z)
    t = 1.0 / s
    eta = s + jnp.log(z / (1.0 + s))
    u1 = (3.0 * t - 5.0 * t**3) / 24.0
    u2 = (81.0 * t**2 - 462.0 * t**4 + 385.0 * t**6) / 1152.0
    u3 = (
        30375.0 * t**3
        - 369603.0 * t**5
        + 765765.0 * t**7
        - 425425.0 * t**9
    ) / 414720.0
    corr = 1.0 + u1 / v + u2 / v**2 + u3 / v**3
    return (
        -0.5 * jnp.log(2.0 * jnp.pi * v)
        + v * eta
        - 0.5 * jnp.log(s)
        + jnp.log(jnp.maximum(corr, 1e-30))
    )


def log_bessel_iv(v, x, num_terms: int = 512):
    """log I_v(x) for v >= 0, x >= 0, accurate across the whole range:

    - ``x < 400``: the ascending series ``I_v(x) = sum_m (x/2)^(2m+v) /
      (m! Gamma(m+v+1))`` in log space (``logsumexp`` over ``num_terms``
      static terms; the term peak sits at m* <= x/2, so 512 terms cover
      x < 400 for every order),
    - ``x >= 400``: Hankel's expansion for orders ``v <= 10`` and Olver's
      uniform large-order expansion otherwise — the series would need
      ~x/2 terms and silently underestimates beyond its budget (skellam /
      von_mises_fisher with large parameters hit this).

    All shapes static; branches are clamp-guarded so the unselected
    ``where`` branch stays finite (NaN-safe gradients)."""
    v = jnp.asarray(v, jnp.float32)
    x = jnp.asarray(x, jnp.float32)
    m = jnp.arange(num_terms, dtype=jnp.float32)
    # broadcast: terms over a new leading axis
    bshape = jnp.broadcast_shapes(jnp.shape(v), jnp.shape(x))
    log_half_x = jnp.log(jnp.maximum(x, 1e-30) / 2.0)
    mb = m[(...,) + (None,) * len(bshape)]
    terms = (
        (2.0 * mb + v) * log_half_x
        - gammaln(mb + 1.0)
        - gammaln(mb + v + 1.0)
    )
    series = jax.scipy.special.logsumexp(terms, axis=0)
    x_lg = jnp.maximum(x, 1.0)
    large = jnp.where(
        v <= 10.0,
        _log_iv_hankel(v, x_lg),
        _log_iv_uniform(jnp.maximum(v, 1.0), x_lg),
    )
    out = jnp.where(x < 400.0, series, large)
    # I_v(0) = 1 if v == 0 else 0
    at_zero = jnp.where(v == 0.0, 0.0, -jnp.inf)
    return jnp.where(x == 0.0, at_zero, out)


def log_bessel_i0(x):
    """log I_0(x), exact for all x via the exponentially-scaled ``i0e``."""
    x = jnp.asarray(x)
    return jnp.log(jax.scipy.special.i0e(x)) + jnp.abs(x)


def lambertw(z, iters: int = 32):
    """Principal branch W_0(z) for z >= -1/e via Halley iteration."""
    z = jnp.asarray(z, jnp.float32)
    # initial guess: log-based for large z, series for small
    w0 = jnp.where(
        z > jnp.e,
        jnp.log(jnp.maximum(z, 1e-30)) - jnp.log(jnp.maximum(jnp.log(jnp.maximum(z, 1e-30)), 1e-30)),
        jnp.where(z > 0, z / (1.0 + z), z * (1.0 - z)),
    )

    def body(_, w):
        ew = jnp.exp(w)
        f = w * ew - z
        wp1 = w + 1.0
        denom = ew * wp1 - (w + 2.0) * f / (2.0 * wp1)
        return w - f / jnp.where(jnp.abs(denom) < 1e-30, 1e-30, denom)

    return lax.fori_loop(0, iters, body, w0)


def erfcinv(u):
    return jax.scipy.special.erfinv(1.0 - u)


# ------------------------------------------------------------------
# fixed-iteration rejection samplers (masked accept; static shapes)
# ------------------------------------------------------------------

_REJECTION_ROUNDS = 64


def _masked_rejection(key, propose, shape, rounds: int = _REJECTION_ROUNDS):
    """Generic fixed-round rejection: ``propose(key) -> (sample, accept)``
    of the given shape; keeps the first accepted proposal per lane."""

    def body(i, carry):
        out, done, key = carry
        key, sub = jr.split(key)
        cand, acc = propose(sub)
        take = acc & ~done
        out = jnp.where(take, cand, out)
        done = done | acc
        return out, done, key

    key, sub = jr.split(key)
    init, acc0 = propose(sub)
    out, _, _ = lax.fori_loop(
        0, rounds, body, (init, acc0, key)
    )
    return out


def von_mises_sample(key, loc, concentration, shape=()):
    """Best-Fisher (1979) wrapped-Cauchy rejection sampler for von Mises."""
    kappa = jnp.maximum(jnp.asarray(concentration, jnp.float32), 1e-6)
    shape = jnp.broadcast_shapes(shape, jnp.shape(loc), jnp.shape(kappa))
    tau = 1.0 + jnp.sqrt(1.0 + 4.0 * kappa**2)
    rho = (tau - jnp.sqrt(2.0 * tau)) / (2.0 * kappa)
    r = (1.0 + rho**2) / (2.0 * rho)

    def propose(k):
        k1, k2, k3 = jr.split(k, 3)
        u1 = jr.uniform(k1, shape)
        u2 = jr.uniform(k2, shape)
        u3 = jr.uniform(k3, shape)
        z = jnp.cos(jnp.pi * u1)
        f = (1.0 + r * z) / (r + z)
        c = kappa * (r - f)
        accept = (c * (2.0 - c) - u2 > 0.0) | (jnp.log(c / jnp.maximum(u2, 1e-30)) + 1.0 - c >= 0.0)
        theta = jnp.where(u3 < 0.5, -1.0, 1.0) * jnp.arccos(jnp.clip(f, -1.0, 1.0))
        return theta, accept

    theta = _masked_rejection(key, propose, shape)
    out = jnp.mod(theta + loc + jnp.pi, 2.0 * jnp.pi) - jnp.pi
    return out


def zipf_sample(key, power, shape=()):
    """Devroye's rejection-inversion sampler for the Zipf distribution."""
    a = jnp.asarray(power, jnp.float32)
    shape = jnp.broadcast_shapes(shape, jnp.shape(a))
    am1 = a - 1.0
    b = jnp.power(2.0, am1)

    def propose(k):
        k1, k2 = jr.split(k)
        u = jr.uniform(k1, shape, minval=1e-10, maxval=1.0)
        v = jr.uniform(k2, shape)
        x = jnp.floor(jnp.power(u, -1.0 / am1))
        t = jnp.power(1.0 + 1.0 / x, am1)
        accept = v * x * (t - 1.0) / (b - 1.0) <= t / b
        return x, accept

    return _masked_rejection(key, propose, shape).astype(jnp.int32)


def _uniform_on_sphere(key, shape, dim):
    x = jr.normal(key, shape + (dim,))
    return x / jnp.linalg.norm(x, axis=-1, keepdims=True)


def _householder_rotate(y, mu):
    """Reflect ``y`` so the north pole e1 maps to ``mu``."""
    d = mu.shape[-1]
    e1 = jnp.zeros_like(mu).at[..., 0].set(1.0)
    u = e1 - mu
    norm = jnp.linalg.norm(u, axis=-1, keepdims=True)
    u = u / jnp.where(norm < 1e-8, 1.0, norm)
    reflected = y - 2.0 * jnp.sum(y * u, axis=-1, keepdims=True) * u
    return jnp.where(norm < 1e-8, y, reflected)


def power_spherical_sample(key, mean_direction, concentration):
    """Exact sampler for the Power Spherical distribution
    (De Cao & Aziz, 2020) — rejection-free, jit-friendly."""
    mu = jnp.asarray(mean_direction, jnp.float32)
    kappa = jnp.asarray(concentration, jnp.float32)
    d = mu.shape[-1]
    batch = jnp.broadcast_shapes(mu.shape[:-1], jnp.shape(kappa))
    alpha = (d - 1.0) / 2.0 + kappa
    beta = (d - 1.0) / 2.0
    k1, k2 = jr.split(key)
    z = jr.beta(k1, alpha, beta, batch)
    t = 2.0 * z - 1.0
    v = _uniform_on_sphere(k2, batch, d - 1)
    y = jnp.concatenate(
        [t[..., None], jnp.sqrt(jnp.maximum(1.0 - t[..., None] ** 2, 0.0)) * v],
        axis=-1,
    )
    mu_b = jnp.broadcast_to(mu, batch + (d,))
    return _householder_rotate(y, mu_b)


def power_spherical_logpdf(x, mean_direction, concentration):
    mu = jnp.asarray(mean_direction, jnp.float32)
    kappa = jnp.asarray(concentration, jnp.float32)
    d = mu.shape[-1]
    alpha = (d - 1.0) / 2.0 + kappa
    beta = (d - 1.0) / 2.0
    log_norm = (
        (alpha + beta) * jnp.log(2.0)
        + beta * jnp.log(jnp.pi)
        + gammaln(alpha)
        - gammaln(alpha + beta)
    )
    dot = jnp.sum(mu * x, axis=-1)
    return kappa * jnp.log1p(jnp.clip(dot, -1.0 + 1e-7, 1.0)) - log_norm


def von_mises_fisher_sample(key, mean_direction, concentration):
    """Wood (1994) rejection sampler, fixed rounds with masked acceptance."""
    mu = jnp.asarray(mean_direction, jnp.float32)
    kappa = jnp.maximum(jnp.asarray(concentration, jnp.float32), 1e-6)
    d = mu.shape[-1]
    batch = jnp.broadcast_shapes(mu.shape[:-1], jnp.shape(kappa))
    dm1 = d - 1.0
    b = (-2.0 * kappa + jnp.sqrt(4.0 * kappa**2 + dm1**2)) / dm1
    x0 = (1.0 - b) / (1.0 + b)
    c = kappa * x0 + dm1 * jnp.log(1.0 - x0**2)

    def propose(k):
        k1, k2 = jr.split(k)
        z = jr.beta(k1, dm1 / 2.0, dm1 / 2.0, batch)
        w = (1.0 - (1.0 + b) * z) / (1.0 - (1.0 - b) * z)
        u = jr.uniform(k2, batch, minval=1e-10)
        accept = kappa * w + dm1 * jnp.log(jnp.maximum(1.0 - x0 * w, 1e-30)) - c >= jnp.log(u)
        return w, accept

    k1, k2 = jr.split(key)
    w = _masked_rejection(k1, propose, batch)
    v = _uniform_on_sphere(k2, batch, d - 1)
    y = jnp.concatenate(
        [w[..., None], jnp.sqrt(jnp.maximum(1.0 - w[..., None] ** 2, 0.0)) * v],
        axis=-1,
    )
    mu_b = jnp.broadcast_to(mu, batch + (d,))
    return _householder_rotate(y, mu_b)


def von_mises_fisher_logpdf(x, mean_direction, concentration):
    mu = jnp.asarray(mean_direction, jnp.float32)
    kappa = jnp.asarray(concentration, jnp.float32)
    d = mu.shape[-1]
    nu = d / 2.0 - 1.0
    log_c = (
        nu * jnp.log(jnp.maximum(kappa, 1e-30))
        - (d / 2.0) * jnp.log(2.0 * jnp.pi)
        - log_bessel_iv(nu, kappa)
    )
    # kappa -> 0 limit: I_nu(k) ~ (k/2)^nu / Gamma(nu+1), so
    # C -> 2^nu Gamma(nu+1) / (2pi)^{d/2} — the uniform-on-sphere density
    # (the generic form is 0*log0 - log0 = +inf there)
    log_c0 = (
        nu * jnp.log(2.0)
        + gammaln(nu + 1.0)
        - (d / 2.0) * jnp.log(2.0 * jnp.pi)
    )
    log_c = jnp.where(kappa < 1e-6, log_c0, log_c)
    return kappa * jnp.sum(mu * x, axis=-1) + log_c


def gauss_legendre(n: int = 128):
    """Gauss-Legendre nodes/weights on [0, 1] (computed once with numpy)."""
    import numpy as np

    x, w = np.polynomial.legendre.leggauss(n)
    return jnp.asarray((x + 1.0) / 2.0, jnp.float32), jnp.asarray(w / 2.0, jnp.float32)
