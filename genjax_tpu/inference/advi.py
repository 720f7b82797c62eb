"""Automatic differentiation variational inference (Kucukelbir et al.,
JMLR 2017) over column log-densities.

No reference counterpart: the reference's variational layer
(`/root/reference/src/genjax/_src/inference/vi.py`) fits *hand-specified*
guide programs with ADEV gradient estimators. ADVI is the turnkey
complement — the guide is a Gaussian over the packed column vector
(mean-field diagonal, or full-rank via a Cholesky factor), fit by
stochastic reparameterized ELBO gradients, no guide program required.

Shape: a K-sample ELBO batch is one ``(D, K)`` matrix; the full-rank
reparameterization ``z = mu + L @ eps`` is a ``(D, D) @ (D, K)`` matmul
(matmul-bound), and the target is evaluated through the standard column
convention ``(D, K) -> (K,)``, so sharded big-data targets
(``parallel.data.data_sharded_logdensity``) drop in unchanged.

Two gradient estimators:

- ``"stl"`` (sticking the landing; Roeder et al. 2017, default): the
  entropy term is the Monte-Carlo ``-log q(z)`` with the *score* path
  severed (``stop_gradient`` on the variational parameters inside
  ``log q``). Zero-variance gradients when ``q`` reaches the target's
  family, so full-rank fits of Gaussian targets converge to machine
  precision instead of an SGD noise floor.
- ``"entropy"``: analytic Gaussian entropy (the classic ADVI estimator).
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import jax
import jax.numpy as jnp
import jax.random as jr
from jax import lax

from ..core.pytree import Pytree
from ..core.typing_ import PRNGKey

_LOG2PI = 1.8378770664093453


@Pytree.dataclass
class ADVIResult(Pytree):
    """Fitted Gaussian variational posterior over a column vector.

    ``mu``: ``(D,)`` mean. ``scale_tril``: ``(D, D)`` lower-triangular
    Cholesky factor of the covariance (mean-field fits store the diagonal
    embedding). ``elbo_trace``: per-step Monte-Carlo ELBO estimates.
    ``elbo``: final ELBO re-estimated with a fresh, larger sample — an
    evidence lower bound usable for model comparison."""

    mu: Any
    scale_tril: Any
    elbo_trace: Any
    elbo: Any

    @property
    def cov(self):
        return self.scale_tril @ self.scale_tril.T

    @property
    def sd(self):
        return jnp.sqrt(jnp.sum(self.scale_tril**2, axis=1))

    def sample(self, key: PRNGKey, n: int):
        """Draw ``(D, n)`` columns from the fitted Gaussian."""
        eps = jr.normal(key, (self.mu.shape[0], n))
        return self.mu[:, None] + self.scale_tril @ eps

    def logq(self, z):
        """Batched guide log-density ``(D, N) -> (N,)``."""
        return _mvn_logpdf_cols(z, self.mu, self.scale_tril)


def _mvn_logpdf_cols(z, mu, scale_tril):
    d = mu.shape[0]
    y = jax.scipy.linalg.solve_triangular(
        scale_tril, z - mu[:, None], lower=True
    )
    logdet = jnp.sum(jnp.log(jnp.diag(scale_tril)))
    return -0.5 * jnp.sum(y**2, axis=0) - logdet - 0.5 * d * _LOG2PI


def _diag_logpdf_cols(z, mu, log_sigma):
    y = (z - mu[:, None]) * jnp.exp(-log_sigma)[:, None]
    return (
        -0.5 * jnp.sum(y**2, axis=0)
        - jnp.sum(log_sigma)
        - 0.5 * mu.shape[0] * _LOG2PI
    )


def advi(
    key: PRNGKey,
    logdensity_cols: Callable,
    dim: int,
    *,
    rank: str = "diag",
    n_steps: int = 1000,
    n_samples: int = 32,
    learning_rate: float = 0.05,
    estimator: str = "stl",
    init_mu=None,
    init_log_sigma: float = -1.0,
    n_elbo_samples: int = 256,
) -> ADVIResult:
    """Fit a Gaussian ``q`` to ``exp(logdensity_cols)`` by maximizing the
    reparameterized Monte-Carlo ELBO with Adam. One jitted program.

    ``logdensity_cols``: batched target ``(D, K) -> (K,)`` (the
    ``column_logdensity`` convention). ``rank``: ``"diag"`` (mean-field)
    or ``"full"`` (Cholesky). ``learning_rate`` may be a float or any
    optax schedule — when ``q`` cannot match the target's family, STL
    gradients do not vanish at the optimum and a decaying schedule is
    needed to pass below the SGD noise floor. Returns an
    :class:`ADVIResult`; mean-field results are embedded as a diagonal
    ``scale_tril`` so downstream code has one shape.
    """
    import optax

    if rank not in ("diag", "full"):
        raise ValueError(f"rank must be 'diag' or 'full', got {rank!r}")
    if estimator not in ("stl", "entropy"):
        raise ValueError(
            f"estimator must be 'stl' or 'entropy', got {estimator!r}"
        )

    mu0 = (
        jnp.zeros(dim, jnp.float32)
        if init_mu is None
        else jnp.asarray(init_mu, jnp.float32)
    )
    if rank == "diag":
        params0 = {
            "mu": mu0,
            "log_sigma": jnp.full((dim,), init_log_sigma, jnp.float32),
        }
    else:
        params0 = {
            "mu": mu0,
            # unconstrained diag (exp-transformed) + strict lower triangle
            "log_diag": jnp.full((dim,), init_log_sigma, jnp.float32),
            "lower": jnp.zeros((dim, dim), jnp.float32),
        }

    def _reparam(params, eps):
        if rank == "diag":
            sigma = jnp.exp(params["log_sigma"])
            return params["mu"][:, None] + sigma[:, None] * eps
        tril = _build_tril(params)
        return params["mu"][:, None] + tril @ eps

    def _build_tril(params):
        strict = jnp.tril(params["lower"], k=-1)
        return strict + jnp.diag(jnp.exp(params["log_diag"]))

    def _logq(params, z):
        if rank == "diag":
            return _diag_logpdf_cols(z, params["mu"], params["log_sigma"])
        return _mvn_logpdf_cols(z, params["mu"], _build_tril(params))

    def _entropy(params):
        log_diag = (
            params["log_sigma"] if rank == "diag" else params["log_diag"]
        )
        return jnp.sum(log_diag) + 0.5 * dim * (_LOG2PI + 1.0)

    def elbo_est(params, k, n):
        eps = jr.normal(k, (dim, n))
        z = _reparam(params, eps)
        lp = jnp.mean(logdensity_cols(z))
        if estimator == "entropy":
            return lp + _entropy(params)
        frozen = jax.tree_util.tree_map(lax.stop_gradient, params)
        return lp - jnp.mean(_logq(frozen, z))

    opt = optax.adam(learning_rate)
    neg_val_grad = jax.value_and_grad(
        lambda p, k: -elbo_est(p, k, n_samples)
    )

    @jax.jit
    def run(key):
        fit_key, eval_key = jr.split(key)

        def step(carry, k):
            params, state = carry
            loss, g = neg_val_grad(params, k)
            updates, state = opt.update(g, state, params)
            params = optax.apply_updates(params, updates)
            return (params, state), -loss

        (params, _), trace = lax.scan(
            step,
            (params0, opt.init(params0)),
            jr.split(fit_key, n_steps),
        )
        final = elbo_est(params, eval_key, n_elbo_samples)
        if rank == "diag":
            tril = jnp.diag(jnp.exp(params["log_sigma"]))
        else:
            tril = _build_tril(params)
        return params["mu"], tril, trace, final

    mu, tril, trace, final = run(key)
    return ADVIResult(mu=mu, scale_tril=tril, elbo_trace=trace, elbo=final)


@Pytree.dataclass
class ADVIPosterior(Pytree):
    """:class:`ADVIResult` bound to a model's :class:`ColumnPacker` —
    draws decode back to choice maps over the fitted addresses."""

    result: ADVIResult
    packer: Any = Pytree.static()

    def sample_choices(self, key: PRNGKey, n: int):
        """Draw ``n`` posterior choice maps (leaves carry a leading ``n``
        axis)."""
        cols = self.result.sample(key, n)
        return jax.vmap(self.packer.unpack, in_axes=1)(cols)

    def mean_choices(self):
        return self.packer.unpack(self.result.mu)


def column_advi(
    key: PRNGKey,
    model,
    constraint,
    args: tuple,
    addresses: Sequence[Any],
    **advi_kwargs,
) -> ADVIPosterior:
    """Turnkey ADVI over a model's continuous addresses in the column
    layout: pack the addresses, fit :func:`advi` against the model's
    log-joint, return decodable posterior draws.

    The packer's tile-padding dimensions carry a standard-normal factor
    (see ``kernels.model_interface.column_logdensity``), which ADVI fits
    exactly — the marginal over the real dimensions is unchanged.
    """
    from ..generative.choice_map import ChoiceMap
    from ..kernels.model_interface import ColumnPacker, column_logdensity

    if constraint is None:
        constraint = ChoiceMap.empty()
    packer = ColumnPacker(model, constraint, args, addresses)
    logdensity_cols = column_logdensity(model, constraint, args, packer)
    result = advi(key, logdensity_cols, packer.padded_dim, **advi_kwargs)
    return ADVIPosterior(result=result, packer=packer)
