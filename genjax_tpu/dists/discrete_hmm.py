"""``DiscreteHMM``: an exact-posterior distribution over the latent sequence
of a discrete hidden Markov model.

Parity: reference ``/root/reference/src/genjax/_src/generative_functions/
distributions/custom/discrete_hmm.py`` (267 LoC) — circulant configuration
:42-86, forward-filtering backward-sampling :98-192, exact marginals
:200-239, the ``DiscreteHMM`` singleton distribution :242-267.

Design: forward filtering and backward sampling are two ``lax.scan`` passes
over ``(T, N)``/(``N, N``) arrays; the per-step work is a logsumexp matvec —
pure matmul/elementwise, no host logic and no TFP dependency. The exact data
log-marginal is the forward algorithm's final normalizer chain.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.scipy.special import logsumexp

from ..core.pytree import Pytree
from ..core.typing_ import PRNGKey
from .distribution import Distribution


def _circulant(row0: np.ndarray) -> np.ndarray:
    """Circulant matrix whose first column is ``row0`` (host-side; the config
    is static)."""
    n = len(row0)
    return np.stack([np.roll(row0, i) for i in range(n)], axis=0).T


def scaled_circulant(N: int, k: int, epsilon: float, delta: float) -> np.ndarray:
    """Banded-circulant logits: entries decay as ``epsilon**distance`` within
    band ``k`` (cyclically), ``-delta`` outside (reference
    discrete_hmm.py:42)."""
    source = np.asarray(
        [
            epsilon ** abs(i)
            if i <= k
            else (epsilon ** abs(i - N) if i - N >= -k else -delta)
            for i in range(N)
        ],
        dtype=np.float64,
    )
    return _circulant(source)


@Pytree.dataclass
class DiscreteHMMConfiguration(Pytree):
    """Static HMM configuration over a cyclic 1-D grid
    (reference discrete_hmm.py:53)."""

    linear_grid_dim: int = Pytree.static()
    adjacency_distance_trans: int = Pytree.static()
    adjacency_distance_obs: int = Pytree.static()
    sigma_trans: float = Pytree.static()
    sigma_obs: float = Pytree.static()

    def transition_tensor(self):
        # host numpy, NOT an eager device array: callers close over these
        # tensors as jit constants
        s = self.sigma_trans
        # delta=+inf for sigma<=0 so out-of-band logits are -inf (one-hot
        # rows after softmax). The reference passes -inf here
        # (discrete_hmm.py:52), which makes every entry +inf and the
        # whole matrix NaN for deterministic-transition configs — its own
        # observation_tensor uses +inf; documented deviation
        # (ARCHITECTURE.md §Deviations).
        return np.asarray(
            scaled_circulant(
                self.linear_grid_dim,
                self.adjacency_distance_trans,
                s if s > 0.0 else -np.inf,
                1 / s if s > 0.0 else np.inf,
            ),
            dtype=np.float32,
        )

    def observation_tensor(self):
        s = self.sigma_obs
        return np.asarray(
            scaled_circulant(
                self.linear_grid_dim,
                self.adjacency_distance_obs,
                s if s > 0.0 else -np.inf,
                1 / s if s > 0.0 else np.inf,
            ),
            dtype=np.float32,
        )

    def log_initial(self):
        init = self.linear_grid_dim // 2
        return jax.nn.log_softmax(self.transition_tensor()[init, :])

    def log_transition(self):
        """(N, N): row = previous state, normalized over next state."""
        return jax.nn.log_softmax(self.transition_tensor(), axis=-1)

    def log_observation(self):
        """(N, N): row = latent state, normalized over observation."""
        return jax.nn.log_softmax(self.observation_tensor(), axis=-1)


# ----------------------------------------------------------------------
# forward filtering / backward sampling (reference discrete_hmm.py:98-192)
# ----------------------------------------------------------------------


def forward_filter(config: DiscreteHMMConfiguration, observations):
    """Run the forward algorithm. Returns ``(filters, log_marginal)`` where
    ``filters[t] = log p(z_t | y_{1:t})`` (shape (T, N)) and ``log_marginal =
    log p(y_{1:T})``."""
    log_init = config.log_initial()
    log_trans = config.log_transition()
    log_obs = config.log_observation()

    def step(carry, y_t):
        t, log_pred = carry  # log p(z_t | y_{1:t-1}) (unnormalized ok)
        log_alpha = log_pred + log_obs[:, y_t]
        log_norm = logsumexp(log_alpha)
        log_filt = log_alpha - log_norm
        # predict: log p(z_{t+1} | y_{1:t}) = lse_z [ filt(z) + trans(z->z') ]
        log_next_pred = logsumexp(log_filt[:, None] + log_trans, axis=0)
        return (t + 1, log_next_pred), (log_filt, log_norm)

    (_, _), (filters, log_norms) = lax.scan(step, (0, log_init), observations)
    return filters, jnp.sum(log_norms)


def backward_sample(key: PRNGKey, config: DiscreteHMMConfiguration, filters):
    """Sample an exact posterior latent path given the forward filters."""
    log_trans = config.log_transition()
    T = filters.shape[0]

    def step(carry, inp):
        next_z = carry
        t, log_filt = inp
        is_last = t == T - 1
        cond_logits = jnp.where(
            is_last, log_filt, log_filt + log_trans[:, next_z]
        )
        z = jax.random.categorical(jax.random.fold_in(key, t), cond_logits)
        return z, z

    _, zs_rev = lax.scan(
        step,
        jnp.asarray(0),
        (jnp.arange(T)[::-1], filters[::-1]),
    )
    return zs_rev[::-1]


def path_log_joint(config: DiscreteHMMConfiguration, zs, observations):
    """``log p(z_{1:T}, y_{1:T})`` — one O(T·N) scan over the path."""
    log_init = config.log_initial()
    log_trans = config.log_transition()
    log_obs = config.log_observation()

    def step(prev_z, inp):
        t, z, y = inp
        lp_z = jnp.where(t == 0, log_init[z], log_trans[prev_z, z])
        return z, lp_z + log_obs[z, y]

    T = observations.shape[0]
    _, lps = lax.scan(step, jnp.asarray(0), (jnp.arange(T), zs, observations))
    return jnp.sum(lps)


def exact_path_log_posterior(
    config: DiscreteHMMConfiguration, zs, observations, log_marginal=None
):
    """``log p(z_{1:T} | y_{1:T})`` exactly: joint minus data marginal.
    Pass ``log_marginal`` when the forward filter already ran (sampling
    runs it for the filters — recomputing doubles the O(T·N²) cost)."""
    joint = path_log_joint(config, zs, observations)
    if log_marginal is None:
        _, log_marginal = forward_filter(config, observations)
    return joint - log_marginal, log_marginal


@Pytree.dataclass
class _DiscreteHMMLatentSequencePosterior(Distribution):
    """Exact sampling + exact density for HMM latent paths given observations
    (reference discrete_hmm.py:242). Args: ``(config, observations)``."""

    def random_weighted(self, key: PRNGKey, *args):
        config, observations = args
        filters, log_marginal = forward_filter(config, observations)
        zs = backward_sample(key, config, filters)
        w, _ = exact_path_log_posterior(
            config, zs, observations, log_marginal
        )
        return w, zs

    def estimate_logpdf(self, key: PRNGKey, v, *args):
        config, observations = args
        w, _ = exact_path_log_posterior(config, v, observations)
        return w

    def assess(self, chm, args):
        v = chm.get_value()
        from ..generative.mask import Mask

        if isinstance(v, Mask):
            v = v.value
        config, observations = args
        w, _ = exact_path_log_posterior(config, v, observations)
        return w, v

    def data_logpdf(self, config, observations):
        """Exact ``log p(y_{1:T})``."""
        _, log_marginal = forward_filter(config, observations)
        return log_marginal


DiscreteHMM = _DiscreteHMMLatentSequencePosterior()


def forward_filtering_backward_sampling(key, config, observations):
    """Reference-parity combined entry point (discrete_hmm.py:98): forward
    filter then sample an exact posterior path. Returns
    ``(key, (samples, filters))``."""
    filters, _ = forward_filter(config, observations)
    zs = backward_sample(key, config, filters)
    return key, (zs, filters)
