"""Bayesian neural network regression family.

No reference counterpart (its cookbook stops at GLMs); this is the
canonical "many-weight" stress model for the column-layout samplers: the
posterior is over every weight and bias of an MLP, the likelihood is a
chain of matmuls (matmul-bound under vmap over chains), and the flattened
weight vector is exactly what ``ColumnPacker`` packs.

Validation hooks:

- ``hidden=()`` collapses the network to ``y ~ N(X @ W + b, obs)`` — a
  conjugate Bayesian linear regression with an exact posterior
  (``bnn_exact_linear_posterior``), so every sampler/VI method can be
  checked to closed form on the SAME model family it runs at depth.
- ``bnn_predict`` turns posterior weight draws into a posterior
  predictive mean/sd, for coverage checks on nonlinear fits.

Weight priors are scaled ``N(0, prior_scale / sqrt(fan_in))`` (the
standard neural-network parameterization), so depth does not blow up the
prior predictive scale.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..lang.static_lang import gen

_ACTIVATIONS = {
    "tanh": jnp.tanh,
    "relu": jax.nn.relu,
    "gelu": jax.nn.gelu,
    "linear": lambda x: x,
}


def _layer_dims(d_in: int, hidden: Sequence[int], d_out: int):
    dims = [d_in, *hidden, d_out]
    return list(zip(dims[:-1], dims[1:]))


def bayesian_nn(
    X,
    *,
    hidden: Sequence[int] = (8,),
    d_out: int = 1,
    activation: str = "tanh",
    prior_scale: float = 1.0,
    obs_scale: float = 0.25,
):
    """MLP regression: every weight/bias is a latent address.

    Addresses: ``"W0", "b0", "W1", "b1", ...`` (flattened vectors — the
    body reshapes), observation ``"y"`` of shape ``(n * d_out,)``.
    Returns ``(model, weight_addresses, forward)`` where
    ``forward(chm, X)`` runs the network at the weights stored in a
    choice map (posterior draws ride a leading batch axis via vmap).
    """
    if activation not in _ACTIVATIONS:
        raise ValueError(
            f"activation must be one of {sorted(_ACTIVATIONS)}, got "
            f"{activation!r}"
        )
    act = _ACTIVATIONS[activation]
    X = jnp.asarray(X, jnp.float32)
    n, d_in = X.shape
    layers = _layer_dims(d_in, hidden, d_out)
    addresses = []
    for i in range(len(layers)):
        addresses += [f"W{i}", f"b{i}"]

    from ..dists import mv_normal_diag

    # host-numpy prior scales: jit-constant friendly
    w_scales = [
        np.float32(prior_scale / np.sqrt(fan_in)) for fan_in, _ in layers
    ]

    @gen
    def model():
        h = X
        for i, (fan_in, fan_out) in enumerate(layers):
            w_flat = (
                mv_normal_diag(
                    jnp.zeros(fan_in * fan_out),
                    w_scales[i] * jnp.ones(fan_in * fan_out),
                )
                @ f"W{i}"
            )
            b = (
                mv_normal_diag(
                    jnp.zeros(fan_out), prior_scale * jnp.ones(fan_out)
                )
                @ f"b{i}"
            )
            h = h @ w_flat.reshape(fan_in, fan_out) + b
            if i < len(layers) - 1:
                h = act(h)
        out = h.reshape(-1)
        y = mv_normal_diag(out, obs_scale * jnp.ones(n * d_out)) @ "y"
        return y

    def forward(chm, X_new):
        """Deterministic network output ``(n_new, d_out)`` at the weights
        in ``chm`` (a choice map holding the ``W*/b*`` addresses)."""
        from ..generative.mask import Mask

        def get(addr):
            v = chm.get_submap(addr).get_value()
            return v.value if isinstance(v, Mask) else v

        h = jnp.asarray(X_new, jnp.float32)
        for i, (fan_in, fan_out) in enumerate(layers):
            h = h @ get(f"W{i}").reshape(fan_in, fan_out) + get(f"b{i}")
            if i < len(layers) - 1:
                h = act(h)
        return h

    return model, addresses, forward


def bnn_exact_linear_posterior(X, y, *, prior_scale=1.0, obs_scale=0.25):
    """Closed-form posterior for the ``hidden=()`` (linear) network over
    the stacked ``[W0_flat, b0]`` vector: standard conjugate Gaussian
    regression with the same scaled prior the model uses.

    Returns ``(mean, cov)`` over ``(d_in * d_out + d_out,)``.
    """
    X = jnp.asarray(X, jnp.float32)
    y = jnp.asarray(y, jnp.float32).reshape(-1)
    n, d_in = X.shape
    d_out = y.shape[0] // n
    if d_out != 1:
        raise NotImplementedError(
            "exact linear posterior implemented for d_out=1"
        )
    # design over [W0 (d_in), b0 (1)] with per-block prior scales
    A = jnp.concatenate([X, jnp.ones((n, 1), jnp.float32)], axis=1)
    w_scale = prior_scale / np.sqrt(d_in)
    prior_sd = jnp.concatenate(
        [jnp.full((d_in,), w_scale), jnp.full((1,), prior_scale)]
    )
    prec = jnp.diag(1.0 / prior_sd**2) + (A.T @ A) / obs_scale**2
    cov = jnp.linalg.inv(prec)
    mean = cov @ (A.T @ y) / obs_scale**2
    return mean, cov


def bnn_predict(chm_draws, X_new, forward):
    """Posterior predictive mean/sd of the network output over a batch of
    weight draws (leading axis on every leaf, as returned by
    ``ADVIPosterior.sample_choices`` / vmapped trace choices)."""
    outs = jax.vmap(lambda c: forward(c, X_new))(chm_draws)
    return jnp.mean(outs, axis=0), jnp.std(outs, axis=0)
