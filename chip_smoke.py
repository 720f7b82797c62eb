"""Drive genjax_tpu's main inference paths once on the GPU and check them.

    python chip_smoke.py           # phases 0-5 on one card
    python chip_smoke.py --four    # only the sharded checks, on four cards

Phases (one card):

0. identity: the device as JAX reports it, versions, flags, compile cache
   and the card's ``nvidia-smi`` name and power limit;
1. GFI core: beta-bernoulli importance sampling at K = 65,536 against
   ``log 0.5``, and the SMCP3 edit round trip of a 1,000-step scanned
   kernel over 4,096 traces;
2. MCMC: ``sample_posterior`` (nuts, hmc_sweep, chees, dense_hmc) on a
   10,000 x 32 Bayesian linear regression against its conjugate posterior,
   then ``column_hmc``/``column_nuts`` on the flagship hierarchical
   regression at 65,536 chains;
3. SMC: ``SSMParticleFilter`` with 131,072 particles over T = 100 against
   the Kalman log-evidence, over 8 seeds;
4. latent Gaussian: ``ess_sweep_gauss_cols`` on 256-dimensional GP latents
   x 8,192 chains against the closed-form GP posterior;
5. VI: ADEV ELBO gradients with optax on a conjugate mixture target
   against its exact posterior.

``--four`` runs sharded SMC in both resample modes, ``sample_posterior``
over a 4-device mesh against the same call on one device (adapted step
size and metric, and draws chain by chain after a short warmup), and
``data_sharded_logdensity`` on a (1, 4) mesh against the unsharded
log-density.

Each phase prints its compile and run seconds, the device's peak memory
and every compared quantity with its reference, tolerance and precision.
Every phase runs; when any failed, the script exits 1 and prints no
result line. Otherwise the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
The script refuses to run anywhere but on a GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import time
import traceback

import numpy as np

from chip_env import (
    device_fields,
    nvidia_smi,
    require_gpu,
    result_line,
    setup_compile_cache,
)

import jax  # noqa: E402  (after chip_env: the cache is configured first)
import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402

import genjax_tpu as g  # noqa: E402


# ----------------------------------------------------------------------
# sizes
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Every shape the phases use. :data:`FULL` is what the script runs;
    the CPU tests pass small ones."""

    sir_particles: int = 65_536
    edit_steps: int = 1_000
    edit_traces: int = 4_096
    reg_rows: int = 10_000
    reg_cols: int = 32
    reg_chains: int = 4_096
    reg_warmup: int = 300
    reg_samples: int = 100
    flagship_chains: int = 65_536
    flagship_assess_chains: int = 1_024
    flagship_steps: int = 200
    pf_particles: int = 131_072
    pf_steps: int = 100
    pf_seeds: int = 8
    gp_dim: int = 256
    gp_chains: int = 8_192
    gp_steps: int = 6_000
    vi_batch: int = 4_096
    vi_steps: int = 600
    four_pf_particles: int = 4 * 131_072
    four_reg_chains: int = 4_096
    algorithms: tuple = ("nuts", "hmc_sweep", "chees", "dense_hmc")


FULL = Sizes()
SEED = 0


# ----------------------------------------------------------------------
# comparisons
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Check:
    """One compared quantity: passes when ``|value - reference| <= tol``.
    ``precision`` says in what arithmetic ``value`` was computed."""

    name: str
    value: float
    reference: float
    tol: float
    precision: str
    detail: str = ""

    @property
    def ok(self) -> bool:
        return bool(
            math.isfinite(self.value)
            and abs(self.value - self.reference) <= self.tol
        )

    def line(self) -> str:
        extra = f" ({self.detail})" if self.detail else ""
        return (
            f"  {'ok  ' if self.ok else 'FAIL'} {self.name}: "
            f"value={self.value!r} reference={self.reference!r} "
            f"tol={self.tol!r} precision={self.precision}{extra}"
        )


class SmokeFailure(AssertionError):
    """A phase whose comparisons did not all pass."""


def failed(checks) -> list:
    return [c for c in checks if not c.ok]


def _max_z(values, reference, se):
    """Largest ``|values - reference| / se`` and the index it is at."""
    z = np.abs(np.asarray(values, np.float64) - np.asarray(reference)) / (
        np.asarray(se, np.float64)
    )
    i = int(np.argmax(z))
    return float(z[i]), i


# ---- phase 1 -------------------------------------------------------------


def compare_sir(log_w) -> list:
    """Beta(2, 2)-Bernoulli importance weights: ``E[w] = P(v) = 0.5``."""
    from jax.scipy.special import logsumexp

    log_w = np.asarray(log_w, np.float64)
    est = float(logsumexp(log_w) - math.log(log_w.size))
    return [Check(
        "sir_log_mean_weight", est, math.log(0.5), 0.01, "float32",
        f"K={log_w.size}",
    )]


def compare_roundtrip(fwd_w, bwd_w, score_err) -> list:
    """SMCP3 round trip: the backward request's weight cancels the
    forward weight, and the trace comes back with its old score."""
    cancel = np.abs(np.asarray(fwd_w, np.float64) + np.asarray(bwd_w))
    return [
        Check(
            "edit_weight_cancellation_max", float(np.max(cancel)), 0.0,
            1e-3, "float32", f"{cancel.size} traces",
        ),
        Check(
            "edit_score_restored_max", float(np.max(np.abs(score_err))),
            0.0, 1e-3, "float32",
        ),
    ]


# ---- phase 2 -------------------------------------------------------------


def compare_posterior(name, draws, ess, mean, cov) -> list:
    """Posterior draws ``(chains, samples, d)`` against an exact Gaussian:
    every coordinate's mean within 5 Monte Carlo standard errors (from the
    run's own ESS) and every marginal sd within 10%."""
    d = np.asarray(draws, np.float64).reshape(-1, np.shape(mean)[0])
    sd_ref = np.sqrt(np.diag(cov))
    mcse = sd_ref / np.sqrt(np.maximum(np.asarray(ess, np.float64), 1.0))
    z, i = _max_z(d.mean(0), mean, mcse)
    ratio = d.std(0) / sd_ref
    j = int(np.argmax(np.abs(ratio - 1.0)))
    return [
        Check(
            f"{name}_mean_max_z", z, 0.0, 5.0, "float32",
            f"coord {i}: mean {d.mean(0)[i]!r} vs exact {float(mean[i])!r},"
            f" mcse {float(mcse[i])!r}, min ess {float(np.min(ess))!r}",
        ),
        Check(
            f"{name}_sd_ratio_worst", float(ratio[j]), 1.0, 0.10, "float32",
            f"coord {j}: sd {float(d.std(0)[j])!r} vs exact "
            f"{float(sd_ref[j])!r}",
        ),
    ]


def compare_logdensity(name, value, reference) -> list:
    """Chain-by-chain relative error of a log-density against a reference
    computed at full float32 matmul precision: at most 1e-5."""
    v = np.asarray(value, np.float64)
    r = np.asarray(reference, np.float64)
    rel = np.abs(v - r) / np.maximum(np.abs(r), 1.0)
    i = int(np.argmax(rel))
    return [Check(
        f"{name}_max_rel_err", float(rel[i]), 0.0, 1e-5, "float32",
        f"chain {i}: {float(v[i])!r} vs {float(r[i])!r}",
    )]


def compare_samplers(name, a, b) -> list:
    """Two samplers' cross-chain means ``(d, chains)`` agree within 5
    combined standard errors (chains are independent)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    se = np.sqrt(a.var(1) / a.shape[1] + b.var(1) / b.shape[1])
    z, i = _max_z(a.mean(1), b.mean(1), se)
    return [Check(
        f"{name}_mean_max_z", z, 0.0, 5.0, "float32",
        f"coord {i}: {float(a.mean(1)[i])!r} vs {float(b.mean(1)[i])!r}",
    )]


# ---- phase 3 -------------------------------------------------------------


def compare_log_evidence(name, log_z, exact) -> list:
    """Mean log-evidence over seeds within 4 standard errors of the exact
    value."""
    lz = np.asarray(log_z, np.float64)
    se = float(lz.std(ddof=1) / np.sqrt(lz.size))
    return [Check(
        f"{name}_log_evidence", float(lz.mean()), float(exact), 4.0 * se,
        "float32", f"{lz.size} seeds, se {se!r}",
    )]


# ---- phase 4 -------------------------------------------------------------


def compare_gaussian_moments(name, q, mean, var) -> list:
    """Cross-chain moments of ``q (d, chains)`` against exact Gaussian
    marginals: means and variances each within 5 standard errors of
    independent draws (the variance ratio's is ``sqrt(2 / chains)``)."""
    q = np.asarray(q, np.float64)
    n = q.shape[1]
    var_tol = 5.0 * math.sqrt(2.0 / n)
    z, i = _max_z(q.mean(1), mean, np.sqrt(np.asarray(var) / n))
    ratio = q.var(1) / np.asarray(var)
    j = int(np.argmax(np.abs(ratio - 1.0)))
    return [
        Check(
            f"{name}_mean_max_z", z, 0.0, 5.0, "float32",
            f"dim {i}: {float(q.mean(1)[i])!r} vs {float(mean[i])!r}",
        ),
        Check(
            f"{name}_var_ratio_worst", float(ratio[j]), 1.0, var_tol,
            "float32", f"dim {j}",
        ),
    ]


# ---- phase 5 -------------------------------------------------------------


def compare_vi(phi, exact) -> list:
    """Guide parameters against the exact posterior of the mixture target
    (the guide family contains it, so the ELBO optimum is exact)."""
    p1 = float(jax.nn.sigmoid(phi[0]))
    guide_mean = p1 * float(phi[1]) + (1.0 - p1) * float(phi[3])
    return [
        Check("vi_guide_mean", guide_mean, exact["mean"], 0.03, "float32"),
        Check("vi_component_prob", p1, exact["p1"], 0.01, "float32"),
        Check("vi_component_sd", float(np.exp(phi[2])), exact["sd1"], 0.05,
              "float32"),
    ]


# ---- four cards ------------------------------------------------------------


def compare_close(name, value, reference, *, rtol, atol) -> list:
    """Elementwise ``|value - reference| <= atol + rtol |reference|``;
    reports the worst element."""
    v = np.asarray(value, np.float64).ravel()
    r = np.asarray(reference, np.float64).ravel()
    excess = np.abs(v - r) - (atol + rtol * np.abs(r))
    i = int(np.argmax(excess))
    return [Check(
        f"{name}_worst", float(v[i]), float(r[i]),
        float(atol + rtol * abs(r[i])), "float32", f"element {i} of {v.size}",
    )]


def compare_mesh_adaptation(name, four, one, n_chains) -> list:
    """The step size and metric adapted by a mesh-sharded warmup against
    the same call on one device. Both adapt from cross-chain statistics of
    the same chains, which the two device counts round differently, so
    they are held to what two estimates from ``n_chains`` draws may differ
    by: eps within 5%, every inverse-mass entry within
    ``5 sqrt(2 / n_chains)`` relative."""
    im4 = np.asarray(four["inv_mass"], np.float64)
    im1 = np.asarray(one["inv_mass"], np.float64)
    rel = np.abs(im4 / im1 - 1.0)
    i = int(np.argmax(rel))
    return [
        Check(f"{name}_eps_rel_diff", abs(four["eps"] / one["eps"] - 1.0),
              0.0, 0.05, "float32",
              f"eps {four['eps']!r} vs {one['eps']!r}"),
        Check(f"{name}_inv_mass_max_rel_diff", float(rel[i]), 0.0,
              5.0 * math.sqrt(2.0 / n_chains), "float32",
              f"dim {i}: {float(im4[i])!r} vs {float(im1[i])!r}"),
    ]


def matching_chain_share(four, one, *, rtol=1e-4, atol=1e-5):
    """After each draw, the share of chains whose draws so far all agree
    between two runs to ``atol + rtol |one|``: ``(samples,)``."""
    d4 = np.asarray(four["draws"], np.float64)
    d1 = np.asarray(one["draws"], np.float64)
    close = np.all(np.abs(d4 - d1) <= atol + rtol * np.abs(d1), axis=2)
    return np.logical_and.accumulate(close, axis=1).mean(axis=0)


def compare_matching_chains(name, four, one) -> list:
    """At least 99% of the chains of a mesh-sharded run agree with the
    same call on one device through its last draw (a chain whose accept or
    U-turn test lands within roundoff of its threshold takes the other,
    equally valid, branch)."""
    share = matching_chain_share(four, one)
    return [Check(
        f"{name}_matching_chain_share", float(share[-1]), 1.0, 0.01,
        "float32", f"rtol 1e-4, atol 1e-5, {np.shape(four['draws'])[0]} "
        f"chains; after each draw {[float(s) for s in share]!r}",
    )]


# ----------------------------------------------------------------------
# workloads
# ----------------------------------------------------------------------


@g.gen
def beta_bernoulli(alpha, beta):
    p = g.beta(alpha, beta) @ "p"
    v = g.flip(p) @ "v"
    return v


def sir_log_weights(n_particles, seed=SEED):
    """The README quickstart model, vmapped ``importance`` at K
    particles with ``v = True`` observed."""
    obs = g.C["v"].set(True)

    @jax.jit
    def run(key):
        def one(k):
            return beta_bernoulli.importance(k, obs, (2.0, 2.0))[1]

        return jax.vmap(one)(jr.split(key, n_particles))

    return np.asarray(run(jr.key(seed)))


@g.gen
def ar_step(carry, x):
    z = g.normal(0.9 * carry, 1.0) @ "z"
    y = g.normal(z, 0.5) @ "y"
    return (z, y)


def edit_roundtrip(n_steps, n_traces, seed=SEED):
    """Update every ``z`` of a scanned AR(1) kernel, then apply the
    backward request. Returns ``(fwd_w, bwd_w, score_err)`` per trace."""
    chain = ar_step.scan(n=n_steps)
    args = (0.0, jnp.zeros(n_steps))

    @jax.jit
    def run(key):
        def one(k):
            k1, k2, k3, k4 = jr.split(k, 4)
            tr = chain.simulate(k1, args)
            zs = tr.get_choices()[:, "z"]
            zs = zs.unmask() if isinstance(zs, g.Mask) else zs
            new_zs = zs + 0.1 * jr.normal(k2, zs.shape)
            new_tr, w, _rd, bwd = tr.edit(
                k3, g.Update(g.C[:, "z"].set(new_zs))
            )
            back, wb, _rd2, _ = new_tr.edit(k4, bwd)
            return w, wb, back.get_score() - tr.get_score()

        return jax.vmap(one)(jr.split(key, n_traces))

    return tuple(np.asarray(a) for a in run(jr.key(seed + 1)))


def regression_problem(n_rows, n_cols, seed=SEED):
    """A seeded design matrix, data drawn from the model, and the conjugate
    posterior computed in float64 NumPy on the host."""
    from genjax_tpu.models import linear_regression

    obs_scale, prior_scale = 0.25, 1.0
    rng = np.random.default_rng(seed + 2)
    X = rng.normal(size=(n_rows, n_cols)).astype(np.float32)
    w_true = prior_scale * rng.normal(size=n_cols)
    y = X.astype(np.float64) @ w_true + obs_scale * rng.normal(size=n_rows)
    y = y.astype(np.float32)
    model, _exact = linear_regression(X, obs_scale=obs_scale,
                                      prior_scale=prior_scale)
    Xd = X.astype(np.float64)
    prec = np.eye(n_cols) / prior_scale**2 + Xd.T @ Xd / obs_scale**2
    cov = np.linalg.inv(prec)
    mean = cov @ (Xd.T @ y.astype(np.float64)) / obs_scale**2
    return dict(model=model, X=X, y=y, mean=mean, cov=cov,
                obs_scale=obs_scale, prior_scale=prior_scale)


def run_sample_posterior(problem, algorithm, sz, key, mesh=None,
                         n_chains=None):
    from genjax_tpu.inference import sample_posterior

    # NUTS runs from the default eps0. The other samplers get an eps0
    # sized for the identity metric on this posterior (sd ~0.0025 on every
    # coordinate): from the default, hmc_sweep's fixed-length trajectories
    # do not bring the chains there within the warmup.
    kw = {} if algorithm == "nuts" else {"eps0": 5e-4}
    post = sample_posterior(
        key, problem["model"], g.C["y"].set(problem["y"]), (), g.S["w"],
        n_chains=n_chains or sz.reg_chains, n_warmup=sz.reg_warmup,
        n_samples=sz.reg_samples, algorithm=algorithm, mesh=mesh, **kw,
    )
    return {
        "draws": np.asarray(post["w"]),
        "ess": np.asarray(post.ess_of("w")),
        "eps": float(post.eps),
        "inv_mass": np.asarray(post.inv_mass),
    }


def regression_precision_probe(problem, n_chains=256, seed=SEED):
    """The regression's log-joint near its posterior, at default matmul
    precision and at ``"highest"``: ``(max |difference|, max |value|)`` in
    nats over ``n_chains`` points."""
    model, y = problem["model"], problem["y"]
    rng = np.random.default_rng(seed + 12)
    sd = np.sqrt(np.diag(problem["cov"]))
    w = (problem["mean"] + sd * rng.normal(size=(n_chains, sd.size)))
    w = w.astype(np.float32)

    def log_joint(w):
        return jax.vmap(
            lambda wi: model.assess(g.C.d({"w": wi, "y": y}), ())[0]
        )(w)

    default = np.asarray(jax.jit(log_joint)(w), np.float64)
    with jax.default_matmul_precision("highest"):
        highest = np.asarray(jax.jit(log_joint)(w), np.float64)
    return float(np.max(np.abs(default - highest))), float(
        np.max(np.abs(highest))
    )


def flagship_problem():
    """The bench's flagship: hierarchical regression at N = 16, D = 8."""
    from genjax_tpu.models import hierarchical_regression

    X = np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32)
    y = np.random.default_rng(1).normal(size=(16,)).astype(np.float32)
    return hierarchical_regression(X), g.C["y"].set(y)


def flagship_logdensity_checks(n_chains, seed=SEED):
    """``column_logdensity`` at default precision against ``model.assess``
    chain by chain, with the reference at ``"highest"`` precision."""
    from genjax_tpu.kernels import ColumnPacker, column_logdensity

    model, obs = flagship_problem()
    packer = ColumnPacker(model, obs, (), ["tau", "w"])
    ld = column_logdensity(model, obs, (), packer)
    rng = np.random.default_rng(seed + 3)
    q = np.zeros((packer.padded_dim, n_chains), np.float32)
    q[0] = np.exp(0.5 * rng.normal(size=n_chains))
    q[1:packer.dim] = rng.normal(size=(packer.dim - 1, n_chains))
    value = np.asarray(jax.jit(ld)(q))

    with jax.default_matmul_precision("highest"):
        def one(col):
            chm = packer.unpack(col) | obs
            return model.assess(chm, ())[0]

        reference = np.asarray(jax.jit(jax.vmap(one, in_axes=1))(q))
    return compare_logdensity("flagship_column_logdensity", value, reference)


def flagship_sampler_checks(sz, seed=SEED):
    from genjax_tpu.kernels import column_hmc, column_nuts

    model, obs = flagship_problem()
    q_h, acc_h, packer = column_hmc(
        model, obs, (), ["tau", "w"], n_chains=sz.flagship_chains,
        n_steps=sz.flagship_steps, eps=0.05, L=5, seed=seed + 4, warmup=True,
    )
    q_n, _acc, _leaps, _ = column_nuts(
        model, obs, (), ["tau", "w"], n_chains=sz.flagship_chains,
        n_steps=sz.flagship_steps // 4, eps=0.05, seed=seed + 5, warmup=True,
    )
    real = slice(0, packer.dim)
    return compare_samplers(
        "flagship_hmc_vs_nuts", np.asarray(q_h)[real], np.asarray(q_n)[real]
    ), float(acc_h)


def pf_log_evidence(n_particles, n_steps, n_seeds, seed=SEED, mesh=None,
                    resample_mode="local"):
    """``SSMParticleFilter`` log-evidence over seeds, and the Kalman
    answer, on observations simulated from the model."""
    from genjax_tpu.models import linear_gaussian_ssm
    from genjax_tpu.parallel import SSMParticleFilter

    kernel, exact_log_marginal = linear_gaussian_ssm()
    rng = np.random.default_rng(seed + 6)
    z = np.cumsum(rng.normal(size=n_steps))
    ys = (z + 0.5 * rng.normal(size=n_steps)).astype(np.float32)
    obs = g.C[:, "y"].set(ys)
    xs = jnp.zeros(n_steps)
    pf = SSMParticleFilter(kernel, n_particles=n_particles)
    if mesh is None:
        run = jax.jit(lambda k: pf.run(k, 0.0, xs, obs).log_marginal)
    else:
        def run(k):
            return pf.run_sharded(
                k, 0.0, xs, obs, mesh, resample_mode=resample_mode
            ).log_marginal
    lz = [float(run(jr.key(seed + 100 + s))) for s in range(n_seeds)]
    return np.asarray(lz), float(exact_log_marginal(ys.astype(np.float64)))


def gp_problem(dim, seed=SEED):
    """The bench's GP latents: squared-exponential prior on ``dim`` inputs
    (jitter 1e-4), Gaussian noise 0.3, and the exact posterior of the
    latents — the closed form of ``models.gp_posterior`` at the training
    inputs, in float64 NumPy on the host with the prior's own jitter."""
    rng = np.random.default_rng(seed + 7)
    x = rng.uniform(0.0, 10.0, size=(dim, 1))
    K = np.exp(-0.5 * (x - x.T) ** 2) + 1e-4 * np.eye(dim)
    chol = np.linalg.cholesky(K)
    noise = 0.3
    y = (chol @ rng.normal(size=dim) + noise * rng.normal(size=dim))
    y = y.astype(np.float32)
    gram = K + noise**2 * np.eye(dim)
    mean = K @ np.linalg.solve(gram, y.astype(np.float64))
    cov = K - K @ np.linalg.solve(gram, K)
    return dict(
        x=x, chol=chol.astype(np.float32), y=y, noise=noise, mean=mean,
        var=np.diag(cov),
    )


def gp_ess_draws(problem, n_chains, n_steps, seed=SEED):
    from genjax_tpu.kernels import ess_sweep_gauss_cols

    chol, y = problem["chol"], problem["y"]
    prec = 1.0 / problem["noise"] ** 2

    @jax.jit
    def run(q0):
        return ess_sweep_gauss_cols(
            q0, seed + 8, n_steps=n_steps, chol_prior=chol, y=y, prec=prec,
        )[0]

    return np.asarray(run(jnp.zeros((chol.shape[0], n_chains), jnp.float32)))


def vi_exact_posterior(y=1.5):
    """Exact posterior of ``z ~ Bernoulli(0.5); mu ~ N(+-2, 1);
    y ~ N(mu, 0.5)``."""
    def log_norm(x, m, v):
        return -0.5 * (math.log(2 * math.pi * v) + (x - m) ** 2 / v)

    l1, l0 = log_norm(y, 2.0, 1.25), log_norm(y, -2.0, 1.25)
    p1 = 1.0 / (1.0 + math.exp(l0 - l1))
    post_var = 1.0 / (1.0 + 1.0 / 0.25)
    m1 = post_var * (2.0 + y / 0.25)
    m0 = post_var * (-2.0 + y / 0.25)
    return {"p1": p1, "mean": p1 * m1 + (1 - p1) * m0,
            "sd1": math.sqrt(post_var)}


def vi_fit(batch, n_steps, seed=SEED):
    """The bench's ``vi`` target: REINFORCE over the component, a
    reparameterised location, trained with optax Adam."""
    import optax

    from genjax_tpu.inference import Target, vi
    from genjax_tpu.inference.sp import Marginal

    @g.gen
    def model_fn(phi):
        z = g.flip(0.5) @ "z"
        mu = g.normal(jnp.where(z, 2.0, -2.0), 1.0) @ "mu"
        _ = g.normal(mu, 0.5) @ "y"

    @g.gen
    def guide_fn(target):
        (phi,) = target.args
        z = vi.flip_reinforce(jax.nn.sigmoid(phi[0])) @ "z"
        zf = jnp.asarray(z, jnp.float32)
        m = zf * phi[1] + (1.0 - zf) * phi[3]
        s = jnp.exp(zf * phi[2] + (1.0 - zf) * phi[4])
        _ = vi.normal_reparam(m, s) @ "mu"

    guide = Marginal(
        guide_fn, g.Pytree.const(g.Selection.all()), g.Pytree.const(None)
    )
    elbo_grad = vi.ELBO(
        guide, lambda phi: Target(model_fn, (phi,), g.C["y"].set(1.5))
    )
    opt = optax.adam(0.1)

    @jax.jit
    def fit(key, phi):
        def step(carry, k):
            phi, state = carry
            grads = jax.vmap(lambda kk: elbo_grad(kk, (phi,))[0])(
                jr.split(k, batch)
            )
            grad = jnp.mean(grads, axis=0)
            updates, state = opt.update(grad, state, phi)
            return (optax.apply_updates(phi, updates), state), None

        (phi, _), _ = jax.lax.scan(
            step, (phi, opt.init(phi)), jr.split(key, n_steps)
        )
        return phi

    phi0 = jnp.array([0.0, 1.0, -1.0, -1.0, -1.0])
    return np.asarray(fit(jr.key(seed + 9), phi0))


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------


def phase_identity(sz):
    dev = require_gpu()
    print(f"  device_kind: {dev.device_kind}")
    print(f"  device_count: {len(jax.devices())}")
    import jaxlib

    print(f"  jax {jax.__version__} jaxlib {jaxlib.__version__}")
    print(f"  XLA_FLAGS: {os.environ.get('XLA_FLAGS', '')!r}")
    print(f"  compile cache: {jax.config.jax_compilation_cache_dir}")
    print(f"  nvidia-smi: {nvidia_smi()}")
    return []


def phase_gfi(sz):
    checks = compare_sir(sir_log_weights(sz.sir_particles))
    checks += compare_roundtrip(*edit_roundtrip(sz.edit_steps,
                                                sz.edit_traces))
    return checks


def phase_mcmc(sz):
    problem = regression_problem(sz.reg_rows, sz.reg_cols)
    checks = []
    for i, algorithm in enumerate(sz.algorithms):
        run = run_sample_posterior(problem, algorithm, sz,
                                   jr.key(SEED + 10 + i))
        checks += compare_posterior(
            f"regression_{algorithm}", run["draws"], run["ess"],
            problem["mean"], problem["cov"],
        )
    err, scale = regression_precision_probe(problem)
    print(f"  regression log-joint, default vs highest matmul precision: "
          f"max |diff| {err!r} nats at |log-joint| up to {scale!r}")
    checks += flagship_logdensity_checks(sz.flagship_assess_chains)
    sampler_checks, acc = flagship_sampler_checks(sz)
    print(f"  flagship column_hmc accept rate {acc!r}")
    return checks + sampler_checks


def phase_smc(sz):
    lz, exact = pf_log_evidence(sz.pf_particles, sz.pf_steps, sz.pf_seeds)
    return compare_log_evidence("pf", lz, exact)


def phase_latent_gaussian(sz):
    problem = gp_problem(sz.gp_dim)
    q = gp_ess_draws(problem, sz.gp_chains, sz.gp_steps)
    return compare_gaussian_moments("gp_ess", q, problem["mean"],
                                    problem["var"])


def phase_vi(sz):
    return compare_vi(vi_fit(sz.vi_batch, sz.vi_steps), vi_exact_posterior())


def phase_four_smc(sz):
    from genjax_tpu.parallel import make_mesh

    mesh = make_mesh(4)
    checks = []
    for mode in ("local", "all_gather"):
        lz, exact = pf_log_evidence(
            sz.four_pf_particles, sz.pf_steps, sz.pf_seeds, mesh=mesh,
            resample_mode=mode,
        )
        checks += compare_log_evidence(f"sharded_pf_{mode}", lz, exact)
    return checks


def phase_four_sample_posterior(sz):
    """``sample_posterior`` with its chains sharded over four cards against
    the same call on one device, with the same key:

    - the full run (warmup and draws): both against the exact posterior,
      and the adapted step size and metric against each other;
    - a six-window warmup of one transition each, then four draws: the
      adaptation as above, and the draws chain by chain.

    Chain by chain the two device counts part over a whole run: each
    rounds its matmuls and reductions in its own order, a chain whose
    accept or U-turn test lands within that rounding takes the other
    branch, and through the shared adaptation every chain's step size
    moves with it. The share of chains still together is printed for
    both runs."""
    from genjax_tpu.parallel import make_mesh

    problem = regression_problem(sz.reg_rows, sz.reg_cols)
    key = jr.key(SEED + 20)
    mesh = make_mesh(4)
    n = sz.four_reg_chains
    checks = []
    for label, run_sz in (
        ("full_warmup", sz),
        ("6_window_warmup", dataclasses.replace(sz, reg_warmup=6,
                                                reg_samples=4)),
    ):
        four = run_sample_posterior(problem, "nuts", run_sz, key, mesh=mesh,
                                    n_chains=n)
        one = run_sample_posterior(problem, "nuts", run_sz, key, n_chains=n)
        if run_sz is sz:
            for tag, run in (("mesh4", four), ("one_device", one)):
                checks += compare_posterior(
                    f"{tag}_nuts", run["draws"], run["ess"],
                    problem["mean"], problem["cov"],
                )
        name = f"mesh4_vs_one_device_{label}"
        checks += compare_mesh_adaptation(name, four, one, n)
        share = matching_chain_share(four, one)
        print(f"  {name}: share of chains together after each draw, "
              f"rtol 1e-4: {[float(s) for s in share]!r}")
        if run_sz is not sz:
            checks += compare_matching_chains(name, four, one)
    return checks


def data_sharded_value_and_grad(problem, mesh, n_chains, seed=SEED):
    """Value and gradient of the regression log-density with the data
    sharded over ``mesh``'s data axis, and of the same density unsharded;
    both at ``"highest"`` matmul precision."""
    from genjax_tpu.parallel import data_sharded_logdensity, shard_data

    X, y = problem["X"], problem["y"]
    s, p = problem["obs_scale"], problem["prior_scale"]

    def log_prior(q):
        return -0.5 * jnp.sum(q * q, axis=0) / p**2

    def log_lik(q, shard):
        xs, ys = shard
        r = ys[:, None] - jnp.dot(xs, q, precision="highest")
        return -0.5 * jnp.sum(r * r, axis=0) / s**2

    rng = np.random.default_rng(seed + 11)
    q = (problem["mean"][:, None]
         + 0.01 * rng.normal(size=(X.shape[1], n_chains))).astype(np.float32)

    def value_and_grad(ld):
        def f(q):
            lp, pull = jax.vjp(ld, q)
            return lp, pull(jnp.ones_like(lp))[0]

        return tuple(np.asarray(a) for a in jax.jit(f)(q))

    sharded = value_and_grad(data_sharded_logdensity(
        log_prior, log_lik,
        shard_data((jnp.asarray(X), jnp.asarray(y)), mesh), mesh,
    ))
    plain = value_and_grad(lambda q: log_prior(q) + log_lik(q, (X, y)))
    return sharded, plain


def phase_four_data_sharded(sz):
    from genjax_tpu.parallel import make_mesh_2d

    problem = regression_problem(sz.reg_rows, sz.reg_cols)
    (v4, g4), (v1, g1) = data_sharded_value_and_grad(
        problem, make_mesh_2d((1, 4)), 256
    )
    return (
        compare_close("data_sharded_value", v4, v1, rtol=1e-5, atol=1e-3)
        + compare_close("data_sharded_grad", g4, g1, rtol=1e-4,
                        atol=1e-5 * float(np.max(np.abs(g1))))
    )


ONE_CARD = (
    ("0 identity", phase_identity),
    ("1 gfi core", phase_gfi),
    ("2 mcmc", phase_mcmc),
    ("3 smc", phase_smc),
    ("4 latent gaussian", phase_latent_gaussian),
    ("5 vi", phase_vi),
)
FOUR_CARDS = (
    ("0 identity", phase_identity),
    ("4a sharded smc", phase_four_smc),
    ("4b sample_posterior on a mesh", phase_four_sample_posterior),
    ("4c data-sharded log-density", phase_four_data_sharded),
)


# ----------------------------------------------------------------------
# driver
# ----------------------------------------------------------------------


class _CompileClock:
    """Sums JAX's own tracing, lowering and backend-compile durations."""

    EVENTS = (
        "/jax/core/compile/jaxpr_trace_duration",
        "/jax/core/compile/jaxpr_to_mlir_module_duration",
        "/jax/core/compile/backend_compile_duration",
    )

    def __init__(self):
        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_kw):
        if event in self.EVENTS:
            self.seconds += duration


def run_phase(name, fn, sz, clock):
    """Run one phase and print its timings, peak memory and comparisons.
    Raises :class:`SmokeFailure` when a comparison failed."""
    print(f"phase {name}", flush=True)
    c0, t0 = clock.seconds, time.perf_counter()
    checks = fn(sz)
    wall = time.perf_counter() - t0
    compile_s = clock.seconds - c0
    stats = jax.devices()[0].memory_stats() or {}
    print(f"  compile_seconds={compile_s:.3f} "
          f"run_seconds={max(wall - compile_s, 0.0):.3f} "
          f"wall_seconds={wall:.3f}")
    print(f"  peak_bytes_in_use={stats.get('peak_bytes_in_use', 'n/a')}")
    for c in checks:
        print(c.line())
    bad = failed(checks)
    if bad:
        raise SmokeFailure(
            f"phase {name}: " + ", ".join(c.name for c in bad)
        )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded checks, on four cards")
    args = ap.parse_args(argv)
    cache = setup_compile_cache()
    require_gpu()
    if args.four and len(jax.devices()) != 4:
        raise SystemExit(
            f"--four needs 4 devices, JAX sees {len(jax.devices())}"
        )
    print(f"compile cache: {cache}; {device_fields()}", flush=True)
    clock = _CompileClock()
    failures = []
    for name, fn in FOUR_CARDS if args.four else ONE_CARD:
        try:
            run_phase(name, fn, FULL, clock)
        except Exception as e:  # report every phase; exit 1 below
            traceback.print_exc()
            print(f"  PHASE FAILED: {type(e).__name__}: {e}", flush=True)
            failures.append(name)
            if name == "0 identity":
                break
    if failures:
        print(f"failed phases: {failures}", flush=True)
        return 1
    print(result_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
