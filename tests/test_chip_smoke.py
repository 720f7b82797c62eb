"""``chip_smoke.py``'s phases at tiny sizes on the CPU: each phase's
workload runs through the same entry points, and its comparison passes on
the computed answer and fails on a perturbed one."""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

TINY = dataclasses.replace(
    cs.FULL,
    edit_steps=50, edit_traces=16,
    reg_rows=500, reg_cols=4, reg_chains=256, reg_warmup=200,
    reg_samples=50, algorithms=("chees",),
    flagship_chains=1024, flagship_assess_chains=64, flagship_steps=100,
    pf_particles=1024, pf_steps=20, pf_seeds=8,
    gp_dim=16, gp_chains=2048, gp_steps=300,
    vi_batch=512,
)


def assert_passes(checks):
    assert checks and not cs.failed(checks), [c.line() for c in checks]


def assert_fails(checks):
    assert cs.failed(checks), [c.line() for c in checks]


def test_check_line_reports_value_reference_tol_precision():
    c = cs.Check("x", 1.5, 1.0, 0.25, "float32", "detail")
    assert not c.ok
    line = c.line()
    for part in ("FAIL", "value=1.5", "reference=1.0", "tol=0.25",
                 "precision=float32", "detail"):
        assert part in line
    assert not cs.Check("nan", float("nan"), 0.0, 1.0, "float32").ok


def test_sir():
    lw = cs.sir_log_weights(TINY.sir_particles)
    assert_passes(cs.compare_sir(lw))
    assert_fails(cs.compare_sir(lw + 0.05))


def test_edit_roundtrip():
    fwd, bwd, score_err = cs.edit_roundtrip(TINY.edit_steps,
                                            TINY.edit_traces)
    assert fwd.shape == (TINY.edit_traces,)
    assert_passes(cs.compare_roundtrip(fwd, bwd, score_err))
    assert_fails(cs.compare_roundtrip(fwd, bwd + 0.01, score_err))
    assert_fails(cs.compare_roundtrip(fwd, bwd, score_err + 0.01))


def test_regression_problem_is_the_conjugate_posterior():
    p = cs.regression_problem(200, 3)
    X = p["X"].astype(np.float64)
    prec = np.eye(3) + X.T @ X / 0.25**2
    np.testing.assert_allclose(np.linalg.inv(p["cov"]), prec, rtol=1e-10)
    np.testing.assert_allclose(
        prec @ p["mean"], X.T @ p["y"].astype(np.float64) / 0.25**2,
        rtol=1e-8,
    )


@pytest.mark.parametrize(
    "perturb, should_pass",
    [("none", True), ("shift_mean", False), ("inflate_sd", False)],
)
def test_compare_posterior(perturb, should_pass):
    rng = np.random.default_rng(0)
    mean = np.asarray([0.5, -1.0, 2.0])
    cov = np.diag([0.01, 0.04, 0.09])
    draws = rng.multivariate_normal(mean, cov, size=(400, 50))
    ess = np.full(3, 400 * 50.0)
    if perturb == "shift_mean":
        draws = draws + 10 * np.sqrt(np.diag(cov) / ess)
    if perturb == "inflate_sd":
        draws = mean + 1.2 * (draws - mean)
    checks = cs.compare_posterior("p", draws, ess, mean, cov)
    (assert_passes if should_pass else assert_fails)(checks)


def test_sample_posterior_regression():
    p = cs.regression_problem(TINY.reg_rows, TINY.reg_cols)
    run = cs.run_sample_posterior(p, "chees", TINY, cs.jr.key(1))
    draws, ess = run["draws"], run["ess"]
    assert draws.shape == (TINY.reg_chains, TINY.reg_samples, TINY.reg_cols)
    assert_passes(cs.compare_posterior("chees", draws, ess, p["mean"],
                                       p["cov"]))
    assert_fails(cs.compare_posterior("chees", draws + 0.01, ess,
                                      p["mean"], p["cov"]))


def test_compare_mesh_run():
    rng = np.random.default_rng(2)
    one = {"draws": rng.normal(size=(200, 5, 3)), "eps": 0.5,
           "inv_mass": np.ones(3)}
    n = 4096  # inverse-mass limit 5 sqrt(2 / n) = 0.11
    assert_passes(cs.compare_mesh_adaptation("m", dict(one), one, n))
    assert_passes(cs.compare_mesh_adaptation(
        "m", dict(one, eps=0.52, inv_mass=np.asarray([1.0, 1.05, 0.95])),
        one, n))
    assert_fails(cs.compare_mesh_adaptation("m", dict(one, eps=0.55), one,
                                            n))
    assert_fails(cs.compare_mesh_adaptation(
        "m", dict(one, inv_mass=np.asarray([1.0, 1.0, 1.2])), one, n))
    assert_passes(cs.compare_matching_chains("m", dict(one), one))
    # one chain of 200 took another path: within the allowed share
    drift = dict(one, draws=one["draws"].copy())
    drift["draws"][7] += 1.0
    assert_passes(cs.compare_matching_chains("m", drift, one))
    drift["draws"][:5] += 1.0
    assert_fails(cs.compare_matching_chains("m", drift, one))


def test_matching_chain_share_counts_a_chain_gone_for_good():
    rng = np.random.default_rng(3)
    one = {"draws": rng.normal(size=(4, 3, 2))}
    four = {"draws": one["draws"].copy()}
    four["draws"][0, 1] += 1.0  # chain 0 leaves at draw 1, back at draw 2
    four["draws"][1, 2] += 1.0  # chain 1 leaves at draw 2
    np.testing.assert_allclose(cs.matching_chain_share(four, one),
                               [1.0, 0.75, 0.5])


def test_phase_four_sample_posterior_on_a_cpu_mesh(capsys):
    # the --four phase at a tiny size on four of the virtual CPU devices,
    # where every chain stays with the one-device run
    sz = dataclasses.replace(TINY, four_reg_chains=256, reg_warmup=60,
                             reg_samples=20)
    assert_passes(cs.phase_four_sample_posterior(sz))
    assert "share of chains together after each draw" in (
        capsys.readouterr().out
    )


def test_regression_precision_probe_is_exact_on_cpu():
    err, scale = cs.regression_precision_probe(
        cs.regression_problem(100, 3), n_chains=8
    )
    assert err == 0.0 and scale > 0.0


def test_flagship_logdensity():
    checks = cs.flagship_logdensity_checks(TINY.flagship_assess_chains)
    assert_passes(checks)
    v = np.linspace(-50.0, -10.0, 8)
    assert_fails(cs.compare_logdensity("ld", v * (1 + 1e-4), v))


def test_flagship_samplers():
    checks, acc = cs.flagship_sampler_checks(TINY)
    assert 0.3 < acc <= 1.0
    assert_passes(checks)
    rng = np.random.default_rng(1)
    a = rng.normal(size=(3, 4096))
    assert_fails(cs.compare_samplers("s", a, a + 0.2))


def test_particle_filter_log_evidence():
    lz, exact = cs.pf_log_evidence(TINY.pf_particles, TINY.pf_steps,
                                   TINY.pf_seeds)
    assert lz.shape == (TINY.pf_seeds,)
    assert_passes(cs.compare_log_evidence("pf", lz, exact))
    assert_fails(cs.compare_log_evidence("pf", lz, exact + 1.0))


def test_gp_latents():
    p = cs.gp_problem(TINY.gp_dim)
    q = cs.gp_ess_draws(p, TINY.gp_chains, TINY.gp_steps)
    assert q.shape == (TINY.gp_dim, TINY.gp_chains)
    assert_passes(cs.compare_gaussian_moments("gp", q, p["mean"], p["var"]))
    shifted = q + 6 * np.sqrt(p["var"] / TINY.gp_chains)[:, None]
    assert_fails(cs.compare_gaussian_moments("gp", shifted, p["mean"],
                                             p["var"]))
    assert_fails(cs.compare_gaussian_moments(
        "gp", p["mean"][:, None] + 1.3 * (q - p["mean"][:, None]),
        p["mean"], p["var"],
    ))


def test_gp_reference_is_the_models_gp_closed_form():
    import jax
    import jax.numpy as jnp

    from genjax_tpu.models import gp_posterior

    p = cs.gp_problem(TINY.gp_dim)
    with jax.default_matmul_precision("highest"):
        mean, cov = gp_posterior(p["x"], p["y"], p["x"], 1.0, 1.0,
                                 p["noise"], jitter=1e-4)
    np.testing.assert_allclose(np.asarray(mean), p["mean"], atol=1e-3)
    np.testing.assert_allclose(np.asarray(jnp.diag(cov)), p["var"],
                               atol=1e-3)


def test_vi():
    phi = cs.vi_fit(TINY.vi_batch, TINY.vi_steps)
    exact = cs.vi_exact_posterior()
    assert_passes(cs.compare_vi(phi, exact))
    assert_fails(cs.compare_vi(phi + np.asarray([0, 0.2, 0, 0.2, 0]),
                               exact))


def test_vi_exact_posterior_by_quadrature():
    """The closed form against numerical integration over mu."""
    from scipy.stats import norm

    mu = np.linspace(-12, 12, 200_001)
    joint = 0.5 * (norm.pdf(mu, 2, 1) + norm.pdf(mu, -2, 1)) * norm.pdf(
        1.5, mu, 0.5
    )
    exact = cs.vi_exact_posterior()
    assert np.sum(mu * joint) / np.sum(joint) == pytest.approx(
        exact["mean"], abs=1e-6
    )


def test_data_sharded_value_and_grad():
    from genjax_tpu.parallel import make_mesh_2d

    p = cs.regression_problem(400, 4)
    (v4, g4), (v1, g1) = cs.data_sharded_value_and_grad(
        p, make_mesh_2d((1, 4)), 64
    )
    checks = (cs.compare_close("v", v4, v1, rtol=1e-5, atol=1e-3)
              + cs.compare_close("g", g4, g1, rtol=1e-4, atol=1e-3))
    assert_passes(checks)
    assert_fails(cs.compare_close("v", v4 + 0.5, v1, rtol=1e-5, atol=1e-3))


def test_phases_are_listed_in_order():
    names = [n for n, _ in cs.ONE_CARD]
    assert names[0] == "0 identity" and len(names) == 6
    assert [n for n, _ in cs.FOUR_CARDS][0] == "0 identity"


def test_main_refuses_the_cpu(capsys, monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    from chip_env import NoGPUError

    with pytest.raises(NoGPUError):
        cs.main([])
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("fail_phase", [None, "raises", "check"])
def test_main_exits_nonzero_when_a_phase_fails(capsys, monkeypatch,
                                               tmp_path, fail_phase):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(cs, "require_gpu", lambda: None)
    ran = []

    def good(sz):
        ran.append("good")
        return [cs.Check("fine", 1.0, 1.0, 0.1, "float32")]

    def bad(sz):
        ran.append("bad")
        if fail_phase == "raises":
            raise RuntimeError("boom")
        return [cs.Check("off", 2.0, 1.0, 0.1, "float32")]

    phases = [("1 good", good)]
    if fail_phase:
        phases.append(("2 bad", bad))
    phases.append(("3 good", good))
    monkeypatch.setattr(cs, "ONE_CARD", tuple(phases))
    rc = cs.main([])
    out = capsys.readouterr().out
    # every phase runs, and the result line is printed only on success
    assert ran == [p[0].split()[1] for p in phases]
    if fail_phase:
        assert rc == 1 and '"ok"' not in out
        assert "failed phases: ['2 bad']" in out
    else:
        assert rc == 0
        assert out.strip().splitlines()[-1].startswith('{"ok": true')
