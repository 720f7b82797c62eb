"""Benchmark matrix covering all five BASELINE.json configs.

Default (BENCH_MODE=all) runs every config and prints one JSON line
``{"metric","value","unit","platform","device_kind","device_count"}`` per
metric, the headline (fused column HMC @64k chains) LAST so single-line
parsers pick it up. A mode that fails prints a ``{mode}_error`` line, the
remaining modes still run, and the process exits 1. Set BENCH_MODE to run
one config:

  hmc     fused column-layout HMC, 64k chains, hierarchical regression
          (+ ESS/sec line from thinned cross-sweep draws)
  hmc_iid the plain HMC sweep on a d=8 iid-normal target, 64k chains:
          the time a fused GPU sweep kernel has to beat
  nuts    fused column-layout NUTS, 64k chains, same model
  chees   ChEES-adaptive HMC (trajectory length/step size/mass adapted
          jointly from cross-chain statistics), same model
  chains  trace-based GFI chains (run_chains, lanes layout)
  gfi     the GFI-abstraction tax: same model/chains/transition through
          the per-transition edit API, the batched trace sweep driver
          (run_chains_hmc), and the column kernel; emits gfi_overhead_x
  pf      adaptive-resampling particle filter, linear-Gaussian SSM
  sir     README-quickstart beta-bernoulli SIR (50 particles x trials)
  vi      ADEV ELBO gradient steps (reparam guide, conjugate target)
  dp      DP-mixture tempered SMC (stick-breaking, rung ladder)
  dense   dense mass-matrix HMC on a 128-dim correlated Gaussian (every
          phase is (D, D) x (D, N) matmuls)
  gp      elliptical slice sampling over GP latents (matmul-heavy ellipse
          draws; the latent-Gaussian workload profile)
  svgd    Stein variational particle flow on the flagship model (N x N
          Gram matmuls)

BENCH_CPU=1 runs on the CPU as a smoke test: the lines name the CPU as
their platform, and every roofline line reads "not measured".
The reference publishes no numbers (BASELINE.md).
"""

import json
import os
import sys
import time

import jax

from chip_env import device_fields, require_gpu, setup_compile_cache

import jax.numpy as jnp
import jax.random as jr
import numpy as np


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


_EMITTED: list = []


def _print_line(record):
    """Print one JSON result line, tagged with the device it ran on."""
    print(json.dumps({**record, **device_fields()}), flush=True)


def emit(metric, value, unit):
    record = {
        "metric": metric,
        # small values (ratios, efficiencies) keep 3 decimals; throughputs
        # keep 1
        "value": round(value, 3 if abs(value) < 100 else 1),
        "unit": unit,
        **device_fields(),
    }
    _EMITTED.append(record)
    _print_line(record)
    # every record is also persisted immediately, so a truncated stdout
    # capture (the driver keeps only the tail) never loses early modes
    try:
        with open("BENCH_EMITTED.json", "w") as f:
            json.dump(_EMITTED, f, indent=1)
    except OSError:
        pass


def _best_of(run_window, n=2):
    """Run a fully-synchronized timed window ``n`` times and keep the
    fastest. The windows are single device-resident dispatches; min()
    over two windows guards against transient contention on the host,
    which only ever ADDS time.

    ``run_window() -> dt_seconds`` must compile/warm before its first
    timed call.
    """
    return min(run_window() for _ in range(n))


def _ess_and_tau(stacked, n_draws, max_lag=32):
    """ESS with a SELF-CERTIFYING lag budget: compute
    τ̂ alongside ESS and, whenever τ̂ is not well inside the budget
    (τ̂ < lag/2), double the budget and recompute until it is or the
    draw count caps it. Returns ``(ess, tau_hat, lag_used, certified)``.
    """
    from genjax_tpu.inference.diagnostics import ess

    lag = min(n_draws - 1, max_lag)
    while True:
        e, (tau, _trunc) = ess(stacked, max_lag=lag, return_tau=True)
        e, tau = float(e), float(tau)
        if tau < lag / 2 or lag >= n_draws - 1:
            return e, tau, lag, tau < lag / 2
        lag = min(n_draws - 1, lag * 2)


def _ess_line(metric, sweep_draw, carry0, reps, *, max_lag=32):
    """ESS/sec (the north-star unit) for any sweep kernel.

    ``sweep_draw(carry, i) -> (carry, draw_row)`` runs ONE sweep and
    returns a per-chain scalar draw (thinning = the sweep length); the
    whole collection is a single jitted ``lax.scan`` so the measurement
    adds no per-sweep dispatch overhead. Timed over a second (warm) scan.

    Every ESS line is accompanied by its τ̂ (integrated autocorrelation
    time) so the lag budget is evidence, not an assumption: the budget
    doubles until τ̂ < budget/2 (``_ess_and_tau``), and the emitted unit
    string records both.
    """

    @jax.jit
    def collect(c):
        return jax.lax.scan(
            sweep_draw, c, 1000 + jnp.arange(reps, dtype=jnp.int32)
        )

    c, draws = collect(carry0)  # compile + warm
    _ = float(draws[0, 0])
    t0 = time.perf_counter()
    c, draws = collect(c)
    _ = float(draws[0, 0])
    dt = time.perf_counter() - t0
    stacked = jnp.transpose(draws)  # (chains, reps)
    total_ess, tau, lag, certified = _ess_and_tau(stacked, reps, max_lag)
    emit(metric, total_ess / dt, "ESS/sec/chip")
    emit(
        f"{metric}_tau_hat",
        tau,
        f"integrated autocorr time (lag budget {lag}, "
        f"{'tau < budget/2 certified' if certified else 'BUDGET-CAPPED'})",
    )
    return c


# Published peaks by ``device_kind`` (exact string, as JAX reports it):
# (peak_fp32_gflops, peak_bf16_gflops, hbm_gbytes_per_sec, peak_tf32_gflops).
# Source: NVIDIA H100 data sheet, SXM part, dense rates without sparsity:
# 67 TFLOP/s fp32 outside the tensor cores, 989 TFLOP/s bf16, 495 TFLOP/s
# TF32, 3.35 TB/s HBM3. The rates assume the card's full 700 W power limit.
_PEAKS = {
    "NVIDIA H100 80GB HBM3": (67_000.0, 989_000.0, 3350.0, 495_000.0),
}


def peaks_for(kind: str):
    """The :data:`_PEAKS` row for ``kind``; a kind the table does not
    know is an error, never a default."""
    try:
        return _PEAKS[kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device_kind {kind!r}; add its row to "
            "bench._PEAKS with a source"
        ) from None


def _device_peaks():
    """``(kind, peaks)`` for the running device, or ``None`` in a
    ``BENCH_CPU`` smoke run, whose roofline lines read "not measured".
    Any other device must have a :data:`_PEAKS` row."""
    if os.environ.get("BENCH_CPU"):
        return None
    kind = jax.devices()[0].device_kind
    return kind, peaks_for(kind)


def _not_measured(metric):
    _print_line({"metric": metric, "value": "not measured",
                 "unit": "no published peaks for the CPU"})


def _roofline(metric, jitted, args, dt_per_call, cost_scale=1.0, note=""):
    """Achieved GFLOP/s from XLA's own cost model, PLUS the roofline bound
    it must be compared against (achieved GFLOP/s without a bound is a
    number, not evidence).

    Emits three lines per mode:
      {metric}            achieved GFLOP/s     (flops / measured time)
      {metric}_bound      attainable GFLOP/s   min(peak, intensity x BW)
      {metric}_util       achieved / bound     with the binding resource
                                               named in the unit string

    CRITICAL COST-MODEL CAVEAT: XLA's cost_analysis counts while/scan loop
    BODIES ONCE, not x trip-count (verified: a 50-iteration scan of a
    matmul reports the same flops as one matmul). Callers must therefore pass a
    `jitted` whose loops have length 1 (or unrolled bodies) together with
    the measured wall time OF THAT UNIT (`dt_per_call`), and use
    `cost_scale` for any inner loop the unit still contains (e.g. the
    L-leapfrog fori_loop inside one HMC transition).

    The bound uses the unit program's flops and bytes-accessed counts:
    t_mem = bytes / HBM_BW, t_flop = flops / peak_fp32; whichever is
    larger binds. bytes-accessed is XLA's optimistic count (perfect
    fusion/reuse), so the memory bound is itself an upper bound on
    attainable throughput. Note that util = achieved/bound =
    max(t_mem, t_flop) / dt — flop-count errors cancel out of util
    whenever the mode is memory-bound."""
    try:
        ca = jitted.lower(*args).compile().cost_analysis()
        if isinstance(ca, list):
            ca = ca[0]
        flops = float(ca.get("flops", 0.0)) * cost_scale
        byt = float(ca.get("bytes accessed", 0.0)) * cost_scale
        if flops <= 0 or dt_per_call <= 0:
            return
        achieved = flops / dt_per_call / 1e9
        emit(metric, achieved, "GFLOP/s")
        peaks = _device_peaks()
        if peaks is None:
            _not_measured(f"{metric}_util")
            return
        kind, (peak_fp32, peak_bf16, hbm_gbs, _tf32) = peaks
        t_flop = flops / (peak_fp32 * 1e9)
        t_mem = byt / (hbm_gbs * 1e9) if byt > 0 else 0.0
        if t_flop <= 0 and t_mem <= 0:
            return
        binding = "memory" if t_mem > t_flop else "compute"
        bound = flops / max(t_flop, t_mem) / 1e9
        extra = f"; {note}" if note else ""
        if achieved > bound:
            if binding == "memory":
                # faster than the nominal memory bound: the cost model's
                # bytes-accessed overcounts true HBM traffic (it counts
                # per-op bytes pre-fusion) — the program is provably
                # compute-side, so re-base the bound to the compute
                # roofline. Elementwise-dominated modes should use
                # _resource_roofline instead (analytic bytes + measured
                # VPU ceilings) — this generic fallback quotes fp32 peak.
                binding = "compute (bytes-accessed is pre-fusion overcount)"
                bound = peak_fp32
                extra += (
                    "; exceeds nominal memory bound -> program is "
                    "compute-side; bound re-based to fp32 peak"
                )
            if achieved > peak_fp32:
                # faster than the nominal fp32 peak: XLA executes f32
                # matmuls at bf16 MXU rate here (allow_excess_precision)
                # — the honest ceiling is the bf16 peak
                binding = "compute (bf16-rate MXU)"
                bound = peak_bf16
                extra += (
                    "; exceeds fp32 peak -> f32 matmuls run at bf16 MXU "
                    "rate; bound re-based to bf16 peak"
                )
        emit(f"{metric}_bound", bound, f"GFLOP/s ({binding} roofline)")
        emit(
            f"{metric}_util",
            achieved / bound,
            f"fraction of {binding}-bound roofline "
            f"({byt / 1e6:.0f} MB, {flops / 1e9:.2f} GFLOP per unit, "
            f"{kind}{extra})",
        )
    except Exception as e:  # pragma: no cover — cost model availability
        _log(f"# cost_analysis unavailable for {metric}: {e}")



_VPU: dict = {}


def _vpu_ceilings():
    """EMPIRICAL per-chip VPU ceilings (measured once per bench run,
    cached): a chained-FMA loop and a chained-exp loop on an (8, 128k)
    f32 block, python-unrolled x128 inside one ``lax.scan`` body so XLA
    fuses each chain into a single kernel (per scan step: one read + one
    write of the block, 128 ops/element -> intensity ~64 ops/byte,
    decisively compute-bound).

    These are the honest compute rooflines for elementwise-dominated
    kernels: VPU code cannot approach the fp32 *matmul* peak (the MXU's
    number), so utilization quoted against fp32 peak systematically
    understates how close a non-MXU kernel is to its true ceiling. Rates
    are in G primitive-ops/s (one FMA or one exp element = one op).
    """
    if _VPU:
        return _VPU
    d, n = 8, 131072
    unroll = 128
    reps = int(os.environ.get("BENCH_VPU_REPS", 2000))
    cs = np.linspace(0.999, 1.001, unroll).astype(np.float32)
    bs = np.linspace(-1e-6, 1e-6, unroll).astype(np.float32)

    def fma_body(x, _):
        for i in range(unroll):
            # distinct constants per step: no CSE collapse, no folding
            x = x * float(cs[i]) + float(bs[i])
        return x, None

    def exp_body(x, _):
        for i in range(unroll):
            # bounded orbit in (c, 1 + c): never overflows
            x = jnp.exp(-jnp.abs(x)) + float(cs[i])
        return x, None

    x0 = np.random.default_rng(0).normal(size=(d, n)).astype(np.float32)
    for name, body in (("fma", fma_body), ("exp", exp_body)):
        run = jax.jit(
            lambda x, body=body: jax.lax.scan(body, x, None, length=reps)[0]
        )
        x = run(x0)
        _ = float(x[0, 0])
        t0 = time.perf_counter()
        x = run(x)
        _ = float(x[0, 0])
        dt = time.perf_counter() - t0
        _VPU[name] = d * n * unroll * reps / dt / 1e9
    emit(
        "vpu_fma_ceiling_gops",
        _VPU["fma"],
        "G FMA-ops/s (measured chained-FMA elementwise ceiling, this chip)",
    )
    emit(
        "vpu_exp_ceiling_gops",
        _VPU["exp"],
        "G exp-elements/s (measured chained-exp ceiling, this chip)",
    )
    return _VPU


# transcendental / multi-cycle VPU primitives (cost ~ the exp ceiling);
# everything else elementwise costs ~ the FMA ceiling
_TRANSC_PRIMS = frozenset({
    "exp", "exp2", "log", "log1p", "expm1", "pow", "tanh", "logistic",
    "sin", "cos", "tan", "asin", "acos", "atan", "atan2", "sinh", "cosh",
    "erf", "erfc", "erf_inv", "rsqrt", "sqrt", "cbrt", "digamma",
    "lgamma", "regularized_incomplete_beta", "igamma", "igammac",
})
# structural/free ops: no VPU arithmetic
_FREE_PRIMS = frozenset({
    "broadcast_in_dim", "reshape", "squeeze", "transpose", "copy",
    "convert_element_type", "bitcast_convert_type", "slice",
    "dynamic_slice", "dynamic_update_slice", "concatenate", "pad",
    "gather", "scatter", "iota", "stop_gradient", "select_n",
    "reduce_sum", "reduce_max", "reduce_min", "reduce_and", "reduce_or",
    "argmax", "argmin", "rev", "while", "cond", "scan", "pjit",
    "custom_jvp_call", "custom_vjp_call", "custom_vjp_call_jaxpr",
    "closed_call", "remat", "checkpoint",
})


def _jaxpr_op_census(fn, *args):
    """Count per-execution work in ``fn``'s jaxpr, recursing into
    sub-jaxprs (loop bodies counted ONCE — same caveat as
    ``cost_analysis``; callers scale interior loops explicitly).

    Returns ``(transc_elems, elem_ops, dot_flops)``: transcendental
    output elements, other elementwise output elements (~1 VPU op each;
    reductions/selects/moves counted free — an undercount that makes the
    derived time model a safer lower bound), and matmul FLOPs (2*M*N*K).
    """
    closed = jax.make_jaxpr(fn)(*args)
    counts = {"transc": 0, "elem": 0, "dot": 0}

    def out_elems(eqn):
        best = 0
        for v in eqn.outvars:
            shape = getattr(getattr(v, "aval", None), "shape", ())
            n = 1
            for s in shape:
                n *= int(s)
            best = max(best, n)
        return best

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            name = eqn.primitive.name
            if name == "dot_general":
                lhs, rhs = (v.aval.shape for v in eqn.invars[:2])
                (lc, rc), (lb, rb) = eqn.params["dimension_numbers"]
                contract = 1
                for ax in lc:
                    contract *= int(lhs[ax])
                batch = 1
                for ax in lb:
                    batch *= int(lhs[ax])
                lfree = 1
                for ax in range(len(lhs)):
                    if ax not in lc and ax not in lb:
                        lfree *= int(lhs[ax])
                rfree = 1
                for ax in range(len(rhs)):
                    if ax not in rc and ax not in rb:
                        rfree *= int(rhs[ax])
                counts["dot"] += 2 * batch * lfree * rfree * contract
            elif name in _TRANSC_PRIMS:
                counts["transc"] += out_elems(eqn)
            elif name not in _FREE_PRIMS:
                counts["elem"] += out_elems(eqn)
            for v in eqn.params.values():
                vs = v if isinstance(v, (tuple, list)) else (v,)
                for u in vs:
                    inner = getattr(u, "jaxpr", None)
                    if inner is not None:
                        walk(inner.jaxpr if hasattr(inner, "jaxpr") else inner)

    walk(closed.jaxpr)
    return counts["transc"], counts["elem"], counts["dot"]


def _time_scan_body(body, carry, reps):
    """Per-iteration wall time of ``body`` as one jitted, warmed
    ``lax.scan`` dispatch, best of two windows (the standard
    single-dispatch + contention-guard policy of :func:`_best_of`)."""
    run = jax.jit(
        lambda c: jax.lax.scan(body, c, jnp.arange(reps))[0]
    )
    c = run(carry)
    _ = float(jnp.ravel(c)[0])
    best = float("inf")
    for _i in range(2):
        t0 = time.perf_counter()
        c = run(c)
        _ = float(jnp.ravel(c)[0])
        best = min(best, time.perf_counter() - t0)
    return best / reps


def _resource_roofline(
    metric, jitted, args, dt_per_call, *, cost_scale=1.0,
    bytes_model, bytes_note, note="", vpu_time_override=None,
):
    """Roofline against an ANALYTIC resource model, for
    elementwise-dominated modes:

    - memory: ``bytes_model`` is a HAND-COUNTED per-unit HBM traffic
      model (terms documented in ``bytes_note``), not XLA's pre-fusion
      bytes-accessed; t_mem = bytes / HBM BW.
    - VPU: transcendental elements priced at the measured chained-exp
      ceiling, other elementwise ops at the measured chained-FMA ceiling
      (``_vpu_ceilings``; both are this-chip measurements, so the bound
      is attainable by construction).
    - MXU: dot FLOPs at the bf16 peak (XLA runs f32 matmuls at bf16 MXU
      rate under allow_excess_precision).

    The attainable-time lower bound is ``max(t_mem, t_vpu, t_mxu)``
    (VPU ops serialize on the VPU; MXU/memory overlap them). Emits the
    achieved GFLOP/s, the bound, a utilization fraction naming the
    binding resource with all three component times, and the bytes model
    as its own ``{metric}_bytes_model`` line.

    ``vpu_time_override=(seconds, note)`` replaces the census-derived
    VPU time with a MEASURED component decomposition (e.g. L standalone
    density-gradient evaluations + the momentum draw for HMC) — the
    jaxpr census prices mul+add pairs as two ops where the VPU executes
    one FMA, so for FMA-dense kernels the census-derived "lower bound"
    can exceed what the hardware demonstrably does; a measured
    composition of the kernel's own irreducible parts is exact."""
    try:
        ca = jitted.lower(*args).compile().cost_analysis()
        if isinstance(ca, list):
            ca = ca[0]
        flops = float(ca.get("flops", 0.0)) * cost_scale
        if flops <= 0 or dt_per_call <= 0:
            return
        achieved = flops / dt_per_call / 1e9
        emit(metric, achieved, "GFLOP/s")
        peaks = _device_peaks()
        if peaks is None:
            _not_measured(f"{metric}_util")
            return
        kind, (peak_fp32, peak_bf16, hbm_gbs, _tf32) = peaks
        vpu = _vpu_ceilings()
        transc, elem, dot = _jaxpr_op_census(jitted, *args)
        transc *= cost_scale
        elem *= cost_scale
        dot *= cost_scale
        t_mem = bytes_model / (hbm_gbs * 1e9)
        if vpu_time_override is not None:
            t_vpu, vpu_note = vpu_time_override
            vpu_desc = f"measured components: {vpu_note}"
        else:
            t_vpu = transc / (vpu["exp"] * 1e9) + elem / (vpu["fma"] * 1e9)
            vpu_desc = (
                f"census: {transc/1e6:.1f}M transc + {elem/1e6:.1f}M elem ops"
            )
        t_mxu = dot / (peak_bf16 * 1e9)
        t_lb, binding = max(
            (t_mem, "memory (analytic bytes model)"),
            (t_vpu, "VPU (measured)"),
            (t_mxu, "MXU (bf16 peak)"),
        )
        bound = flops / t_lb / 1e9
        detail = (
            f"mem {t_mem*1e6:.0f}us, vpu {t_vpu*1e6:.0f}us [{vpu_desc}], "
            f"mxu {t_mxu*1e6:.0f}us vs measured {dt_per_call*1e6:.0f}us; "
            f"binding: {binding}; {kind}{'; ' + note if note else ''}"
        )
        if vpu_time_override is not None and t_lb > dt_per_call:
            # the fused program runs FASTER than the sum of its own
            # measured standalone components: cross-step fusion beats the
            # naive composition. That is a ceiling certificate, not an
            # impossible >1 utilization — say so explicitly.
            emit(
                f"{metric}_bound",
                bound,
                f"GFLOP/s (measured-component composition bound; the "
                f"fused program EXCEEDS it — cross-step fusion beats the "
                f"sum of its standalone parts)",
            )
            emit(
                f"{metric}_util",
                t_lb / dt_per_call,
                f"t_components/t_measured; >1 = the fused sweep "
                f"outperforms the sum of its measured standalone parts "
                f"({detail}); headroom, if any, is algorithmic, not "
                f"scheduling",
            )
        else:
            emit(f"{metric}_bound", bound, f"GFLOP/s ({binding} roofline)")
            emit(
                f"{metric}_util",
                t_lb / dt_per_call,
                f"fraction of analytic lower-bound time ({detail})",
            )
        emit(
            f"{metric.replace('_achieved_gflops', '')}_bytes_model",
            bytes_model / 1e6,
            f"MB/unit hand-counted HBM traffic ({bytes_note})",
        )
    except Exception as e:  # pragma: no cover — cost model availability
        _log(f"# resource roofline unavailable for {metric}: {e}")


def _regression_setup():
    import genjax_tpu as g
    from genjax_tpu.kernels import ColumnPacker, column_logdensity
    from genjax_tpu.models import hierarchical_regression

    N = int(os.environ.get("BENCH_N", 16))
    D = int(os.environ.get("BENCH_D", 8))
    X = np.random.default_rng(0).normal(size=(N, D)).astype(np.float32)
    regression = hierarchical_regression(X)
    y_obs = np.random.default_rng(1).normal(size=(N,)).astype(np.float32)
    obs = g.C["y"].set(y_obs)
    packer = ColumnPacker(regression, obs, (), ["tau", "w"])
    ld = column_logdensity(regression, obs, (), packer)
    return regression, obs, packer, ld


def bench_hmc():
    """Headline: fused column HMC samples/sec/chip at 64k chains, plus an
    ESS/sec line from the per-sweep thinned draws."""
    from genjax_tpu.kernels import pallas_hmc

    n_chains = int(os.environ.get("BENCH_CHAINS", 65536))
    n_steps = int(os.environ.get("BENCH_STEPS", 50))
    reps = int(os.environ.get("BENCH_REPS", 600))
    L = 5
    regression, obs, packer, ld = _regression_setup()

    def init_one(k):
        tr, _ = regression.generate(k, obs, ())
        return packer.pack(tr.get_choices())

    @jax.jit
    def init(key):
        return jax.vmap(init_one, out_axes=1)(jr.split(key, n_chains))

    # Timed window = ONE dispatch (a jitted scan over all reps), so
    # per-dispatch latency is paid once per window.
    @jax.jit
    def run_reps(q, s0):
        def body(q, s):
            q, acc = pallas_hmc(
                ld, q, s, n_steps=n_steps, eps=0.02, L=L
            )
            return q, acc

        q, accs = jax.lax.scan(body, q, s0 + jnp.arange(reps))
        return q, jnp.mean(accs)

    _log("# hmc: init trace+compile start")
    q = init(jr.key(7))
    t_w = time.perf_counter()
    q, acc = run_reps(q, 0)
    _ = float(acc)
    _log(f"# hmc: warmup synced {time.perf_counter()-t_w:.1f}s")

    profile_dir = os.environ.get("BENCH_PROFILE")
    if profile_dir:
        jax.profiler.start_trace(profile_dir)

    st = {"q": q, "s": reps, "acc": None}

    def window():
        t0 = time.perf_counter()
        st["q"], st["acc"] = run_reps(st["q"], st["s"])
        _ = float(st["acc"])
        st["s"] += reps
        return time.perf_counter() - t0

    dt = _best_of(window)
    q, acc = st["q"], st["acc"]

    if profile_dir:
        jax.profiler.stop_trace()

    samples_per_sec = n_chains * n_steps * reps / dt

    # ESS/sec (north-star unit), measured in a SEPARATE timed phase: one
    # jitted scan runs sweeps and collects a param-0 slice per sweep
    # (thinning = n_steps), so the collection adds no per-sweep dispatch
    # overhead to the measurement.
    def sweep_draw(q, s):
        q, _acc = pallas_hmc(ld, q, s, n_steps=n_steps, eps=0.02, L=L)
        return q, q[0, :]

    _ess_line("hmc_ess_per_sec_per_chip", sweep_draw, q, min(reps, 25))

    _log(
        f"# hmc fused column; chains={n_chains} steps/sweep={n_steps} "
        f"reps={reps} L={L} wall={dt:.2f}s accept={float(acc):.2f} "
        f"device={jax.devices()[0].device_kind}"
    )
    emit(
        f"hmc_samples_per_sec_per_chip_{n_chains}chains",
        samples_per_sec,
        "samples/sec/chip",
    )
    # cost unit = ONE transition (n_steps=1); its L-leapfrog fori body is
    # counted once by the cost model, so scale by L (the accept/momentum
    # overhead gets scaled too — a small overcount, bound stays valid)
    step1 = jax.jit(
        lambda q, s: pallas_hmc(ld, q, s, n_steps=1, eps=0.02, L=L)
    )
    # hand-counted HBM traffic per transition: the
    # scan carries (q, lp, g); per transition those are read+written
    # (4 DN passes, lp is (N,) — negligible) and the momentum block is
    # written by the rbg kernel then read (2 DN). The L leapfrogs
    # themselves are loop-RESIDENT: the per-leapfrog streaming model
    # (q/p/g read+write x L) is also computed below
    # and would cap throughput BELOW the measured rate, which proves XLA
    # keeps the trajectory out of HBM.
    d_pad, n_ch = q.shape
    bytes_fused = 6 * d_pad * n_ch * 4
    bytes_streaming = bytes_fused * L
    peaks = _device_peaks()
    if peaks is None:
        _not_measured("hmc_achieved_gflops_util")
        return
    hbm_gbs = peaks[1][2]
    stream_cap = hbm_gbs * 1e9 / bytes_streaming * n_ch

    # MEASURED component decomposition of one transition (exact, unlike
    # the jaxpr census, which prices mul+add pairs as two ops where the
    # VPU executes one FMA): a transition is L density-gradient
    # evaluations + one (D, N) momentum draw + integrator/accept
    # elementwise residue. Time the first two as standalone minimal XLA
    # programs on the same shapes; their sum is an attainable lower
    # bound on the transition.
    def lpg_body(qq, _):
        lp, pull = jax.vjp(ld, qq)
        (g,) = pull(jnp.ones_like(lp))
        return qq + 1e-6 * g, None

    t_lpg = _time_scan_body(lpg_body, q, 2000)
    k_mom = jr.key(123, impl="rbg")

    def mom_body(qq, i):
        p = jr.normal(jr.fold_in(k_mom, i), qq.shape)
        return qq + 1e-9 * p, None

    t_mom = _time_scan_body(mom_body, q, 2000)
    emit(
        "hmc_density_grad_eval_us",
        t_lpg * 1e6,
        f"us per standalone density+gradient eval, ({d_pad}, {n_ch})",
    )
    _resource_roofline(
        "hmc_achieved_gflops",
        step1,
        (q, 0),
        dt / (reps * n_steps),
        cost_scale=L,
        bytes_model=bytes_fused,
        bytes_note=(
            f"per transition: q,g carry r+w (4 DN f32) + momentum w+r "
            f"(2 DN), D={d_pad} N={n_ch}; per-leapfrog streaming model "
            f"= {bytes_streaming/1e6:.0f} MB would cap at "
            f"{stream_cap/1e6:.0f}M samples/s vs measured "
            f"{samples_per_sec/1e6:.0f}M -> trajectory is loop-resident"
        ),
        note="1-transition unit, leapfrog loop scaled by L",
        vpu_time_override=(
            L * t_lpg + t_mom,
            f"L x density-grad ({t_lpg*1e6:.0f}us standalone) + momentum "
            f"draw ({t_mom*1e6:.0f}us); residual = integrator+accept",
        ),
    )


def bench_hmc_iid():
    """The plain-JAX HMC sweep (``kernels.hmc._reference_hmc``) on a d = 8
    iid-normal target, whose log-density is elementwise: 65,536 chains,
    L = 5, 50 transitions per sweep. This is the regime where a one-launch
    fused GPU sweep could beat XLA's per-leapfrog kernels; its time is
    the bar such a kernel has to beat."""
    from genjax_tpu.kernels.hmc import _reference_hmc

    n_chains = int(os.environ.get("BENCH_CHAINS", 65536))
    d, n_steps, L, reps = 8, 50, 5, 20

    def ld(q):
        return -0.5 * jnp.sum(q * q, axis=0)

    @jax.jit
    def run_reps(q, s0):
        def body(q, s):
            return _reference_hmc(ld, q, s, n_steps=n_steps, eps=0.2, L=L)

        q, accs = jax.lax.scan(body, q, s0 + jnp.arange(reps))
        return q, jnp.mean(accs)

    q0 = np.random.default_rng(0).normal(size=(d, n_chains))
    st = {"q": jnp.asarray(q0, jnp.float32), "s": 0}

    def window():
        t0 = time.perf_counter()
        st["q"], acc = run_reps(st["q"], st["s"])
        _ = float(acc)
        st["s"] += reps
        return time.perf_counter() - t0

    window()  # compile and warm
    dt = _best_of(window)
    emit("hmc_iid_ms_per_sweep", dt / reps * 1e3,
         f"ms per {n_steps}-transition sweep, d={d} chains={n_chains} L={L}")
    emit(f"hmc_iid_transitions_per_sec_{n_chains}chains",
         n_chains * n_steps * reps / dt, "transitions/sec/chip")


def bench_nuts():
    """Fused column NUTS at 64k chains on the flagship model, run the way
    production runs it: windowed warmup adapts the step size and diagonal
    mass first, so trajectories terminate by U-turn instead of exhausting
    the depth budget at an unadapted tiny eps."""
    from genjax_tpu.kernels.nuts import nuts_sweep_cols, warmup_column_nuts

    n_chains = int(os.environ.get("BENCH_CHAINS", 65536))
    n_steps = int(os.environ.get("BENCH_NUTS_STEPS", 10))
    reps = int(os.environ.get("BENCH_NUTS_REPS", 300))
    max_depth = int(os.environ.get("BENCH_NUTS_DEPTH", 8))
    regression, obs, packer, ld = _regression_setup()

    def init_one(k):
        tr, _ = regression.generate(k, obs, ())
        return packer.pack(tr.get_choices())

    @jax.jit
    def init(key):
        return jax.vmap(init_one, out_axes=1)(jr.split(key, n_chains))

    q = init(jr.key(3))
    t_w = time.perf_counter()
    q, eps, inv_mass = warmup_column_nuts(
        ld, q, 11, eps0=0.1, max_depth=max_depth
    )
    _log(
        f"# nuts: warmup adapted eps={eps:.4f} in "
        f"{time.perf_counter()-t_w:.1f}s"
    )

    # single-dispatch timed window
    @jax.jit
    def run_reps(q, s0):
        def body(q, s):
            q, acc, leaps = nuts_sweep_cols(
                ld, q, s, n_steps=n_steps, eps=eps, max_depth=max_depth,
                inv_mass=inv_mass,
            )
            return q, (acc, leaps)

        q, (accs, leapss) = jax.lax.scan(body, q, s0 + jnp.arange(reps))
        return q, accs[-1], jnp.mean(leapss)

    t_w = time.perf_counter()
    q, acc, leaps = run_reps(q, 0)
    _ = float(acc)
    _log(f"# nuts: sweep compiled+synced {time.perf_counter()-t_w:.1f}s")
    st = {"q": q, "s": reps, "out": None}

    def window():
        t0 = time.perf_counter()
        st["q"], acc_, leaps_ = run_reps(st["q"], st["s"])
        _ = float(acc_)
        st["out"] = (acc_, leaps_)
        st["s"] += reps
        return time.perf_counter() - t0

    dt = _best_of(window)
    q, (acc, leaps) = st["q"], st["out"]
    rate = n_chains * n_steps * reps / dt
    _log(
        f"# nuts; chains={n_chains} steps={n_steps} reps={reps} wall={dt:.2f}s "
        f"accept_stat={float(acc):.2f} mean_leapfrogs={float(leaps):.1f}"
    )
    emit(
        f"nuts_samples_per_sec_per_chip_{n_chains}chains",
        rate,
        "samples/sec/chip",
    )
    # ---- tree accounting: a NUTS transition costs
    # mean_leapfrogs gradient evaluations, so leapfrogs/s — not
    # transitions/s — is the number comparable to HMC's gradient-eval
    # rate (hmc does exactly L=5 per transition). The ratio says how much
    # of the tree bookkeeping (checkpoint buffers, U-turn tests,
    # collective early exit) shows up as per-leapfrog overhead. ----
    mean_leaps = float(leaps)
    leap_rate = rate * mean_leaps
    emit("nuts_mean_leapfrogs_per_transition", mean_leaps, "leapfrogs")
    emit(
        "nuts_mean_tree_depth",
        float(np.log2(mean_leaps + 1.0)),
        "log2(leapfrogs+1)",
    )
    emit("nuts_leapfrogs_per_sec", leap_rate, "leapfrogs/sec/chip")
    hmc_rate = None
    for rec in _EMITTED:
        if rec["metric"].startswith("hmc_samples_per_sec_per_chip"):
            hmc_rate = rec["value"]
    if hmc_rate:
        # hmc's bench fixes L=5 leapfrogs per transition on this model
        emit(
            "nuts_leapfrog_rate_vs_hmc_gradient_rate",
            leap_rate / (hmc_rate * 5.0),
            "fraction of the HMC sweep's leapfrogs/sec on the same model",
        )
    # ---- analytic bytes model for the leapfrog gap: unlike HMC's loop-resident trajectory, every
    # NUTS leapfrog streams its tree working set through HBM — the
    # while-loop carry (z, r, g, z_prop read+write = 8 (D, N) passes),
    # one checkpoint-slot push + an amortized-1 U-turn slot read (2
    # passes; the (max_depth+1, D, N) buffers update in place), and the
    # doubling merge's endpoint/proposal selects (~12 passes per
    # doubling, amortized over its 2^j leapfrogs). ----
    d_pad, n_ch = q.shape
    depth = float(np.log2(mean_leaps + 1.0))
    passes = 10.0 + 12.0 * depth / max(mean_leaps, 1.0)
    bytes_per_leap = passes * d_pad * n_ch * 4
    peaks = _device_peaks()
    if peaks is None:
        _not_measured("nuts_mem_util")
        return
    hbm_gbs2 = peaks[1][2]
    t_mem_leap = bytes_per_leap / (hbm_gbs2 * 1e9)
    t_leap_meas = n_chains / leap_rate  # per batch-leapfrog
    # the density+gradient evaluation is ADDITIVE on top of the
    # tree-state traffic (its own reads/writes/compute are not in the
    # passes count above) — measure it standalone on the same shapes
    def lpg_body(qq, _):
        lp, pull = jax.vjp(ld, qq)
        (g,) = pull(jnp.ones_like(lp))
        return qq + 1e-6 * g, None

    t_lpg = _time_scan_body(lpg_body, q, 1000)
    emit(
        "nuts_bytes_model",
        bytes_per_leap / 1e6,
        f"MB/leapfrog hand-counted tree-state HBM traffic ({passes:.1f} "
        f"(D, N) passes: 8 carry r+w + 2 checkpoint slot ops + "
        f"doubling-merge selects amortized; D={d_pad} N={n_ch})",
    )
    emit(
        "nuts_mem_util",
        (t_mem_leap + t_lpg) / t_leap_meas,
        f"fraction of the per-leapfrog composition bound: tree-state "
        f"traffic ({t_mem_leap*1e6:.0f}us) + standalone density-grad "
        f"eval ({t_lpg*1e6:.0f}us) vs {t_leap_meas*1e6:.0f}us measured. "
        f"The leapfrog gap vs HMC is the tree working set streaming "
        f"through HBM, which HMC's loop-resident trajectory never pays",
    )

    def sweep_draw(q, s):
        q, _acc, _l = nuts_sweep_cols(
            ld, q, s, n_steps=n_steps, eps=eps, max_depth=max_depth,
            inv_mass=inv_mass,
        )
        return q, q[0, :]

    _ess_line("nuts_ess_per_sec_per_chip", sweep_draw, q, max(reps, 10))


def bench_chains():
    """Trace-based MH-HMC chains through the full GFI (run_chains with the
    chains-on-lanes internal layout) on the flagship model."""
    import genjax_tpu as g

    n_chains = int(os.environ.get("BENCH_TRACE_CHAINS", 16384))
    n_steps = int(os.environ.get("BENCH_TRACE_STEPS", 20))
    reps = int(os.environ.get("BENCH_TRACE_REPS", 1500))
    regression, obs, _packer, _ld = _regression_setup()

    def init_one(k):
        tr, _ = regression.generate(k, obs, ())
        return tr

    def one_step(k, tr):
        _k0, k1 = jr.split(k)
        tr, acc = g.mh(k1, tr, g.HMC(g.S["w"] | g.S["tau"], 0.02, L=5))
        return tr, acc

    @jax.jit
    def sweep(key, trs):
        def body(trs, kk):
            ks = jr.split(kk, n_chains)
            trs, accs = jax.vmap(
                one_step, in_axes=(0, -1), out_axes=(-1, 0)
            )(ks, trs)
            return trs, jnp.mean(accs)

        trs, accs = jax.lax.scan(body, trs, jr.split(key, n_steps))
        return trs, jnp.mean(accs)

    # The timed window is ONE dispatch: a jitted scan over all reps, so
    # per-dispatch latency jitter is paid once per window.
    @jax.jit
    def run_reps(key, trs):
        def body(trs, kk):
            trs, acc = sweep(kk, trs)
            return trs, acc

        trs, accs = jax.lax.scan(body, trs, jr.split(key, reps))
        return trs, jnp.mean(accs)

    # threefry root keys: vmapped per-chain SMALL draws would hit
    # RngBitGenerator's per-call overhead, the opposite regime from the
    # column sweep's (D, N) bulk draws
    trs = jax.jit(
        lambda key: jax.vmap(init_one, out_axes=-1)(jr.split(key, n_chains))
    )(jr.key(0))
    trs, acc = run_reps(jr.key(1), trs)  # compile + warm
    _ = float(acc)
    st = {"trs": trs, "i": 2, "acc": None}

    def window():
        t0 = time.perf_counter()
        st["trs"], st["acc"] = run_reps(jr.key(st["i"]), st["trs"])
        _ = float(st["acc"])
        st["i"] += 1
        return time.perf_counter() - t0

    dt = _best_of(window)
    trs, acc = st["trs"], st["acc"]
    _log(
        f"# trace-chains; chains={n_chains} steps={n_steps} reps={reps} "
        f"wall={dt:.2f}s accept={float(acc):.2f}"
    )
    emit(
        f"trace_mcmc_transitions_per_sec_{n_chains}chains",
        n_chains * n_steps * reps / dt,
        "transitions/sec/chip",
    )

    ess_key = jr.key(5)

    def sweep_draw(trs, s):
        trs, _acc = sweep(jr.fold_in(ess_key, s), trs)
        tau = trs.get_choices()["tau"]
        return trs, jnp.ravel(tau)

    _ess_line(
        "trace_mcmc_ess_per_sec_per_chip", sweep_draw, trs, min(reps, 25)
    )


def bench_gfi():
    """The GFI-abstraction tax, measured apples-to-apples: the SAME posterior (flagship hierarchical regression), SAME chain
    count, SAME transition unit — momentum refresh, L=5 leapfrogs at
    eps=0.02, identity metric, MH accept — through three drivers:

      trace   the per-transition edit API: ``mh(HMC(...))`` vmapped over
              chains, a fresh trace materialized per transition
      sweep   ``run_chains_hmc`` — the batched trace driver: the GFI's own
              ``assess`` as the density, z-space column sweep with bulk
              momenta, ONE vmapped Update write-back per 20-transition call
      column  ``kernels/hmc.py`` on the packer's ``column_logdensity``
              (the bypass path every headline number uses)

    Emits all three rates plus ``gfi_overhead_x = column/sweep`` (what a
    user pays for the recommended @gen driver vs the hand-packed kernel)
    and ``gfi_overhead_per_transition_api_x = column/trace`` (the cost of
    materializing a trace per transition)."""
    import genjax_tpu as g
    from genjax_tpu.inference.mcmc import run_chains_hmc
    from genjax_tpu.kernels import pallas_hmc

    n_chains = int(os.environ.get("BENCH_GFI_CHAINS", 65536))
    n_steps = int(os.environ.get("BENCH_GFI_STEPS", 20))
    eps, L = 0.02, 5
    regression, obs, packer, ld = _regression_setup()
    sel = g.S["w"] | g.S["tau"]

    def init_lanes(key):
        return jax.vmap(
            lambda k: regression.generate(k, obs, ())[0], out_axes=-1
        )(jr.split(key, n_chains))

    rates = {}

    # --- (a) per-transition edit API (bench_chains structure) ---------
    reps_a = int(os.environ.get("BENCH_GFI_TRACE_REPS", 300))

    def one_step(k, tr):
        _k0, k1 = jr.split(k)
        return g.mh(k1, tr, g.HMC(sel, eps, L=L))

    @jax.jit
    def run_trace(key, trs):
        def sweep(trs, kk):
            def body(trs, k2):
                ks = jr.split(k2, n_chains)
                trs, accs = jax.vmap(
                    one_step, in_axes=(0, -1), out_axes=(-1, 0)
                )(ks, trs)
                return trs, jnp.mean(accs)

            trs, accs = jax.lax.scan(body, trs, jr.split(kk, n_steps))
            return trs, jnp.mean(accs)

        trs, accs = jax.lax.scan(sweep, trs, jr.split(key, reps_a))
        return trs, jnp.mean(accs)

    # --- (b) batched trace sweep driver -------------------------------
    reps_b = int(os.environ.get("BENCH_GFI_SWEEP_REPS", 600))

    @jax.jit
    def run_sweep(key, trs):
        def body(trs, kk):
            trs, acc = run_chains_hmc(
                kk, trs, sel, eps=eps, L=L, n_steps=n_steps, chain_axis=-1
            )
            return trs, acc

        trs, accs = jax.lax.scan(body, trs, jr.split(key, reps_b))
        return trs, jnp.mean(accs)

    # --- (c) column path ----------------------------------------------
    reps_c = int(os.environ.get("BENCH_GFI_COLUMN_REPS", 600))

    @jax.jit
    def run_column(q, s0):
        def body(q, s):
            return pallas_hmc(ld, q, s, n_steps=n_steps, eps=eps, L=L)

        q, accs = jax.lax.scan(body, q, s0 + jnp.arange(reps_c))
        return q, accs[-1]

    def init_cols(key):
        def one(k):
            tr, _ = regression.generate(k, obs, ())
            return packer.pack(tr.get_choices())

        return jax.vmap(one, out_axes=1)(jr.split(key, n_chains))

    # run all three with the standard warm + best-of-2 single-dispatch
    # windows; acc readback is the sync
    specs = [
        ("trace", run_trace, lambda: init_lanes(jr.key(101)), reps_a),
        ("sweep", run_sweep, lambda: init_lanes(jr.key(102)), reps_b),
        ("column", run_column, lambda: init_cols(jr.key(103)), reps_c),
    ]
    for name, runner, init, reps in specs:
        if name == "column":
            st = {"x": init(), "k": 0, "acc": None}

            def window(st=st, runner=runner, reps=reps):
                t0 = time.perf_counter()
                st["x"], st["acc"] = runner(st["x"], st["k"])
                _ = float(st["acc"])
                st["k"] += reps
                return time.perf_counter() - t0

            st["x"], st["acc"] = runner(st["x"], st["k"])  # compile+warm
            _ = float(st["acc"])
            st["k"] += reps
        else:
            st = {"x": init(), "k": 0, "acc": None}

            def window(st=st, runner=runner):
                t0 = time.perf_counter()
                st["x"], st["acc"] = runner(jr.key(st["k"]), st["x"])
                _ = float(st["acc"])
                st["k"] += 1
                return time.perf_counter() - t0

            st["x"], st["acc"] = runner(jr.key(999), st["x"])  # compile+warm
            _ = float(st["acc"])
        dt = _best_of(window)
        rates[name] = n_chains * n_steps * reps / dt
        _log(
            f"# gfi [{name}]: chains={n_chains} steps={n_steps} reps={reps} "
            f"wall={dt:.2f}s accept={float(st['acc']):.2f} "
            f"rate={rates[name]/1e6:.1f}M/s"
        )
        emit(
            f"gfi_{name}_transitions_per_sec_{n_chains}chains",
            rates[name],
            "transitions/sec/chip",
        )
    emit("gfi_overhead_x", rates["column"] / rates["sweep"], "x (column/sweep)")
    emit(
        "gfi_overhead_per_transition_api_x",
        rates["column"] / rates["trace"],
        "x (column/per-transition-edit API)",
    )


def bench_pf():
    """Adaptive systematic-resampling particle filter, linear-Gaussian SSM."""
    import genjax_tpu as g
    from genjax_tpu.models import linear_gaussian_ssm
    from genjax_tpu.parallel import SSMParticleFilter

    K = int(os.environ.get("BENCH_PARTICLES", 131072))
    T = int(os.environ.get("BENCH_T", 100))
    reps = int(os.environ.get("BENCH_REPS", 20))
    thresh = float(os.environ.get("BENCH_PF_THRESH", 0.5))
    kernel, _ = linear_gaussian_ssm()
    ys = jnp.zeros(T)
    obs = g.C[:, "y"].set(ys)
    pf = SSMParticleFilter(kernel, n_particles=K, ess_threshold=thresh)
    # single-dispatch timed window: scan over seeds
    @jax.jit
    def run_reps(s0):
        def body(_, s):
            out = pf.run(
                jr.fold_in(jr.key(0), s), 0.0, jnp.zeros(T), obs
            )
            return None, out.log_marginal
        _, lzs = jax.lax.scan(body, None, s0 + jnp.arange(reps))
        return lzs[-1]

    lz = run_reps(0)
    _ = float(lz)
    st = {"s": reps, "lz": None}

    def window():
        t0 = time.perf_counter()
        st["lz"] = run_reps(st["s"])
        _ = float(st["lz"])
        st["s"] += reps
        return time.perf_counter() - t0

    dt = _best_of(window)
    lz = st["lz"]
    _log(
        f"# pf; K={K} T={T} reps={reps} wall={dt:.2f}s "
        f"logZ={float(lz):.1f}"
    )
    emit(
        f"smc_particle_steps_per_sec_{K}particles",
        K * T * reps / dt,
        "particle-steps/sec/chip",
    )
    # ---- step decomposition: where does the PF step go? The three
    # components are measured standalone with the same single-dispatch
    # windows: the vmapped GFI extend, the ESS reduction, and the
    # systematic resample. The firing rate comes from the run's own
    # ess_history. ----
    from genjax_tpu.parallel.resampling import (
        effective_sample_size,
        resample_particles,
    )

    dec_key = jr.key(77)

    def extend_body(c, i):
        ks = jr.split(jr.fold_in(dec_key, i), K)

        def ext(pkey, cc):
            tr, w = kernel.generate(pkey, obs.get_submap(0), (cc, 0.0))
            c_new, _y = tr.get_retval()
            return c_new, w

        cs, ws = jax.vmap(ext)(ks, c)
        return cs + ws * 1e-30, None

    t_ext = _time_scan_body(extend_body, jnp.zeros(K), 20000)

    def ess_body(c, i):
        return c + effective_sample_size(c) * 1e-30, None

    t_ess = _time_scan_body(ess_body, jnp.zeros(K), 50000)

    def res_body(c, i):
        lw = jr.normal(jr.fold_in(dec_key, i), (K,))
        return resample_particles(
            jr.fold_in(dec_key, i), c, lw, K, "systematic"
        ), None

    t_res = _time_scan_body(res_body, jnp.zeros(K), 1000)
    # resample firing rate from a fresh run's ess history
    hist = pf.run(jr.key(5), 0.0, jnp.zeros(T), obs).ess_history
    fire = float(jnp.mean((hist < thresh * K).astype(jnp.float32)))
    t_step_meas = dt / (T * reps)
    t_model = t_ext + t_ess + fire * t_res
    emit("pf_resample_us", t_res * 1e6, "us per systematic resample (standalone)")
    emit(
        "pf_step_model_util",
        t_model / t_step_meas,
        f"fraction of the measured step explained by components (extend "
        f"{t_ext*1e6:.0f}us + ESS {t_ess*1e6:.0f}us + {fire:.2f} x "
        f"resample {t_res*1e6:.0f}us vs {t_step_meas*1e6:.0f}us "
        f"measured)",
    )


def bench_sir():
    """README-quickstart beta-bernoulli SIR: 50-particle importance
    estimates, measured as SIR estimates/sec over a large trial batch."""
    import genjax_tpu as g

    K = 50
    trials = int(os.environ.get("BENCH_SIR_TRIALS", 65536))
    reps = int(os.environ.get("BENCH_SIR_REPS", 20))

    @g.gen
    def beta_bernoulli():
        p = g.beta(2.0, 2.0) @ "p"
        v = g.flip(p) @ "v"
        return v

    obs = g.C["v"].set(True)

    def one_sir(key):
        ks = jr.split(key, K)
        trs, ws = jax.vmap(
            lambda k: beta_bernoulli.generate(k, obs, ())
        )(ks)
        idx = jr.categorical(jr.fold_in(key, 1), ws)
        return trs.get_choices()["p"][idx]

    def run(s):
        return jax.vmap(one_sir)(
            jr.split(jr.fold_in(jr.key(0), s), trials)
        )

    # single-dispatch timed window: scan over seeds
    @jax.jit
    def run_reps(s0):
        _, pss = jax.lax.scan(
            lambda _, s: (None, run(s)), None, s0 + jnp.arange(reps)
        )
        return pss[-1]

    ps = run_reps(0)
    _ = float(ps[0])
    st = {"s": reps, "ps": None}

    def window():
        t0 = time.perf_counter()
        st["ps"] = run_reps(st["s"])
        _ = float(st["ps"][0])
        st["s"] += reps
        return time.perf_counter() - t0

    dt = _best_of(window)
    ps = st["ps"]
    _log(
        f"# sir; K={K} trials={trials} reps={reps} wall={dt:.2f}s "
        f"posterior_mean={float(jnp.mean(ps)):.3f}"
    )
    emit("sir_estimates_per_sec", trials * reps / dt, "SIR-estimates/sec/chip")


def bench_vi():
    """ADEV ELBO gradient-step throughput on the BASELINE.json-named
    workload: a two-component Gaussian MIXTURE model, guide = REINFORCE
    over the component indicator + reparameterized component location
    (the reparam + REINFORCE estimator pair), batched gradient estimates
    per step."""
    import genjax_tpu as g
    from genjax_tpu.inference import Target, vi

    batch = int(os.environ.get("BENCH_VI_BATCH", 4096))
    reps = int(os.environ.get("BENCH_VI_REPS", 4000))

    from genjax_tpu.inference.sp import Marginal

    @g.gen
    def model_fn(phi):  # phi rides through Target.args for the guide
        z = g.flip(0.5) @ "z"
        mu = g.normal(jnp.where(z, 2.0, -2.0), 1.0) @ "mu"
        _ = g.normal(mu, 0.5) @ "y"

    @g.gen
    def guide_fn(target):
        (phi,) = target.args
        # REINFORCE through the discrete component choice...
        z = vi.flip_reinforce(jax.nn.sigmoid(phi[0])) @ "z"
        zf = jnp.asarray(z, jnp.float32)
        m = zf * phi[1] + (1.0 - zf) * phi[3]
        s = jnp.exp(zf * phi[2] + (1.0 - zf) * phi[4])
        # ...reparameterization through the continuous location
        _ = vi.normal_reparam(m, s) @ "mu"

    guide = Marginal(
        guide_fn, g.Pytree.const(g.Selection.all()), g.Pytree.const(None)
    )
    obs = g.C["y"].set(1.5)
    elbo_grad = vi.ELBO(guide, lambda phi: Target(model_fn, (phi,), obs))

    def step(key, phi):
        grads = jax.vmap(lambda k: elbo_grad(k, (phi,))[0])(
            jr.split(key, batch)
        )
        g_mean = jax.tree_util.tree_map(lambda v: jnp.mean(v, axis=0), grads)
        return phi - 0.05 * g_mean  # descent on the negative ELBO

    # single-dispatch timed window: one jitted scan over all reps, so
    # dispatch jitter is paid once
    @jax.jit
    def run_reps(key, phi):
        def body(phi, kk):
            return step(kk, phi), None

        phi, _ = jax.lax.scan(body, phi, jr.split(key, reps))
        return phi

    # phi = (component logit, mu1, log_s1, mu0, log_s0)
    phi = jnp.array([0.0, 1.0, -1.0, -1.0, -1.0])
    phi = run_reps(jr.key(0), phi)
    _ = float(phi[0])
    st = {"phi": phi, "i": 1}

    def window():
        t0 = time.perf_counter()
        st["phi"] = run_reps(jr.key(st["i"]), st["phi"])
        _ = float(st["phi"][0])
        st["i"] += 1
        return time.perf_counter() - t0

    dt = _best_of(window)
    phi = st["phi"]
    _log(
        f"# vi (mixture, reparam+reinforce); batch={batch} reps={reps} "
        f"wall={dt:.2f}s phi={[round(float(p), 3) for p in phi]}"
    )
    emit(
        "vi_mixture_gradient_estimates_per_sec", batch * reps / dt,
        "grad-estimates/sec/chip",
    )


def bench_dp():
    """Tempered SMC on the truncated stick-breaking DP mixture."""
    import genjax_tpu as g
    from genjax_tpu.inference.tempered import geometric_ladder, tempered_smc
    from genjax_tpu.models import dp_mixture_model

    K = int(os.environ.get("BENCH_DP_PARTICLES", 4096))
    n_rungs = int(os.environ.get("BENCH_DP_RUNGS", 10))
    n_data = int(os.environ.get("BENCH_DP_DATA", 60))
    reps = int(os.environ.get("BENCH_DP_REPS", 200))
    k_trunc = 8

    model = dp_mixture_model(k_trunc)
    rng = np.random.default_rng(0)
    centers = np.array([-4.0, 0.0, 4.0])
    data = jnp.asarray(
        centers[rng.integers(0, 3, n_data)]
        + 0.4 * rng.normal(size=n_data),
        jnp.float32,
    )
    constraint = g.C["obs", :, "x"].set(data)
    betas = geometric_ladder(n_rungs)

    def run(s):
        return tempered_smc(
            jr.fold_in(jr.key(0), s), model, constraint, (data,),
            n_particles=K, betas=betas,
        ).log_marginal

    # single-dispatch timed window: scan over seeds
    @jax.jit
    def run_reps(s0):
        _, lms = jax.lax.scan(
            lambda _, s: (None, run(s)), None, s0 + jnp.arange(reps)
        )
        return lms[-1]

    lm = run_reps(0)
    _ = float(lm)
    st = {"s": reps, "lm": None}

    def window():
        t0 = time.perf_counter()
        st["lm"] = run_reps(st["s"])
        _ = float(st["lm"])
        st["s"] += reps
        return time.perf_counter() - t0

    dt = _best_of(window)
    lm = st["lm"]
    _log(
        f"# dp; K={K} rungs={n_rungs} n_data={n_data} reps={reps} "
        f"wall={dt:.2f}s logZ={float(lm):.1f}"
    )
    emit(
        "dp_mixture_particle_rungs_per_sec", K * n_rungs * reps / dt,
        "particle-rungs/sec/chip",
    )


def bench_chees():
    """ChEES-adaptive HMC on the flagship model: trajectory length, step
    size, and diagonal mass adapt jointly from cross-chain statistics
    (kernels/chees.py). Reported as samples/s and ESS/sec at the adapted
    settings — the turn-key number to compare against hmc's fixed-L and
    nuts' tree-based rates."""
    from genjax_tpu.kernels import chees_hmc

    n_chains = int(os.environ.get("BENCH_CHAINS", 65536))
    n_warmup = int(os.environ.get("BENCH_CHEES_WARMUP", 200))
    n_steps = int(os.environ.get("BENCH_CHEES_STEPS", 25))
    reps = int(os.environ.get("BENCH_CHEES_REPS", 1200))
    regression, obs, packer, ld = _regression_setup()

    def init_one(k):
        tr, _ = regression.generate(k, obs, ())
        return packer.pack(tr.get_choices())

    @jax.jit
    def init(key):
        return jax.vmap(init_one, out_axes=1)(jr.split(key, n_chains))

    q = init(jr.key(21))
    t_w = time.perf_counter()
    q, info = jax.jit(
        lambda q: chees_hmc(
            ld, q, 23, n_warmup=n_warmup, n_steps=0, eps0=0.02
        )
    )(q)
    eps_f = float(info.eps)
    traj = float(info.trajectory_length)
    inv_mass = info.inv_mass
    _log(
        f"# chees: warmup adapted eps={eps_f:.4f} traj={traj:.3f} in "
        f"{time.perf_counter()-t_w:.1f}s"
    )

    def sample(q, s):
        return chees_hmc(
            ld, q, s, n_warmup=0, n_steps=n_steps, eps0=eps_f, t0=traj,
            inv_mass=inv_mass, adapt_mass=False, collect=True,
        )

    # single-dispatch timed window: the scan carries q between reps;
    # only the final rep's collected draws are kept
    @jax.jit
    def run_reps(q, s0):
        def body(q, s):
            q, info = sample(q, s)
            return q, None
        q, _ = jax.lax.scan(body, q, s0 + jnp.arange(reps - 1))
        return sample(q, s0 + reps - 1)

    q, info = run_reps(q, 100)
    _ = float(info.accept_rate)
    st = {"q": q, "s": 100 + reps, "info": None}

    def window():
        t0 = time.perf_counter()
        st["q"], st["info"] = run_reps(st["q"], st["s"])
        _ = float(st["info"].accept_rate)
        st["s"] += reps
        return time.perf_counter() - t0

    dt = _best_of(window)
    q, info = st["q"], st["info"]
    rate = n_chains * n_steps * reps / dt
    # ESS from the last rep's collected first-coordinate draws, with a
    # self-certified lag budget (τ̂ emitted alongside)
    stacked = jnp.transpose(info.draws[:, 0, :])  # (chains, n_steps)
    total_ess, tau, lag, certified = _ess_and_tau(stacked, n_steps)
    # ESS of the final rep over its share of the wall clock
    ess_rate = total_ess / (dt / reps)
    _log(
        f"# chees; chains={n_chains} steps={n_steps} reps={reps} "
        f"wall={dt:.2f}s accept={float(info.accept_rate):.2f} "
        f"mean_L={float(info.mean_leapfrogs):.1f}"
    )
    emit(
        f"chees_samples_per_sec_per_chip_{n_chains}chains",
        rate,
        "samples/sec/chip",
    )
    emit("chees_ess_per_sec_per_chip", ess_rate, "ESS/sec/chip")
    emit(
        "chees_ess_per_sec_per_chip_tau_hat",
        tau,
        f"integrated autocorr time (lag budget {lag}, "
        f"{'tau < budget/2 certified' if certified else 'BUDGET-CAPPED'})",
    )


def bench_dense():
    """Dense mass-matrix HMC on a 128-dim correlated Gaussian: momentum
    refresh, kinetic energy, position preconditioning, and the target's
    own density/gradient are all (D, D) x (D, N) matmuls
    (kernels/dense_mass.py)."""
    from genjax_tpu.kernels.dense_mass import (
        hmc_sweep_dense_cols,
        warmup_column_dense,
    )

    d = int(os.environ.get("BENCH_DENSE_D", 128))
    n_chains = int(os.environ.get("BENCH_DENSE_CHAINS", 16384))
    n_steps = int(os.environ.get("BENCH_DENSE_STEPS", 25))
    reps = int(os.environ.get("BENCH_DENSE_REPS", 800))
    L = 5

    # Correlated target: Sigma* = A A^T / d + 0.05 I (host numpy), worked
    # in precision form so the log-density is itself a matmul.
    rng = np.random.default_rng(0)
    A = rng.normal(size=(d, d))
    sigma_t = (A @ A.T / d + 0.05 * np.eye(d)).astype(np.float64)
    prec_t = np.linalg.inv(sigma_t).astype(np.float32)
    chol_t = np.linalg.cholesky(sigma_t).astype(np.float32)

    def ld(q):
        return -0.5 * jnp.sum(q * (jnp.asarray(prec_t) @ q), axis=0)

    q0 = np.asarray(
        chol_t @ rng.normal(size=(d, n_chains)), np.float32
    )
    q0, eps, cov_chol = warmup_column_dense(
        ld, jnp.asarray(q0), 0, n_phases=4, steps_per_phase=10, eps0=0.5,
        L=L,
    )
    eps_f = float(eps)

    @jax.jit
    def run_reps(q, cov_chol, s0):
        def body(q, s):
            q, acc = hmc_sweep_dense_cols(
                ld, q, s, n_steps=n_steps, eps=eps_f, L=L,
                cov_chol=cov_chol,
            )
            return q, acc

        q, accs = jax.lax.scan(body, q, s0 + jnp.arange(reps))
        return q, accs[-1]

    q, acc = run_reps(q0, cov_chol, 0)
    _ = float(acc)
    st = {"q": q, "s": reps, "acc": None}

    def window():
        t0 = time.perf_counter()
        st["q"], st["acc"] = run_reps(st["q"], cov_chol, st["s"])
        _ = float(st["acc"])
        st["s"] += reps
        return time.perf_counter() - t0

    dt = _best_of(window)
    q, acc = st["q"], st["acc"]
    _log(
        f"# dense-hmc; D={d} chains={n_chains} steps={n_steps} reps={reps} "
        f"L={L} wall={dt:.2f}s accept={float(acc):.2f}"
    )
    emit(
        f"dense_hmc_transitions_per_sec_{d}d_{n_chains}chains",
        n_chains * n_steps * reps / dt,
        "transitions/sec/chip",
    )
    # roofline: 1-transition unit; its L-leapfrog fori body (2 matmuls +
    # the density's own matmul pair) is counted once -> scale by L
    step1 = jax.jit(
        lambda q, cov_chol, s: hmc_sweep_dense_cols(
            ld, q, s, n_steps=1, eps=eps_f, L=L, cov_chol=cov_chol
        )[0]
    )
    _roofline(
        "dense_hmc_achieved_gflops",
        step1,
        (q, cov_chol, 0),
        dt / (reps * n_steps),
        cost_scale=L,
        note="1-transition unit, leapfrog loop scaled by L",
    )


def bench_gp():
    """Elliptical slice sampling over GP latents: per transition the
    ellipse draw is a (D, D) @ (D, N) matmul; with the
    Gaussian-likelihood fast path the shrink loop is O(N) trig algebra —
    the latent-Gaussian workload profile, complementary to hmc's
    gradient-bound one."""
    d_latent = int(os.environ.get("BENCH_GP_D", 256))
    n_chains = int(os.environ.get("BENCH_GP_CHAINS", 8192))
    n_steps = int(os.environ.get("BENCH_GP_STEPS", 50))
    reps = int(os.environ.get("BENCH_GP_REPS", 400))

    # host numpy for all constants, INCLUDING the Gram matrix: K must be
    # fp64-accurate for the host Cholesky
    rng = np.random.default_rng(0)
    X = rng.uniform(0.0, 10.0, size=(d_latent, 1))
    d2 = (X - X.T) ** 2
    K = np.exp(-0.5 * d2) + 1e-4 * np.eye(d_latent)  # fp64
    chol = np.linalg.cholesky(K).astype(np.float32)
    f_true = (chol @ rng.normal(size=d_latent)).astype(np.float32)
    noise = 0.3
    y = (f_true + noise * rng.normal(size=d_latent)).astype(np.float32)

    # Gaussian observation noise -> the trig-quadratic fast path: the
    # shrink loop runs on six (N,) coefficient vectors instead of (D, N)
    # likelihood passes, leaving the transition bound by the ellipse-draw
    # matmul (kernels/elliptical.py ess_sweep_gauss_cols; same Markov
    # chain as the generic kernel, verified in test_elliptical.py).
    from genjax_tpu.kernels import ess_sweep_gauss_cols

    prec = 1.0 / noise**2
    # rbg bulk draws for the dominant (D, N) ellipse draw (chees does the
    # same)
    rng_impl = os.environ.get("BENCH_GP_RNG", "rbg")

    # single-dispatch timed window
    @jax.jit
    def run_reps(q, s0):
        return jax.lax.scan(
            lambda qq, s: (
                ess_sweep_gauss_cols(
                    qq, s, n_steps=n_steps, chol_prior=chol, y=y,
                    prec=prec, rng_impl=rng_impl,
                )[0],
                None,
            ),
            q,
            s0 + jnp.arange(reps),
        )[0]

    q = jnp.zeros((d_latent, n_chains), jnp.float32)
    t_w = time.perf_counter()
    q = run_reps(q, 0)
    _ = float(q[0, 0])
    _log(f"# gp-ess: warmup synced {time.perf_counter()-t_w:.1f}s")
    st = {"q": q, "s": reps}

    def window():
        t0 = time.perf_counter()
        st["q"] = run_reps(st["q"], st["s"])
        _ = float(st["q"][0, 0])
        st["s"] += reps
        return time.perf_counter() - t0

    dt = _best_of(window)
    q = st["q"]
    _log(
        f"# gp-ess; D={d_latent} chains={n_chains} steps={n_steps} "
        f"reps={reps} wall={dt:.2f}s"
    )
    emit(
        f"gp_ess_transitions_per_sec_{d_latent}d",
        n_chains * n_steps * reps / dt,
        "transitions/sec/chip",
    )
    # achieved GFLOP/s of one transition (the ellipse draw is a
    # (D, D) @ (D, N) matmul). On the fast path the
    # shrink body the cost model counts once is O(N) — negligible — so
    # the 1-transition unit cost is essentially exact.
    step1 = jax.jit(
        lambda q, s: ess_sweep_gauss_cols(
            q, s, n_steps=1, chol_prior=chol, y=y, prec=prec,
            rng_impl=rng_impl,
        )[0]
    )
    _roofline(
        "gp_achieved_gflops",
        step1,
        (q, 0),
        dt / (reps * n_steps),
        note="1-transition unit, O(N) shrink body",
    )

    def sweep_draw(q, s):
        q = ess_sweep_gauss_cols(
            q, s, n_steps=n_steps, chol_prior=chol, y=y, prec=prec,
            rng_impl=rng_impl,
        )[0]
        return q, q[0, :]

    _ess_line("gp_mcmc_ess_per_sec_per_chip", sweep_draw, q, max(reps, 10))


def bench_svgd():
    """SVGD particle-flow throughput on the flagship regression posterior
    via the column bridge: each update is an (N, N) RBF Gram matrix plus
    two (D, N) x (N, N) matmuls — the matmul-bound inference workload."""
    from genjax_tpu.kernels.model_interface import column_svgd

    n_particles = int(os.environ.get("BENCH_SVGD_PARTICLES", 4096))
    n_steps = int(os.environ.get("BENCH_SVGD_STEPS", 100))
    reps = int(os.environ.get("BENCH_SVGD_REPS", 100))
    regression, obs, _packer, _ld = _regression_setup()

    def run(seed):
        q, _ = column_svgd(
            regression, obs, (), ["tau", "w"],
            n_particles=n_particles, n_steps=n_steps, seed=seed,
        )
        return q

    # single-dispatch timed window: scan over seeds
    @jax.jit
    def run_reps(s0):
        _, qs = jax.lax.scan(
            lambda _, s: (None, run(s)), None, s0 + jnp.arange(reps)
        )
        return qs[-1]

    q = run_reps(0)
    _ = float(q[0, 0])
    st = {"s": reps, "q": None}

    def window():
        t0 = time.perf_counter()
        st["q"] = run_reps(st["s"])
        _ = float(st["q"][0, 0])
        st["s"] += reps
        return time.perf_counter() - t0

    dt = _best_of(window)
    q = st["q"]
    _log(
        f"# svgd; particles={n_particles} steps={n_steps} reps={reps} "
        f"wall={dt:.2f}s"
    )
    emit(
        f"svgd_particle_updates_per_sec_{n_particles}p",
        n_particles * n_steps * reps / dt,
        "particle-updates/sec/chip",
    )
    # achieved GFLOP/s (the (N, N) Gram + two (D, N) x (N, N) matmuls).
    # Cost unit = a 1-step run (the SVGD step has no inner loops, so the
    # scan-body-once cost model is exact for it; particle init is
    # included — a small overcount on the unit).
    run1 = jax.jit(
        lambda seed: column_svgd(
            regression, obs, (), ["tau", "w"],
            n_particles=n_particles, n_steps=1, seed=seed,
        )[0]
    )
    # hand-counted HBM traffic per step: ONE
    # materialization of the N^2 Gram/exp block plus the (D, N) particle
    # and gradient carries. Two or more N^2 passes (write K + read it
    # back per consumer matmul) would need >= 2 N^2 x 4B / BW alone,
    # which exceeds the measured step time — proven infeasible, so the
    # consumers contract K tiles from VMEM (operand fusion).
    n_p = n_particles
    d_cols = 9  # packer real dim of the flagship model (tau + 8 w)
    svgd_bytes = n_p * n_p * 4 + 6 * d_cols * n_p * 4
    _resource_roofline(
        "svgd_achieved_gflops",
        run1,
        (0,),
        dt / (reps * n_steps),
        bytes_model=svgd_bytes,
        bytes_note=(
            f"per step: one N^2 Gram/exp materialization ({n_p}^2 f32) + "
            f"q/grad carries (6 DN); >=2 N^2 passes provably exceed the "
            f"measured step time"
        ),
        note="1-step unit incl. init",
    )


MODES = {
    "chains": bench_chains,
    "gfi": bench_gfi,
    "dense": bench_dense,
    "gp": bench_gp,
    "svgd": bench_svgd,
    "chees": bench_chees,
    "hmc": bench_hmc,
    "hmc_iid": bench_hmc_iid,
    "nuts": bench_nuts,
    "pf": bench_pf,
    "sir": bench_sir,
    "vi": bench_vi,
    "dp": bench_dp,
}


def main():
    if os.environ.get("BENCH_CPU"):
        jax.config.update("jax_platforms", "cpu")
    setup_compile_cache()
    if not os.environ.get("BENCH_CPU"):
        # the measurement never carries on quietly on another platform
        require_gpu()
    # A framework that does not import is a failed bench, not a quiet
    # stderr comment. Import ONCE, up front, loudly.
    try:
        import genjax_tpu  # noqa: F401
    except BaseException as e:
        _print_line({
            "metric": "bench_import_failure",
            "error": f"{type(e).__name__}: {e}",
        })
        raise
    mode = os.environ.get("BENCH_MODE", "all")
    if mode != "all":
        MODES[mode]()
        return 0
    # The headline (hmc) runs FIRST so it is recorded even if an external
    # timeout cuts the run short, and is RE-EMITTED last so single-line
    # parsers that keep only the final JSON line also pick it up.
    failed = []
    for name in (
        "hmc", "sir", "vi", "dp", "pf", "chains", "gfi", "nuts", "chees",
        "dense", "gp", "svgd", "hmc_iid",
    ):
        try:
            MODES[name]()
        except ImportError:
            # a broken framework import must abort the whole bench —
            # every later mode would silently run on a retry-import
            raise
        except Exception as e:  # one config failing must not stop the rest
            _log(f"# bench '{name}' FAILED: {type(e).__name__}: {e}")
            failed.append(name)
            # failed modes land IN the JSON record (a tail-truncated
            # capture drops stderr), so a missing metric is always
            # accompanied by its reason
            _print_line({
                "metric": f"{name}_error",
                "error": f"{type(e).__name__}: {e}"[:500],
            })
    headline = [r for r in _EMITTED if r["metric"].startswith("hmc_samples")]
    if headline:
        _print_line(headline[-1])
    if failed:
        _log(f"# failed modes: {failed}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
