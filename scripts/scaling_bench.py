"""Scaling-efficiency harness: sharded SMC and HMC throughput at 1..N
shards (BASELINE.json north star: >=90% linear scaling 1 host -> 4 hosts).

On real multi-chip hardware run as-is; without it, run on a simulated CPU
mesh to validate the *program structure* (collective placement, shard
layouts):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    SCALING_CPU=1 python scripts/scaling_bench.py

Note: CPU-mesh timings measure emulation, not the cards' interconnect —
the efficiency numbers only become meaningful on real chips; the harness
records them either way.

Two CPU accountings (see SCALING.md):

* **time-slice** (default): N virtual devices share all physical cores.
  Weak scaling past the core count *cannot* stay linear — total work grows
  with N but compute does not — and the 1-shard baseline is additionally
  inflated by XLA intra-op threading across every core. This accounting
  validates program structure, not efficiency.
* **core-proportional** (``SCALING_PROPORTIONAL=1``): shard count s runs in
  a fresh subprocess pinned to s physical cores (``taskset -c 0..s-1``),
  so each simulated "host" contributes exactly one core — the CPU analog
  of adding a chip per shard. Efficiency under this accounting is the
  honest CPU proxy for the >=90% north star; the residual it measures is
  collective + runtime overhead, the part a multi-card run also pays.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

if os.environ.get("SCALING_CPU"):
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import jax.random as jr


def sync(x):
    return float(jnp.sum(jax.tree_util.tree_leaves(x)[0]))


# Short timing windows on a shared microVM host are dominated by
# scheduling noise (3x swings observed run-to-run). Methodology: per
# (mode, shard-count), time TRIALS windows of `reps` dispatches each and
# keep the FASTEST window — the least-interference estimate of the
# program's actual rate.
TRIALS = int(os.environ.get("SCALING_TRIALS", 3))

# Per-shard workload sizes. The defaults keep a window under ~1 s on this
# microVM; raise them (core-proportional mode does) so per-device compute
# dominates per-dispatch host overhead — at the default tiny sizes the
# measurement is dispatch-bound and says nothing about scaling.
PARTICLES = int(os.environ.get("SCALING_PARTICLES", 4096))
PF_T = int(os.environ.get("SCALING_T", 20))
CHAINS = int(os.environ.get("SCALING_CHAINS", 1024))
CHAIN_STEPS = int(os.environ.get("SCALING_STEPS", 20))


def _best_rate(run, sync_out, work_per_rep, reps):
    _ = sync_out(run(0))  # compile + warm
    best = float("inf")
    for t in range(TRIALS):
        t0 = time.perf_counter()
        out = None
        for i in range(1, reps + 1):
            out = run(1 + t * reps + i)
        _ = sync_out(out)
        best = min(best, time.perf_counter() - t0)
    return work_per_rep * reps / best


def bench_pf(n_shards: int, n_particles: int, T: int) -> float:
    import genjax_tpu as g
    from genjax_tpu.parallel import SSMParticleFilter, make_mesh

    @g.gen
    def kernel(c, x):
        z = g.normal(c, 1.0) @ "z"
        y = g.normal(z, 0.5) @ "y"
        return (z, y)

    mesh = make_mesh(n_shards)
    ys = jnp.zeros(T)
    obs = g.C[:, "y"].set(ys)
    pf = SSMParticleFilter(kernel, n_particles=n_particles)

    run = lambda s: pf.run_sharded(jr.key(s), 0.0, jnp.zeros(T), obs, mesh)
    return _best_rate(
        run, lambda o: sync(o.log_weights), n_particles * T, reps=10
    )


def bench_chains(n_shards: int, n_chains: int, n_steps: int) -> float:
    import genjax_tpu as g
    from genjax_tpu.parallel import make_mesh, run_chains_sharded

    @g.gen
    def model():
        mu = g.normal(0.0, 1.0) @ "mu"
        _ = g.normal(mu, 1.0) @ "y"

    obs = g.C["y"].set(2.0)
    mesh = make_mesh(n_shards)

    def make_trace(k):
        tr, _ = model.generate(k, obs, ())
        return tr

    run = lambda s: run_chains_sharded(
        jr.key(s), make_trace, g.HMC(g.S["mu"], 0.3, L=5),
        n_steps=n_steps, n_chains=n_chains, mesh=mesh,
    )
    return _best_rate(
        run, lambda o: sync(o.accept_rate), n_chains * n_steps, reps=6
    )


def run_timeslice(shard_counts):
    results = {"pf": {}, "chains": {}}
    for s in shard_counts:
        # weak scaling: work per shard constant
        pf_rate = bench_pf(s, n_particles=PARTICLES * s, T=PF_T)
        ch_rate = bench_chains(s, n_chains=CHAINS * s, n_steps=CHAIN_STEPS)
        results["pf"][s] = pf_rate
        results["chains"][s] = ch_rate
        print(
            f"shards={s}: PF {pf_rate/1e6:.2f}M particle-steps/s, "
            f"chains {ch_rate/1e6:.2f}M transitions/s",
            file=sys.stderr,
        )

    base_pf = results["pf"][1]
    base_ch = results["chains"][1]
    for s in shard_counts[1:]:
        results.setdefault("efficiency", {})[s] = {
            "pf": results["pf"][s] / (base_pf * s),
            "chains": results["chains"][s] / (base_ch * s),
        }
    return results


def run_proportional(max_cores: int):
    """Core-proportional weak scaling: each shard count runs in its own
    subprocess pinned to exactly that many physical cores, so adding a
    shard adds a core (the CPU analog of adding a chip)."""
    counts = [s for s in (1, 2, 4, 8) if s <= max_cores]
    out = {"pf": {}, "pf_nocollective": {}, "chains": {}, "cores": {}}
    here = os.path.abspath(__file__)
    for s in counts:
        cpus = "0-%d" % (s - 1) if s > 1 else "0"
        env = dict(os.environ)
        # one single-threaded core per device: multi-threaded Eigen on
        # shared cores measures cache-line bouncing, not scaling (a pinned
        # 1-core run beats an unpinned 4-core run 4x on this workload)
        env["XLA_FLAGS"] = (
            f"--xla_force_host_platform_device_count={s} "
            "--xla_cpu_multi_thread_eigen=false"
        )
        env["SCALING_CPU"] = "1"
        # compute-dominated per-shard sizes: at the tiny defaults the
        # window is dispatch-bound and scaling is unmeasurable
        env.setdefault("SCALING_PARTICLES", "32768")
        env.setdefault("SCALING_T", "128")
        env.setdefault("SCALING_CHAINS", "8192")
        env.setdefault("SCALING_STEPS", "256")
        env.setdefault("SCALING_TRIALS", "5")
        env.pop("SCALING_PROPORTIONAL", None)
        proc = subprocess.run(
            ["taskset", "-c", cpus, sys.executable, here, "--single", str(s)],
            env=env,
            capture_output=True,
            text=True,
            check=False,
        )
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            raise RuntimeError(f"--single {s} subprocess failed")
        line = proc.stdout.strip().splitlines()[-1]
        rates = json.loads(line)
        out["pf"][s] = rates["pf"]
        out["pf_nocollective"][s] = rates["pf_nocollective"]
        out["chains"][s] = rates["chains"]
        out["cores"][s] = s
        print(
            f"[proportional] shards={s} on {s} core(s): "
            f"PF {rates['pf']/1e6:.2f}M "
            f"(no-collective {rates['pf_nocollective']/1e6:.2f}M), "
            f"chains {rates['chains']/1e6:.2f}M",
            file=sys.stderr,
        )
    for name in ("pf", "pf_nocollective", "chains"):
        base = out[name][counts[0]]
        for s in counts[1:]:
            out.setdefault("efficiency", {}).setdefault(s, {})[name] = (
                out[name][s] / (base * s)
            )
    # the share of weak-scaling loss attributable to cross-shard
    # communication: 1 - eff(full)/eff(collective-free). Whatever loss the
    # collective-free program also pays is host/runtime contention, not
    # communication.
    for s in counts[1:]:
        e = out["efficiency"][s]
        e["collective_overhead_share"] = max(
            0.0, 1.0 - e["pf"] / e["pf_nocollective"]
        )
    return out


def main():
    if "--single" in sys.argv:
        s = int(sys.argv[sys.argv.index("--single") + 1])
        assert len(jax.devices()) == s, (len(jax.devices()), s)
        from scaling_profile import pf_collective_free

        pf_rate = bench_pf(s, n_particles=PARTICLES * s, T=PF_T)
        nc_rate = pf_collective_free(s, n_particles=PARTICLES * s, T=PF_T)
        ch_rate = bench_chains(s, n_chains=CHAINS * s, n_steps=CHAIN_STEPS)
        print(
            json.dumps(
                {"pf": pf_rate, "pf_nocollective": nc_rate, "chains": ch_rate}
            )
        )
        return

    results = {"device": jax.devices()[0].device_kind}

    if os.environ.get("SCALING_PROPORTIONAL"):
        ncores = os.cpu_count() or 1
        results["core_proportional"] = run_proportional(ncores)
        results["core_proportional"]["methodology"] = (
            "each shard count s runs in a fresh subprocess pinned to s "
            "physical cores (taskset); adding a shard adds a core, the CPU "
            "analog of adding a chip per host. Efficiency here is the "
            "honest CPU proxy for the >=90% weak-scaling north star."
        )
    else:
        n_dev = len(jax.devices())
        shard_counts = [s for s in (1, 2, 4, 8, 16) if s <= n_dev]
        results.update(run_timeslice(shard_counts))

    print(json.dumps(results, indent=2, default=float))


if __name__ == "__main__":
    main()
