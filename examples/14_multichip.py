"""The multi-chip story: one mesh, sharded particles and chains.

The BASELINE.json north star — chains/particles sharded over devices with XLA
collectives — as a runnable narrative. On real hardware this runs
unchanged across a pod slice; here it exercises the same programs on
however many devices are visible (CI forces an 8-device CPU mesh).
"""

import jax
import jax.numpy as jnp
import jax.random as jr

import genjax_tpu as g
from genjax_tpu.inference import sample_posterior
from genjax_tpu.parallel import (
    SSMParticleFilter,
    make_mesh,
    run_chains_sharded,
    shard_batch,
)


@g.gen
def ssm_kernel(c, x):
    z = g.normal(c, 1.0) @ "z"
    y = g.normal(z, 0.5) @ "y"
    return (z, y)


def main():
    mesh = make_mesh()  # 1-D mesh over all local devices, axis "batch"
    n_dev = len(jax.devices())
    print(f"mesh over {n_dev} device(s): {mesh}")

    # --- sharded particle filter: collectives inside one shard_map -----
    T = 12
    ys = jnp.sin(jnp.linspace(0, 2, T))
    pf = SSMParticleFilter(ssm_kernel, n_particles=1024 * n_dev)
    for mode in ("local", "all_gather"):
        res = pf.run_sharded(
            jr.key(0), 0.0, jnp.zeros(T), g.C[:, "y"].set(ys), mesh,
            resample_mode=mode,
        )
        assert jnp.isfinite(res.log_marginal)
        # the particle axis really is sharded across every device
        assert len(res.carries.sharding.device_set) == n_dev
        print(f"  PF [{mode:10s}] logZ = {float(res.log_marginal):.3f}")

    # --- sharded chain batch: XLA partitions the vmapped program -------
    @g.gen
    def conjugate():
        mu = g.normal(0.0, 1.0) @ "mu"
        _ = g.normal(mu, 1.0) @ "y"

    obs = g.C["y"].set(2.0)
    res = run_chains_sharded(
        jr.key(1),
        lambda k: conjugate.generate(k, obs, ())[0],
        g.HMC(g.S["mu"], 0.3, L=10),
        n_steps=50,
        n_chains=128 * n_dev,
        mesh=mesh,
        record=lambda t: t.get_choices()["mu"],
    )
    finals = res.history[:, -1]
    assert abs(float(jnp.mean(finals)) - 1.0) < 0.15
    print(f"  chains: posterior mean {float(jnp.mean(finals)):.3f} (exact 1.0)")

    # --- the one-call driver shards the same way -----------------------
    post = sample_posterior(
        jr.key(2), conjugate, obs, (), g.S["mu"],
        n_chains=128 * n_dev, n_warmup=40, n_samples=30,
        algorithm="hmc", eps0=0.1, L=5, mesh=mesh,
    )
    assert abs(float(jnp.mean(post["mu"][:, -10:])) - 1.0) < 0.15

    # --- shard any framework pytree with one call ----------------------
    batch = jax.vmap(lambda k: conjugate.simulate(k, ()))(
        jr.split(jr.key(3), 64 * n_dev)
    )
    placed = shard_batch(batch, mesh)
    leaf = jax.tree_util.tree_leaves(placed)[0]
    assert len(leaf.sharding.device_set) == n_dev

    print("multi-chip cookbook: all sections OK")


if __name__ == "__main__":
    main()
