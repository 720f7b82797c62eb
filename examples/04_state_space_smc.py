"""State-space particle filtering — single chip and sharded.

The BASELINE.json north-star workload: particles shard over a device mesh;
ESS, normalizers, and resampling are XLA collectives.
(Run with XLA_FLAGS=--xla_force_host_platform_device_count=8 on CPU to see
multi-device execution.)
"""

import jax
import jax.numpy as jnp

import genjax_tpu as g
from genjax_tpu.parallel import SSMParticleFilter, make_mesh


@g.gen
def kernel(carry, x):
    """Latent random walk with noisy observations."""
    z = g.normal(carry, 1.0) @ "z"
    y = g.normal(z, 0.5) @ "y"
    return (z, y)


def main():
    key = jax.random.key(0)
    T = 50
    # synthesize observations from the scanned model itself
    ssm = kernel.scan()
    true_tr = ssm.simulate(key, (0.0, jnp.zeros(T)))
    ys = jnp.asarray([true_tr.get_choices()[t, "y"] for t in range(T)])

    obs = g.C[:, "y"].set(ys)
    pf = SSMParticleFilter(kernel, n_particles=4096, ess_threshold=0.5)

    # single device
    res = pf.run(key, 0.0, jnp.zeros(T), obs)
    print(f"logZ estimate: {res.log_marginal:.2f}")
    print(f"final-step ESS: {res.ess_history[-1]:.0f} / 4096")

    # sharded over all available devices
    mesh = make_mesh()
    res_sharded = pf.run_sharded(key, 0.0, jnp.zeros(T), obs, mesh)
    print(
        f"sharded logZ estimate: {res_sharded.log_marginal:.2f} "
        f"({len(jax.devices())} devices)"
    )


if __name__ == "__main__":
    main()
