"""Multi-slice SMC: the island particle filter on a 2-level mesh.

A multi-host cluster has two interconnects: ICI inside a slice (collectives every
scan step are fine) and DCN across slices (orders slower — traffic must
be rare and scheduled). The island particle model (Vergé et al. 2015)
maps onto that split: the population divides into islands, one per
slice; within an island, every-step weight statistics and adaptive
resampling ride ICI; islands interact only at scheduled exchange points
— a systematic resample of whole islands by their scalar island weights.

This narrative runs the same program on the visible devices (CI forces
an 8-device CPU mesh → a 2x4 island x batch grid), checks the logZ
estimate against the exact Kalman answer, and prints the audited
per-step collective footprint — the claim "nothing in the hot loop
spans islands" is read off the compiled HLO, not asserted in prose.
"""

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np

import genjax_tpu as g
from genjax_tpu.parallel import (
    IslandParticleFilter,
    hlo_collectives,
    make_hier_mesh,
)
from genjax_tpu.parallel.islands import _island_run_sharded


@g.gen
def ssm_kernel(c, x):
    z = g.normal(c, 1.0) @ "z"
    y = g.normal(z, 0.5) @ "y"
    return (z, y)


def exact_lgss_logZ(ys, trans_sd=1.0, obs_sd=0.5):
    q, r = trans_sd**2, obs_sd**2
    mean, var = 0.0, q
    logZ = 0.0
    for y in ys:
        s = var + r
        logZ += -0.5 * (np.log(2 * np.pi * s) + (y - mean) ** 2 / s)
        kgain = var / s
        mean = mean + kgain * (y - mean)
        var = var * (1 - kgain) + q
    return float(logZ)


def main():
    n_dev = len(jax.devices())
    n_islands = 2 if n_dev % 2 == 0 and n_dev > 1 else 1
    mesh = make_hier_mesh(n_islands, n_dev // n_islands)
    print(f"hierarchical mesh: {dict(mesh.shape)}")

    T = 16
    ys = np.asarray(
        jax.random.normal(jr.key(3), (T,)) * 0.8, dtype=np.float32
    )
    obs = g.C[:, "y"].set(jnp.asarray(ys))
    exact = exact_lgss_logZ(ys)

    ipf = IslandParticleFilter(
        ssm_kernel, n_particles=4096, exchange_every=4
    )
    res = ipf.run_sharded(jr.key(0), 0.0, jnp.zeros(T), obs, mesh)
    print(
        f"island PF logZ = {float(res.log_marginal):.3f} "
        f"(Kalman exact {exact:.3f}), "
        f"{int(res.n_exchanges)} island exchanges over {T} steps"
    )
    assert abs(float(res.log_marginal) - exact) < 0.15
    assert int(res.n_exchanges) == T // 4

    # ---- the communication receipt, from the compiled HLO -------------
    lowered = _island_run_sharded.lower(
        ipf, jr.key(0), 0.0, jnp.zeros(T), obs,
        mesh=mesh, island_axis="island", particle_axis="batch", n_steps=None,
    )
    audit = hlo_collectives(lowered.compile().as_text())
    hot = [
        o for o in audit["ops"]
        if o["per_step"] and o["kind"] == "all-reduce"
    ]
    n_shards = mesh.shape["batch"]
    print(
        f"per-step all-reduces: {len(hot)}, "
        f"max replica-group span {max((o['group_span'] or 0) for o in hot)} "
        f"(within-island axis = {n_shards} devices), "
        f"payload {sum(o['bytes'] for o in hot)} bytes"
    )
    for o in hot:
        assert o["group_span"] is None or o["group_span"] <= max(
            n_shards, n_islands
        ), o


if __name__ == "__main__":
    main()
