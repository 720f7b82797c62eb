"""JAX basics for probabilistic programmers.

Counterpart of the reference's fifth active cookbook
(`/root/reference/docs/cookbook/active/jax_basics.ipynb`): the JAX
mental model a `genjax_tpu` user needs — written as executable
assertions. Each section states the rule, then proves it.
"""

import jax
import jax.numpy as jnp
import jax.random as jr

import genjax_tpu as g


# ----------------------------------------------------------------------
# 1. jit traces your Python ONCE, then replays compiled XLA.
#    Python side effects happen at trace time only.
# ----------------------------------------------------------------------
def tracing_not_running():
    calls = []

    @jax.jit
    def f(x):
        calls.append("traced")  # side effect: trace-time only
        return x * 2.0

    f(jnp.ones(3))
    f(jnp.ones(3) + 1)
    f(jnp.ones(3) + 2)
    assert calls == ["traced"], calls  # one trace, three executions
    # a NEW SHAPE means a new trace/compile — keep shapes static
    f(jnp.ones(5))
    assert calls == ["traced", "traced"]


# ----------------------------------------------------------------------
# 2. Explicit, splittable PRNG keys: no global RNG state. Reusing a key
#    reproduces the draw; split for independence. @gen models follow the
#    same discipline (each address gets a folded sub-key).
# ----------------------------------------------------------------------
def key_discipline():
    key = jr.key(0)
    assert jnp.array_equal(jr.normal(key, (3,)), jr.normal(key, (3,)))
    k1, k2 = jr.split(key)
    assert not jnp.array_equal(jr.normal(k1, (3,)), jr.normal(k2, (3,)))

    @g.gen
    def model():
        a = g.normal(0.0, 1.0) @ "a"
        b = g.normal(0.0, 1.0) @ "b"
        return a, b

    tr = model.simulate(jr.key(1), ())
    a, b = tr.get_retval()
    assert float(a) != float(b)  # distinct per-address sub-keys
    tr2 = model.simulate(jr.key(1), ())
    assert float(tr2.get_score()) == float(tr.get_score())  # same key


# ----------------------------------------------------------------------
# 3. vmap: write the single-sample program, batch it mechanically.
#    This is the whole parallelism story of the reference, and the
#    per-device half of this framework's (meshes shard the vmapped axis).
# ----------------------------------------------------------------------
def vmap_is_the_batch_story():
    @g.gen
    def flip_model():
        p = g.beta(2.0, 2.0) @ "p"
        _ = g.flip(p) @ "v"

    obs = g.C["v"].set(True)
    ks = jr.split(jr.key(2), 1000)
    _trs, ws = jax.vmap(lambda k: flip_model.generate(k, obs, ()))(ks)
    assert ws.shape == (1000,)
    # E[p] = 1/2 under the prior, and P(v=True | p) = p, so the average
    # importance weight estimates log E[p] = log 0.5
    lz = jax.scipy.special.logsumexp(ws) - jnp.log(1000.0)
    assert abs(float(lz) - jnp.log(0.5)) < 0.05


# ----------------------------------------------------------------------
# 4. No data-dependent Python control flow under jit: use lax.cond /
#    lax.scan (or the framework's Switch / Scan combinators, which
#    compile to them).
# ----------------------------------------------------------------------
def structured_control_flow():
    @jax.jit
    def bad_style(x):
        # `if x > 0:` here would raise a TracerBoolConversionError;
        # the compiled program must contain BOTH branches:
        return jax.lax.cond(x > 0, lambda: x, lambda: -x)

    assert float(bad_style(-3.0)) == 3.0

    # the Scan combinator is lax.scan with GFI semantics
    @g.gen
    def step(carry, _):
        nxt = g.normal(0.9 * carry, 0.1) @ "x"
        return nxt, None

    chain = step.scan(n=50)
    tr = chain.simulate(jr.key(3), (1.0, None))
    xs = tr.get_choices()[:, "x"]
    xs = xs.unmask() if hasattr(xs, "unmask") else xs
    assert xs.shape == (50,)


# ----------------------------------------------------------------------
# 5. Everything is a pytree of arrays — traces included. tree_map is how
#    you post-process draws; static structure rides in the treedef (this
#    is why checkpointing and sharding are "free": leaves are arrays).
# ----------------------------------------------------------------------
def traces_are_pytrees():
    @g.gen
    def model():
        mu = g.normal(0.0, 1.0) @ "mu"
        _ = g.normal(mu, 1.0) @ "y"

    trs = jax.vmap(lambda k: model.simulate(k, ()))(jr.split(jr.key(4), 8))
    halved = jax.tree_util.tree_map(lambda leaf: leaf * 0.5, trs)
    assert jnp.allclose(
        halved.get_choices()["mu"], trs.get_choices()["mu"] * 0.5
    )
    # static values cross jit boundaries via Const, not as traced arrays
    c = g.Pytree.const(3)
    assert jax.tree_util.tree_leaves(c) == []  # rides the treedef


# ----------------------------------------------------------------------
# 6. float32 is the default; a GPU may run f32 matmuls in TF32 at default
#    precision. Work in f32 and ask for "highest" where it matters.
# ----------------------------------------------------------------------
def dtype_reality():
    x = jnp.ones(3)
    assert x.dtype == jnp.float32
    # Python floats are weakly typed: they do not silently upcast
    assert (x * 2.0).dtype == jnp.float32


def main():
    tracing_not_running()
    key_discipline()
    vmap_is_the_batch_story()
    structured_control_flow()
    traces_are_pytrees()
    dtype_reality()
    print("jax basics cookbook: all sections verified")


if __name__ == "__main__":
    main()
