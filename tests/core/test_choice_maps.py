"""ChoiceMap algebra tests (reference: tests/core/test_choice_maps.py,
1202 LoC incl. hypothesis property tests)."""

import jax
import jax.numpy as jnp
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from genjax_tpu import C, ChoiceMap, Mask, S, Selection
from genjax_tpu.generative.choice_map import ChoiceMapNoValueAtAddress


class TestBuilders:
    def test_empty(self):
        chm = ChoiceMap.empty()
        assert chm.static_is_empty()
        assert chm.get_value() is None

    def test_choice(self):
        chm = ChoiceMap.choice(5.0)
        assert chm.get_value() == 5.0
        assert chm.has_value()

    def test_entry_and_builder(self):
        chm = C["x"].set(5.0)
        assert chm["x"] == 5.0
        chm = C["x", "y"].set(3.0)
        assert chm["x", "y"] == 3.0
        assert chm("x")("y").get_value() == 3.0

    def test_kw_and_d(self):
        chm = ChoiceMap.kw(x=1.0, y=2.0)
        assert chm["x"] == 1.0 and chm["y"] == 2.0
        chm = ChoiceMap.d({"a": 1.0, ("b", "c"): 2.0})
        assert chm["a"] == 1.0
        assert chm["b", "c"] == 2.0

    def test_from_mapping(self):
        chm = ChoiceMap.from_mapping([("x", 1.0), (("y", "z"), 2.0)])
        assert chm["x"] == 1.0
        assert chm[("y", "z")] == 2.0

    def test_missing_raises(self):
        chm = C["x"].set(1.0)
        with pytest.raises(ChoiceMapNoValueAtAddress):
            chm["nope"]

    def test_contains(self):
        chm = C["x"].set(1.0)
        assert "x" in chm
        assert "y" not in chm

    def test_at_layering(self):
        chm = C["x"].set(1.0)
        chm2 = chm.at["y"].set(2.0)
        assert chm2["x"] == 1.0 and chm2["y"] == 2.0
        # priority: new entry wins
        chm3 = chm.at["x"].set(9.0)
        assert chm3["x"] == 9.0


class TestOr:
    def test_priority(self):
        a = ChoiceMap.choice(5.0)
        b = ChoiceMap.choice(10.0)
        assert (a | b).get_value() == 5.0
        assert (ChoiceMap.empty() | b).get_value() == 10.0

    def test_static_merge(self):
        m = C["x"].set(1.0) | C["y"].set(2.0)
        assert m["x"] == 1.0 and m["y"] == 2.0

    def test_nested_merge(self):
        m = C["a", "x"].set(1.0) | C["a", "y"].set(2.0)
        assert m["a", "x"] == 1.0 and m["a", "y"] == 2.0


class TestIndexed:
    def test_scalar_concrete(self):
        chm = C[3].set(7.0)
        assert chm[3] == 7.0
        sub = chm.get_submap(2)
        assert sub.get_value() is None

    def test_scalar_traced_query(self):
        chm = C[3].set(7.0)

        def lookup(j):
            v = chm.get_submap(j).get_value()
            return v.unmask(default=jnp.array(-1.0)), v.primal_flag()

        v, flag = jax.jit(lookup)(jnp.asarray(3))
        assert v == 7.0 and flag
        v, flag = jax.jit(lookup)(jnp.asarray(2))
        assert v == -1.0 and not flag

    def test_sparse_array_idx(self):
        chm = C[jnp.array([2, 5])].set(jnp.array([10.0, 20.0]))
        v = chm.get_submap(5).get_value()
        assert isinstance(v, Mask)
        assert v.unmask() == 20.0
        assert v.primal_flag()
        v = chm.get_submap(3).get_value()
        assert not v.primal_flag()

    def test_dense_from_extend(self):
        # dense layout: leading axis on leaves, idx None
        from genjax_tpu.generative.choice_map import IndexedChm, ValueChm

        inner = ValueChm(jnp.arange(4.0))
        chm = IndexedChm.build(inner, None)
        assert chm.get_submap(2).get_value() == 2.0
        out = chm.get_submap(jnp.asarray(3)).get_value()
        assert out.unmask() == 3.0
        # out of range masked
        out = chm.get_submap(jnp.asarray(9)).get_value()
        assert not out.primal_flag()

    def test_nested_path(self):
        chm = C["steps", 2, "x"].set(4.0)
        assert chm["steps", 2, "x"] == 4.0


class TestFilterMask:
    def test_filter_all_none(self):
        chm = C["x"].set(1.0)
        assert chm.filter(Selection.all()) is chm
        assert chm.filter(Selection.none()).static_is_empty()

    def test_filter_static(self):
        chm = C["x"].set(1.0) | C["y"].set(2.0)
        f = chm.filter(S["x"])
        assert f["x"] == 1.0
        assert f.get_submap("y").get_value() is None

    def test_filter_complement(self):
        chm = C["x"].set(1.0) | C["y"].set(2.0)
        f = chm.filter(~S["x"])
        assert f.get_submap("x").get_value() is None
        assert f["y"] == 2.0

    def test_mask_flag(self):
        chm = C["x"].set(1.0)
        m = chm.mask(jnp.asarray(False))
        v = m.get_submap("x").get_value()
        assert isinstance(v, Mask)
        assert not v.primal_flag()
        assert chm.mask(True) is chm
        assert chm.mask(False).static_is_empty()

    def test_and_filter(self):
        a = C["x"].set(1.0)
        b = C["x"].set(9.0) | C["y"].set(2.0)
        both = a & b
        assert both["x"] == 9.0  # b filtered by a's selection
        assert both.get_submap("y").get_value() is None


class TestSwitch:
    def test_switch_concrete(self):
        chms = [C["x"].set(1.0), C["y"].set(2.0)]
        chm = ChoiceMap.switch(1, chms)
        assert chm["y"] == 2.0

    def test_switch_traced(self):
        chms = [C["x"].set(1.0), C["y"].set(2.0)]
        chm = ChoiceMap.switch(jnp.asarray(1), chms)
        v = chm.get_submap("y").get_value()
        assert v.unmask() == 2.0
        assert v.primal_flag()
        v = chm.get_submap("x").get_value()
        assert not v.primal_flag()


class TestSelection:
    def test_all_none_leaf(self):
        assert Selection.all().check() is True
        assert Selection.none().check() is False
        s = Selection.leaf().extend("x")
        assert s["x"]
        assert not s["x", "y"]

    def test_builder(self):
        s = S["x"]
        assert s["x"]
        assert s["x", "deep"]  # whole subtree
        assert not s["y"]

    def test_combinators(self):
        s = S["x"] | S["y"]
        assert s["x"] and s["y"] and not s["z"]
        s = S["x"] & S["x", "a"]
        assert s["x", "a"] and not s["x", "b"]
        s = ~S["x"]
        assert not s["x"] and s["y"]

    def test_wildcard(self):
        s = S["a", ..., "b"]
        assert s["a", "anything", "b"]
        assert not s["a", "anything", "c"]

    def test_chm_selection(self):
        chm = C["x"].set(1.0) | C["y", "z"].set(2.0)
        sel = chm.get_selection()
        assert sel["x"]
        assert sel["y", "z"]
        assert not sel["w"]


@settings(deadline=None, max_examples=50)
@given(
    vals=st.dictionaries(
        st.sampled_from(["a", "b", "c", "d"]),
        st.floats(-10, 10, allow_nan=False),
        min_size=1,
    )
)
def test_property_kw_roundtrip(vals):
    chm = ChoiceMap.d(vals)
    for k, v in vals.items():
        assert chm[k] == pytest.approx(v)


@settings(deadline=None, max_examples=50)
@given(
    left=st.dictionaries(st.sampled_from(["a", "b"]), st.floats(-1, 1, allow_nan=False)),
    right=st.dictionaries(st.sampled_from(["a", "b", "c"]), st.floats(-1, 1, allow_nan=False)),
)
def test_property_or_priority(left, right):
    chm = ChoiceMap.d(left) | ChoiceMap.d(right)
    for k in set(left) | set(right):
        expected = left.get(k, right.get(k))
        assert chm[k] == pytest.approx(expected)


def test_indexed_numpy_leaf_traced_index():
    """Dense indexed constraints built from host-numpy arrays (the
    recommended carrier for model constants) must support traced-index
    lookup — numpy leaves cannot be indexed by a tracer directly, so
    _slice_leaves converts them (regression: verify-drive find)."""
    import numpy as np

    ys = np.arange(8.0, dtype=np.float32)
    chm = C[:, "y"].set(ys)

    @jax.jit
    def read(i):
        v = chm.get_submap(i, "y").get_value()
        return v.value if isinstance(v, Mask) else v

    assert read(3) == 3.0
    assert read(7) == 7.0


class TestFilterEagerIndexed:
    """filter_eager / _invalid_extras must resolve index-DEPENDENT
    selections per slice, not apply index 0's verdict everywhere."""

    def test_dense_index_specific_selection(self):
        from genjax_tpu import S

        ys = jnp.arange(5.0)
        chm = C[:, "y"].set(ys)
        kept = chm.filter_eager(S[3, "y"])
        # index 3 survives with its value ...
        v = kept.get_submap(3, "y").get_value()
        v = v.value if isinstance(v, Mask) else v
        assert float(jnp.asarray(v).reshape(())) == 3.0
        # ... and index 0 (previously the lone representative) is gone
        assert kept.get_submap(0, "y").get_value() is None
        assert not kept.static_is_empty()

    def test_dense_wildcard_stays_dense(self):
        from genjax_tpu import S

        ys = jnp.arange(5.0)
        chm = C[:, "y"].set(ys)
        kept = chm.filter_eager(S[..., "y"])
        for j in range(5):
            v = kept.get_submap(j, "y").get_value()
            v = v.value if isinstance(v, Mask) else v
            assert float(jnp.asarray(v).reshape(())) == float(j)

    def test_sparse_index_respects_stored_index(self):
        from genjax_tpu import S
        from genjax_tpu.generative.choice_map import IndexedChm, ValueChm

        # value stored at index 7 (sparse); selecting index 7 keeps it,
        # selecting index 0 does not
        chm = IndexedChm.build(
            ValueChm(jnp.asarray([42.0])), jnp.asarray([7])
        )
        kept7 = chm.filter_eager(S[7])
        assert not kept7.static_is_empty()
        v = kept7.get_submap(7).get_value()
        assert float(v.value if isinstance(v, Mask) else v) == 42.0

    def test_invalid_subset_still_catches_typos(self):
        import genjax_tpu as g

        @g.gen
        def kern(c, x):
            z = g.normal(c, 1.0) @ "z"
            _ = g.normal(z, 0.5) @ "y"
            return (z, None)

        model = kern.scan(n=4)
        ok = C[:, "y"].set(jnp.zeros(4))
        bad = C[:, "typo"].set(jnp.zeros(4))
        args = (0.0, jnp.zeros(4))
        assert ok.invalid_subset(model, args) is None
        assert bad.invalid_subset(model, args) is not None


class TestNegativeDynamicIndex:
    def test_traced_negative_matches_eager(self):
        ys = jnp.arange(6.0)
        chm = C[:, "y"].set(ys)
        eager = chm.get_submap(-1, "y").get_value()
        eager = eager.value if isinstance(eager, Mask) else eager

        @jax.jit
        def read(i):
            v = chm.get_submap(i, "y").get_value()
            return (v.value, v.flag) if isinstance(v, Mask) else (v, True)

        traced_v, traced_flag = read(-1)
        assert bool(traced_flag)
        assert float(traced_v) == float(eager) == 5.0
