"""The port's ownership and exchange building blocks against the JAX package.

Each function runs in-process, without a mesh, in both packages on the same
numpy inputs: ``build_ownership`` (overrides included), the value
permutations, ``bucket_by_owner`` (against both JAX backbones,
``counting=True`` and ``False``, which agree bit for bit), an overflowing
bucket, ``route_gather`` / ``unroute_gather``, ``exchange_capacity``, and
``build_probe_route`` + ``owners_of``.  Every result is bitwise equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import ALL_APPS as J_APPS
from repro.core import ownership as J

from repro_torch.convert import probe_table_from_halves
from repro_torch.core import ownership as T

from torch_parity import np_, port_store


def _ownership_pair(app_name, n_owners, overrides):
    jstore = J_APPS[app_name].make_store()
    return (J.build_ownership(jstore, n_owners, overrides),
            T.build_ownership(port_store(jstore), n_owners, overrides),
            jstore)


OWN_CASES = [("gs", 1, ()), ("gs", 8, ()), ("gs", 3, ()),
             ("gs", 4, ((0, 1), (1, 0), (17, 3), (19, 1))),
             ("tp", 2, ()), ("tp", 8, ()), ("tp", 4, ((5, 0), (0, 1)))]


@pytest.mark.parametrize("app_name,n_owners,overrides", OWN_CASES)
def test_build_ownership_matches_reference(app_name, n_owners, overrides):
    jo, to, _ = _ownership_pair(app_name, n_owners, overrides)
    assert (to.n_owners, to.per, to.s_pad, to.overrides) == (
        jo.n_owners, jo.per, jo.s_pad, jo.overrides)
    assert to.fwd.dtype == torch.int32
    np.testing.assert_array_equal(np_(to.fwd), np.asarray(jo.fwd))
    if jo.slot_is_max is None:
        assert to.slot_is_max is None
    else:
        np.testing.assert_array_equal(np_(to.slot_is_max),
                                      np.asarray(jo.slot_is_max))
    np.testing.assert_array_equal(
        T.owner_of_uids(100, n_owners, overrides),
        J.owner_of_uids(100, n_owners, overrides))


def test_build_ownership_rejects_an_overfull_bin():
    store = port_store(J_APPS["gs"].make_store())
    with pytest.raises(ValueError, match="bin overflow"):
        T.build_ownership(store, 4, ((1, 0),))


@pytest.mark.parametrize("app_name,n_owners,overrides", OWN_CASES[2:5])
def test_permute_values_matches_reference(app_name, n_owners, overrides):
    jo, to, jstore = _ownership_pair(app_name, n_owners, overrides)
    rng = np.random.default_rng(3)
    vals = rng.normal(size=np.asarray(jstore.values).shape).astype(np.float32)
    jp = J.permute_values(jo, jnp.asarray(vals))
    tp = T.permute_values(to, torch.from_numpy(vals))
    np.testing.assert_array_equal(np_(tp), np.asarray(jp))
    np.testing.assert_array_equal(
        np_(T.unpermute_values(to, tp)),
        np.asarray(J.unpermute_values(jo, jp)))
    back = T.unpermute_values(to, tp)
    np.testing.assert_array_equal(np_(back)[:-1], vals[:-1])


def test_make_local_store_fields():
    vals = torch.zeros((6, 2))
    st = T.make_local_store(vals)
    assert (st.table_base, st.table_capacity, st.table_is_max) == (
        (0,), (5,), (False,))
    stacked = T.make_local_store(torch.zeros((3, 6, 2)),
                                 torch.zeros((3, 6), dtype=torch.bool))
    assert (stacked.table_capacity, stacked.table_is_max) == ((5,), (True,))
    assert stacked.pad_uid == 5


def _dst(n, n_route, seed, skew=False):
    rng = np.random.default_rng(seed)
    if skew:   # most rows to bucket 0
        d = np.where(rng.random(n) < 0.7, 0, rng.integers(0, n_route, n))
    else:
        d = rng.integers(0, n_route, n)
    pad = rng.random(n) < 0.15
    return np.where(pad, n_route, d).astype(np.int32)


PLAN_FIELDS = ("take", "ok", "rank", "dst", "dropped", "fill")
BUCKET_CASES = [(200, 8, 40, False), (200, 8, 25, False), (97, 3, 50, False),
                (200, 8, 10, True), (64, 1, 64, False), (300, 16, 4, True)]


@pytest.mark.parametrize("counting", [True, False])
@pytest.mark.parametrize("n,n_route,cap,skew", BUCKET_CASES)
def test_bucket_by_owner_matches_reference(n, n_route, cap, skew, counting):
    """One row, and a batch of rows against the reference vmapped."""
    batch = np.stack([_dst(n, n_route, s, skew) for s in range(3)])
    jplans = jax.vmap(lambda d: J.bucket_by_owner(d, n_route, cap,
                                                  counting=counting))(
        jnp.asarray(batch))
    tplans = T.bucket_by_owner(torch.from_numpy(batch), n_route, cap)
    one = T.bucket_by_owner(torch.from_numpy(batch[1]), n_route, cap)
    for f in PLAN_FIELDS:
        want = np.asarray(getattr(jplans, f))
        got = np_(getattr(tplans, f))
        assert got.dtype == want.dtype, (f, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=f)
        np.testing.assert_array_equal(np_(getattr(one, f)), want[1],
                                      err_msg=f"{f} (one row)")


def test_bucket_overflow_is_counted():
    d = _dst(200, 8, 0, skew=True)
    plan = T.bucket_by_owner(torch.from_numpy(d), 8, 10)
    real = np.bincount(d, minlength=9)[:8]
    assert int(plan.dropped) == int(np.maximum(real - 10, 0).sum()) > 0
    assert int(plan.fill) == real.max() > 10
    assert int(plan.ok.sum()) == int(np.minimum(real, 10).sum())


@pytest.mark.parametrize("n,n_route,cap,skew", BUCKET_CASES[:4])
def test_route_and_unroute_gather_match_reference(n, n_route, cap, skew):
    rng = np.random.default_rng(n + cap)
    d = _dst(n, n_route, 5, skew)
    fields = dict(i=rng.integers(-5, 500, n).astype(np.int32),
                  f=rng.normal(size=(n, 3)).astype(np.float32),
                  b=rng.random(n) < 0.5)
    jplan = J.bucket_by_owner(jnp.asarray(d), n_route, cap)
    tplan = T.bucket_by_owner(torch.from_numpy(d), n_route, cap)
    for name, x in fields.items():
        pad = {"i": 7, "f": 0.5, "b": False}[name]
        jr = J.route_gather(jplan, jnp.asarray(x), pad)
        tr = T.route_gather(tplan, torch.from_numpy(x), pad)
        assert np_(tr).dtype == np.asarray(jr).dtype
        np.testing.assert_array_equal(np_(tr), np.asarray(jr), err_msg=name)
        flat_j = jnp.asarray(jr).reshape((n_route * cap,) + x.shape[1:])
        flat_t = tr.reshape((n_route * cap,) + x.shape[1:])
        np.testing.assert_array_equal(
            np_(T.unroute_gather(tplan, flat_t, n_route, cap, pad)),
            np.asarray(J.unroute_gather(jplan, flat_j, n_route, cap, pad)),
            err_msg=f"unroute {name}")


@pytest.mark.parametrize("n_ops,n_route,slack", [
    (1250, 4, 2.0), (1250, 4, 8.0), (500, 2, 2.0), (40, 8, 1.0),
    (320, 8, 8.0), (7, 3, 0.5), (1, 8, 2.0), (1000, 7, 1.3)])
def test_exchange_capacity_matches_reference(n_ops, n_route, slack):
    assert T.exchange_capacity(n_ops, n_route, slack) == \
        J.exchange_capacity(n_ops, n_route, slack)


@pytest.mark.parametrize("n_uids,n_owners,layout", [
    (10_000, 8, "striped"), (200, 2, "striped"), (200, 8, "everything"),
    (777, 3, "striped")])
def test_probe_route_matches_reference(n_uids, n_owners, layout):
    if layout == "everything":
        owner = np.arange(n_uids) % n_owners
    else:
        per = -(-n_uids // n_owners)
        fwd = (np.arange(n_uids) % n_owners) * per + np.arange(n_uids) // \
            n_owners
        owner = fwd // per
    jr = J.build_probe_route(n_uids, owner, miss_owner=n_owners)
    tr = T.build_probe_route(n_uids, owner, miss_owner=n_owners,
                             device="cpu")
    np.testing.assert_array_equal(
        np_(tr.table), probe_table_from_halves(np.asarray(jr.table_lo),
                                               np.asarray(jr.table_hi)))
    np.testing.assert_array_equal(np_(tr.slot_owner),
                                  np.asarray(jr.slot_owner))
    rng = np.random.default_rng(n_uids)
    uid = np.concatenate([rng.integers(0, n_uids, 500),
                          [n_uids, n_uids + 5, 0, n_uids - 1]]).astype(
        np.int32)
    got = tr.owners_of(torch.from_numpy(uid))
    np.testing.assert_array_equal(np_(got),
                                  np.asarray(jr.owners_of(jnp.asarray(uid))))
    np.testing.assert_array_equal(np_(got)[:500], owner[uid[:500]])
    assert np.all(np_(got)[500:502] == n_owners)    # absent -> miss owner
