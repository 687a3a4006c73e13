"""The port's vector store against the JAX package's on the CPU: the JAX
package's own store cases (tests/test_stores.py) run on both stores and
must give the same answers (similarities within 1e-5), plus ties (the
lowest row first, as jax.lax.top_k orders them), a larger seeded store,
and the /stores/* routes of both servers (the same statuses and bodies)."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from localai_tpu.stores import StoreRegistry as JaxRegistry
from localai_tpu.stores import VectorStore as JaxStore
from localai_tpu_torch.stores import StoreRegistry, VectorStore

ATOL = 1e-5


def _both():
    return JaxStore(), VectorStore(device="cpu")


def _same_find(stores, q, k):
    """find() on both stores: the same keys, values and order; similarities
    within ATOL. Returns the port's answer."""
    (jk, jv, js), (tk, tv, ts) = (s.find(np.asarray(q, np.float32), k) for s in stores)
    assert tv == jv
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_allclose(ts, js, atol=ATOL, rtol=0)
    return tk, tv, ts


def test_set_get_delete():
    for s in _both():
        keys = np.eye(3, dtype=np.float32)
        s.set(keys, [b"a", b"b", b"c"])
        assert len(s) == 3
        assert s.get(keys[:2]) == [b"a", b"b"]
        assert s.get(np.array([[0.5, 0.5, 0.0]], np.float32)) == [None]
        s.set(keys[:1], [b"a2"])  # upsert
        assert len(s) == 3 and s.get(keys[:1]) == [b"a2"]
        assert s.delete(keys[1:2]) == 1
        assert len(s) == 2 and s.get(keys[1:2]) == [None]
        assert s.get(keys[2:3]) == [b"c"]  # survivors intact after compaction


def test_find_cosine_normalized():
    stores = _both()
    for s in stores:
        s.set(np.array([[1, 0], [0, 1], [0.70710678, 0.70710678]], np.float32),
              [b"x", b"y", b"xy"])
    _, values, sims = _same_find(stores, [1.0, 0.0], 2)
    assert values == [b"x", b"xy"]
    assert sims[0] == pytest.approx(1.0, abs=1e-5) and sims[1] == pytest.approx(0.70710678,
                                                                                 abs=1e-5)


def test_find_unnormalized_query_on_normalized_store():
    stores = _both()
    for s in stores:
        s.set(np.array([[1, 0], [0, 1]], np.float32), [b"x", b"y"])
    _, values, sims = _same_find(stores, [2.0, 0.0], 1)
    assert values == [b"x"] and sims[0] == pytest.approx(1.0, abs=1e-5)  # not 2.0


def test_find_topk_zero_empty_and_clamp():
    stores = _both()
    _, v, sims = _same_find(stores, [1.0, 0.0], 5)  # empty store
    assert v == [] and len(sims) == 0
    for s in stores:
        s.set(np.array([[1, 0]], np.float32), [b"only"])
    assert _same_find(stores, [1.0, 0.0], 0)[1] == []
    assert _same_find(stores, [1.0, 0.0], 10)[1] == [b"only"]


def test_find_cosine_unnormalized():
    stores = _both()
    for s in stores:
        s.set(np.array([[2, 0], [0, 3]], np.float32), [b"x", b"y"])
    _, values, sims = _same_find(stores, [4.0, 0.0], 2)
    assert values == [b"x", b"y"]
    assert sims[0] == pytest.approx(1.0, abs=1e-4) and sims[1] == pytest.approx(0.0, abs=1e-4)


def test_dim_mismatch_rejected():
    for s in _both():
        s.set(np.eye(3, dtype=np.float32), [b"a", b"b", b"c"])
        with pytest.raises(ValueError):
            s.set(np.eye(2, dtype=np.float32), [b"x", b"y"])
        with pytest.raises(ValueError):
            s.find(np.array([1.0, 0.0], np.float32), 1)  # query dim 2 != 3


def test_registry_named_stores():
    for reg in (JaxRegistry(), StoreRegistry(device="cpu")):
        reg.get("a").set(np.array([[1.0]], np.float32), [b"v"])
        assert len(reg.get("a")) == 1 and len(reg.get("b")) == 0
        assert reg.names() == ["a", "b"]


@pytest.mark.parametrize("normalized", [True, False])
def test_ties_come_back_lowest_row_first(normalized):
    """Distinct keys with bit-equal similarities (mirror images about the
    query): the order jax.lax.top_k gives, lowest row first, on the fast
    path and on the divide path, also after a delete compacts the rows."""
    dirs = np.array([[0.6, -0.8], [0.0, 1.0], [1.0, 0.0], [-0.6, 0.8], [0.6, 0.8],
                     [-1.0, 0.0], [0.0, -1.0], [-0.6, -0.8]], np.float32)
    keys = dirs * (1.0 if normalized else 3.0)
    stores = _both()
    for s in stores:
        s.set(keys, [f"v{i}".encode() for i in range(len(keys))])
    for q in ([1.0, 0.0], [0.0, 1.0], [0.0, -2.0], [-1.0, 0.0]):
        _, values, sims = _same_find(stores, q, len(keys))
        assert len(set(sims.tolist())) < len(sims)  # the query does tie rows
    assert _same_find(stores, [1.0, 0.0], 3)[1] == [b"v2", b"v0", b"v4"]
    for s in stores:
        s.delete(keys[0:1])
    assert _same_find(stores, [1.0, 0.0], 3)[1] == [b"v2", b"v4", b"v1"]


def test_seeded_store_matches_jax():
    rng = np.random.default_rng(0)
    keys = rng.standard_normal((2000, 32)).astype(np.float32)
    keys /= np.linalg.norm(keys, axis=-1, keepdims=True)
    stores = _both()
    for s in stores:
        s.set(keys[:1500], [str(i).encode() for i in range(1500)])
        s.set(keys[1500:], [str(i).encode() for i in range(1500, 2000)])
    for q in rng.standard_normal((5, 32)).astype(np.float32):
        _same_find(stores, q, 10)
    for s in stores:
        assert s.delete(keys[::7]) == len(keys[::7])
        s.set(keys[:3] * 2.0, [b"long0", b"long1", b"long2"])  # leaves the fast path
    for q in rng.standard_normal((3, 32)).astype(np.float32):
        _same_find(stores, q, 10)


def _serve(make_server, app_cfg, router):
    srv = make_server(app_cfg, router)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _post(base, path, payload):
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


STORE_CALLS = [
    ("/stores/set", {"keys": [[1, 0], [0, 1], [0.6, 0.8]], "values": ["a", "b", "c"]}),
    ("/stores/set", {"store": "s2", "keys": [[2, 0, 1]], "values": ["z"]}),
    ("/stores/get", {"keys": [[1, 0], [0.5, 0.5]]}),
    ("/stores/find", {"key": [1, 0], "topk": 2}),
    ("/stores/find", {"key": [3, 4]}),
    ("/stores/find", {"store": "s2", "key": [1, 0, 0], "topk": 5}),
    ("/stores/find", {"key": [1, 0, 0], "topk": 1}),  # dim mismatch
    ("/stores/find", {"key": [1, 0], "topk": -1}),
    ("/stores/find", {"key": [], "topk": 1}),
    ("/stores/set", {"keys": [[1, 0]], "values": ["a", "b"]}),
    ("/stores/set", {"keys": [[1, 0]], "values": [3]}),
    ("/stores/set", {"keys": [[1, 0], [1]], "values": ["a", "b"]}),
    ("/stores/set", {"keys": [], "values": []}),
    ("/stores/delete", {"keys": [[1, 0]]}),
    ("/stores/get", {"keys": [[1, 0], [0, 1]]}),
    ("/stores/find", {"key": [1, 0], "topk": 10}),
]


def test_stores_http_api_gives_the_jax_servers_bodies():
    from localai_tpu.config import ApplicationConfig as JaxAppConfig
    from localai_tpu.server import Router as JaxRouter
    from localai_tpu.server import create_server as jax_create_server
    from localai_tpu.server.stores_api import StoresApi as JaxStoresApi
    from localai_tpu_torch.config import ApplicationConfig
    from localai_tpu_torch.server import Router, create_server
    from localai_tpu_torch.server.stores_api import StoresApi

    jr, tr = JaxRouter(), Router()
    JaxStoresApi().register(jr)
    StoresApi(StoreRegistry(device="cpu")).register(tr)
    js, jbase = _serve(jax_create_server, JaxAppConfig(address="127.0.0.1", port=0), jr)
    ts, tbase = _serve(create_server, ApplicationConfig(address="127.0.0.1", port=0), tr)
    try:
        for path, payload in STORE_CALLS:
            (jst, jbody), (tst, tbody) = _post(jbase, path, payload), _post(tbase, path, payload)
            assert tst == jst, (path, payload, tbody, jbody)
            if "similarities" in jbody:
                np.testing.assert_allclose(tbody.pop("similarities"), jbody.pop("similarities"),
                                           atol=ATOL, rtol=0)
            assert tbody == jbody, (path, payload)
    finally:
        js.shutdown()
        ts.shutdown()
