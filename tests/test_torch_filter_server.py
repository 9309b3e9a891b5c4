"""The port's ``FilterServer`` and state clients
(``cbfssm_tpu_torch.serving_http``) against the JAX package's (CPU,
float64).

Both servers run on port 0 over pools of the same tiny CBFSSMHALF; the
port's pool takes the JAX draws (``JaxPool`` of
tests/test_torch_filter_pool.py), so one request sequence, with its
400 / 404 / 413 / 503 cases, must give the same status codes, the same
error strings and, for the filter replies, the same numbers (rtol
1e-10). A ``/v1/state`` snapshot of either package (JSON and ``.npz``,
through either package's ``get_state_npz`` / ``post_state_npz``)
restores into the other with ensemble, tick and session table kept, and
``post_params_npz`` of either package hot-swaps the other's fleet.
"""

import http.client
import io
import json
import urllib.error
import urllib.request
import zipfile

import numpy as np
import pytest

from cbfssm_tpu import serving as jax_serving
from cbfssm_tpu import serving_http as jax_http
from cbfssm_tpu_torch import serving_http
from cbfssm_tpu_torch.serving_http import MAX_BODY_BYTES, FilterServer
from tests.test_torch_filter_pool import JaxPool, half  # noqa: F401  (module fixture)

RECOG, DU, DY = 4, 2, 1
CAPACITY = 2
TIMEOUT = 30
RTOL, ATOL = 1e-10, 1e-13


def request(base, method, path, body=None, raw=None, headers=()):
    """(status, parsed JSON reply or raw bytes)."""
    data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(base + path, method=method, data=data)
    if body is not None:
        req.add_header("Content-Type", "application/json")
    for k, v in headers:
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            payload, status, ctype = r.read(), r.status, r.headers.get("Content-Type", "")
    except urllib.error.HTTPError as e:
        payload, status, ctype = e.read(), e.code, e.headers.get("Content-Type", "")
    return status, (json.loads(payload) if ctype.startswith("application/json") else payload)


def declared_oversize(base):
    """A POST that declares a body past MAX_BODY_BYTES and sends none."""
    host, port = base[len("http://"):].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=TIMEOUT)
    try:
        conn.putrequest("POST", "/v1/sessions")
        conn.putheader("Content-Type", "application/json")
        conn.putheader("Content-Length", str(MAX_BODY_BYTES + 1))
        conn.endheaders()
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def zip_bomb():
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("x.npy", b"\x00" * (2 * MAX_BODY_BYTES))
    return buf.getvalue()


def sequence(rng):
    """(method, path, json body or None, raw body or None, headers):
    the request sequence both servers answer."""
    p = [rng.normal(size=(RECOG, d)).tolist() for d in (DU, DY)]
    q = [rng.normal(size=(RECOG, d)).tolist() for d in (DU, DY)]
    step = {"u_prev": rng.normal(size=DU).tolist(), "y_new": rng.normal(size=DY).tolist()}
    npz = (("Content-Type", "application/x-npz"),)
    return [
        ("GET", "/healthz", None, None, ()),
        ("GET", "/v1/meta", None, None, ()),
        ("POST", "/v1/sessions", {"u_prefix": p[0], "y_prefix": p[1]}, None, ()),
        ("POST", "/v1/sessions", {"u_prefix": p[0][:2], "y_prefix": p[1]}, None, ()),
        ("POST", "/v1/sessions", {"u_prefix": p[0]}, None, ()),
        ("POST", "/v1/sessions/0/step", step, None, ()),
        ("POST", "/v1/sessions/0/step", dict(step, y_new=[1.0, 2.0]), None, ()),
        ("POST", "/v1/sessions/0/step", {"u_prev": step["u_prev"]}, None, ()),
        ("POST", "/v1/sessions/9/step", step, None, ()),
        ("POST", "/v1/sessions/0/jump", step, None, ()),
        ("POST", "/v1/sessions/0/forecast",
         {"u_future": rng.normal(size=(3, DU)).tolist()}, None, ()),
        ("POST", "/v1/sessions/0/forecast", {"u_future": [[1.0]]}, None, ()),
        ("POST", "/v1/sessions/0/replay", {"u": rng.normal(size=(3, DU)).tolist(),
                                           "y": rng.normal(size=(3, DY)).tolist()}, None, ()),
        ("POST", "/v1/sessions", {"u_prefix": q[0], "y_prefix": q[1]}, None, ()),
        ("POST", "/v1/sessions", {"u_prefix": q[0], "y_prefix": q[1]}, None, ()),  # pool full
        ("POST", "/v1/sessions/1/step", step, None, ()),
        ("POST", "/v1/nope", {}, None, ()),
        ("GET", "/v1/nope", None, None, ()),
        ("DELETE", "/v1/sessions", None, None, ()),
        ("POST", "/v1/sessions", None, b"{not json", ()),
        ("POST", "/v1/sessions", None, b"[1, 2]", ()),
        ("POST", "/v1/sessions", None, b"", ()),
        ("POST", "/v1/state", {"x": [], "dtype": "float64", "tick": 0}, None, ()),
        ("POST", "/v1/state", {"x": np.zeros((3, 3, 3)).tolist(), "dtype": "float64",
                               "tick": 0, "slots": {}, "next_sid": 0}, None, ()),
        ("POST", "/v1/state", None, zip_bomb(), npz),
        ("POST", "/v1/state", None, b"\x00not-a-zip", npz),
        ("POST", "/v1/params", {}, None, ()),
        ("DELETE", "/v1/sessions/1", None, None, ()),
        ("DELETE", "/v1/sessions/1", None, None, ()),
        ("GET", "/v1/state", None, None, ()),
    ]


def compare(got, want, where):
    """Equal JSON replies, numbers at rtol 1e-10."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), where
        for k in want:
            compare(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list) and want and isinstance(np.asarray(want).dtype.type(), float):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL,
                                   err_msg=where)
    else:
        assert got == want, where


@pytest.fixture(scope="module")
def twin_servers(half):  # noqa: F811
    jm, params, pm, tparams = half
    servers = (jax_http.FilterServer(jax_serving.FilterPool(jm, params, capacity=CAPACITY)),
               FilterServer(JaxPool(pm, tparams, capacity=CAPACITY)))
    for srv in servers:
        srv.start()
    yield [f"http://{srv.host}:{srv.port}" for srv in servers], servers
    for srv in servers:
        srv.close()


def test_request_sequence_matches_jax(twin_servers):
    """Every reply of the sequence: status codes and error strings
    equal, filter replies equal to rtol 1e-10; then 413 on a declared
    oversized body and 503 once the batcher is closed."""
    (jax_base, base), (jax_srv, srv) = twin_servers
    seq = sequence(np.random.default_rng(0))
    seen = set()
    for i, (method, path, body, raw, headers) in enumerate(seq):
        want = request(jax_base, method, path, body, raw, headers)
        got = request(base, method, path, body, raw, headers)
        where = f"request {i}: {method} {path}"
        assert got[0] == want[0], f"{where}: {got} != {want}"
        compare(got[1], want[1], where)
        seen.add(got[0])
    assert seen == {200, 400, 404, 413, 415, 503}
    codes = [request(base, m, p, b, r, h)[0] for m, p, b, r, h in seq[-3:-1]]
    assert codes == [404, 404]  # session 1 already gone
    assert declared_oversize(base) == declared_oversize(jax_base)
    assert declared_oversize(base)[0] == 413
    stats = request(base, "GET", "/v1/stats")[1]
    assert sorted(stats) == sorted(request(jax_base, "GET", "/v1/stats")[1])
    metrics = request(base, "GET", "/metrics")[1].decode()
    assert "cbfssm_active_sessions 1" in metrics
    for s in (jax_srv, srv):
        s.batcher.close()
    closed = [request(b, "POST", "/v1/sessions/0/step",
                      {"u_prev": [0.0] * DU, "y_new": [0.0] * DY}) for b in (jax_base, base)]
    assert closed[0][0] == closed[1][0] == 503
    assert closed[1][1] == {"error": "FilterBatcher is closed"} == closed[0][1]


@pytest.fixture(scope="module")
def fleets(half):  # noqa: F811
    """A JAX and a port server with two sessions and three ticks each
    (the port's on its own draws), and a standby of each package built
    with another seed."""
    jm, params, pm, tparams = half
    from cbfssm_tpu_torch.serving import FilterPool

    rng = np.random.default_rng(2)
    prefixes = [[rng.normal(size=(RECOG, d)).tolist() for d in (DU, DY)] for _ in range(2)]
    servers = {
        "jax": jax_http.FilterServer(jax_serving.FilterPool(jm, params, capacity=CAPACITY)),
        "port": FilterServer(FilterPool(pm, tparams, capacity=CAPACITY)),
        "jax_standby": jax_http.FilterServer(
            jax_serving.FilterPool(jm, params, capacity=CAPACITY, seed=5)),
        "port_standby": FilterServer(FilterPool(pm, tparams, capacity=CAPACITY, seed=5)),
    }
    bases = {}
    for name, srv in servers.items():
        srv.start()
        bases[name] = f"http://{srv.host}:{srv.port}"
    for name in ("jax", "port"):
        for u, y in prefixes:
            assert request(bases[name], "POST", "/v1/sessions",
                           {"u_prefix": u, "y_prefix": y})[0] == 200
        request(bases[name], "DELETE", "/v1/sessions/0")  # a hole in the table
        for _ in range(3):
            assert request(bases[name], "POST", "/v1/sessions/1/step",
                           {"u_prev": [0.1] * DU, "y_new": [0.2] * DY})[0] == 200
    yield bases, servers
    for srv in servers.values():
        srv.close()


def pool_state(server):
    return server.batcher.state().result(TIMEOUT)


@pytest.mark.parametrize("source,target", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("fmt", ["json", "npz"])
def test_state_snapshot_restores_across_packages(fleets, source, target, fmt):
    """GET /v1/state of one package, POST into the other's standby (built
    with another seed): ensemble, tick, table, next sid and key kept; the
    standby then steps session 1."""
    bases, servers = fleets
    standby = f"{target}_standby"
    get_npz = (serving_http if target == "port" else jax_http).get_state_npz
    post_npz = (jax_http if target == "port" else serving_http).post_state_npz
    if fmt == "npz":  # each package's client against the other's servers
        post_npz(bases[standby], get_npz(bases[source], timeout=TIMEOUT), timeout=TIMEOUT)
    else:
        code, snap = request(bases[source], "GET", "/v1/state")
        assert code == 200 and snap["key_dtype"] == "uint32"
        assert request(bases[standby], "POST", "/v1/state", snap) == (200, {"ok": True})
    x, tick, slots, next_sid, key = pool_state(servers[source])
    sx, stick, sslots, snext, skey = pool_state(servers[standby])
    np.testing.assert_array_equal(np.asarray(sx), np.asarray(x))
    assert (stick, sslots, snext) == (tick, slots, next_sid) == (3, {1: 1}, 2)
    assert np.array_equal(np.asarray(skey), np.asarray(key))
    code, out = request(bases[standby], "POST", "/v1/sessions/1/step",
                        {"u_prev": [0.1] * DU, "y_new": [0.2] * DY})
    assert code == 200 and np.all(np.asarray(out["var"]) > 0)


def test_port_standby_resumes_port_primary_bitwise(fleets):
    """Failover inside the port: the standby (another seed) restored from
    the primary's .npz snapshot answers the next tick bitwise as the
    primary."""
    bases, _ = fleets
    serving_http.post_state_npz(bases["port_standby"],
                                serving_http.get_state_npz(bases["port"], timeout=TIMEOUT),
                                timeout=TIMEOUT)
    tick = {"u_prev": [0.3] * DU, "y_new": [-0.1] * DY}
    assert request(bases["port_standby"], "POST", "/v1/sessions/1/step", tick) == \
        request(bases["port"], "POST", "/v1/sessions/1/step", tick)


@pytest.mark.parametrize("direction", ["port client, jax server", "jax client, port server"])
def test_params_hot_swap_across_packages(fleets, half, direction):  # noqa: F811
    """post_params_npz of either package swaps the other's fleet
    checkpoint; sessions keep their state."""
    bases, servers = fleets
    jm, params, pm, tparams = half
    if direction.startswith("port"):
        name, send = "jax", lambda: serving_http.post_params_npz(bases["jax"], tparams,
                                                                 timeout=TIMEOUT)
    else:
        name, send = "port", lambda: jax_http.post_params_npz(bases["port"], params,
                                                              timeout=TIMEOUT)
    before = pool_state(servers[name])
    send()
    after = pool_state(servers[name])
    np.testing.assert_array_equal(np.asarray(after[0]), np.asarray(before[0]))
    assert after[1:4] == before[1:4]
    code, out = request(bases[name], "POST", "/v1/sessions/1/step",
                        {"u_prev": [0.1] * DU, "y_new": [0.2] * DY})
    assert code == 200 and np.all(np.isfinite(out["mean"]))


def test_get_state_npz_refuses_a_json_reply(fleets, monkeypatch):
    bases, _ = fleets
    monkeypatch.setattr(serving_http._FilterHandler, "_accepts_npz", lambda self: False)
    with pytest.raises(RuntimeError, match="does not support binary snapshots"):
        serving_http.get_state_npz(bases["port"], timeout=TIMEOUT)


def test_auth_gates_state_and_sessions(half):  # noqa: F811
    """With a token, GET /v1/state and every POST / DELETE need it, with
    the JAX server's 401 reply; reads stay open."""
    jm, params, pm, tparams = half
    replies = []
    for srv in (jax_http.FilterServer(jax_serving.FilterPool(jm, params, capacity=1),
                                      auth_token="s3cret"),
                FilterServer(JaxPool(pm, tparams, capacity=1), auth_token="s3cret")):
        with srv:
            srv.start()
            base = f"http://{srv.host}:{srv.port}"
            replies.append([request(base, "GET", "/v1/state"),
                            request(base, "DELETE", "/v1/sessions/0"),
                            request(base, "GET", "/v1/meta")[0],
                            request(base, "GET", "/v1/state",
                                    headers=(("Authorization", "Bearer s3cret"),))[0]])
    assert replies[0] == replies[1]
    assert replies[1][0][0] == 401 and replies[1][2:] == [200, 200]
