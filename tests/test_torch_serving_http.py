"""The port's HTTP transport (``cbfssm_tpu_torch/serving_http.py``) and
the checkpoint hot-swap of its batch predictors (CPU).

- The predictor-server cases of tests/test_serving_http.py on a numpy
  stub predictor: the round-trip, meta / stats / healthz, the 4xx
  surface, 503 after close and 500 on a predictor failure, coalescing
  and a connection burst, keep-alive after errors and successes,
  chunked bodies, a bounded stalled drain, the reply to an oversized
  body, Prometheus ``/metrics``, garbage input, ``.npz`` equal to JSON,
  the zip-bomb guard, and Bearer auth.
- With a real tiny CBFSSM behind a ``BucketedPredictor`` (float64):
  replies (JSON and ``.npz``) equal the direct calls with generator seed
  ``fold_seed(0, k)`` for dispatch k, exactly; ``/v1/params`` swaps the
  checkpoint (replies then equal the new params' direct calls), a wrong
  leaf is a 400, and a params body the JAX package's ``post_params_npz``
  wrote from JAX params is accepted as it is.
- ``validate_params_like`` and ``reload_params`` of the two predictors,
  and the JAX flatten order of ``params_to_leaves``.
"""

import http.client
import io
import json
import socket
import threading
import time
import urllib.error
import urllib.request
import zipfile

import jax
import numpy as np
import pytest
import torch

from cbfssm_tpu import serving_http as jax_http
from cbfssm_tpu.models import CBFSSM as JaxCBFSSM
from cbfssm_tpu.models import CBFSSMHALF as JaxCBFSSMHALF
from cbfssm_tpu_torch import convert, serving_http
from cbfssm_tpu_torch.models import CBFSSM, CBFSSMHALF
from cbfssm_tpu_torch.models.base import PredictOutput
from cbfssm_tpu_torch.serving import (BucketedPredictor, CompiledPredictor, fold_seed,
                                      params_from_leaves, params_to_leaves,
                                      validate_params_like)
from cbfssm_tpu_torch.serving_http import (MAX_BODY_BYTES, PredictionServer, post_params_npz,
                                           post_predict_npz)
from tests.test_other_models import half_config
from tests.test_torch_cbfssm import params_numpy as cbfssm_numpy
from tests.test_torch_other_models import params_numpy as half_numpy
from tests.test_torch_serving import TinyDS, tiny_config

SEQ, DU, DY = 8, 2, 1
TIMEOUT = 30


class StubModel:
    dtype = torch.float64
    np_dtype = np.dtype("float64")
    dim_u = DU
    dim_y = DY


class StubPredictor:
    """Deterministic numpy predictor recording every dispatched batch;
    it has no ``reload_params`` (as an exported artifact's)."""

    def __init__(self, fail=False):
        self.model = StubModel()
        self.seq_len = SEQ
        self.calls = []
        self.fail = fail

    def __call__(self, u, y, seed=None):
        if self.fail:
            raise RuntimeError("device on fire")
        self.calls.append(u.shape)
        mean = u[..., :DY] + 1.0  # row-identifiable output
        var = np.ones_like(mean)
        return PredictOutput(pred_mean=mean, pred_var=var, internal_mean=u, internal_var=u,
                             mse=np.mean((mean - y) ** 2), sde=var)


def _http(method, url, body=None, timeout=TIMEOUT, headers=()):
    req = urllib.request.Request(url, method=method)
    data = None
    if body is not None:
        data = json.dumps(body).encode()
        req.add_header("Content-Type", "application/json")
    for name, value in headers:
        req.add_header(name, value)
    try:
        with urllib.request.urlopen(req, data=data, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _recv_http_reply(sock, timeout=TIMEOUT):
    """One HTTP reply (headers + Content-Length body) off a raw socket:
    (status, headers, body)."""
    sock.settimeout(timeout)
    buf = b""
    while b"\r\n\r\n" not in buf:
        chunk = sock.recv(1 << 16)
        assert chunk, f"connection closed mid-headers: {buf!r}"
        buf += chunk
    head, _, rest = buf.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    status = int(lines[0].split()[1])
    headers = {}
    for ln in lines[1:]:
        k, _, v = ln.partition(":")
        headers[k.strip().lower()] = v.strip()
    want = int(headers.get("content-length", 0))
    while len(rest) < want:
        chunk = sock.recv(1 << 16)
        assert chunk, "connection closed mid-body"
        rest += chunk
    return status, headers, rest[:want]


def _base(srv):
    return f"http://{srv.host}:{srv.port}"


@pytest.fixture
def stub_server():
    srv = PredictionServer(StubPredictor(), port=0, max_wait_ms=0.0)
    srv.start()
    try:
        yield srv, _base(srv)
    finally:
        srv.close()


@pytest.fixture
def auth_stub_server():
    srv = PredictionServer(StubPredictor(), port=0, max_wait_ms=0.0, auth_token="s3cret")
    srv.start()
    try:
        yield srv, _base(srv)
    finally:
        srv.close()


AUTH = (("Authorization", "Bearer s3cret"),)


def request_body(rng):
    return {"u": rng.normal(size=(SEQ, DU)).tolist(), "y": rng.normal(size=(SEQ, DY)).tolist()}


# --- the transport on a stub predictor ---------------------------------


def test_http_predict_roundtrip(stub_server, rng):
    srv, base = stub_server
    u = rng.normal(size=(SEQ, DU))
    y = rng.normal(size=(SEQ, DY))
    code, resp = _http("POST", base + "/v1/predict", {"u": u.tolist(), "y": y.tolist()})
    assert code == 200
    np.testing.assert_allclose(resp["pred_mean"], u[:, :DY] + 1.0)
    np.testing.assert_allclose(resp["internal_mean"], u)
    np.testing.assert_allclose(resp["mse"], np.mean((u[:, :DY] + 1.0 - y) ** 2))
    assert np.asarray(resp["pred_var"]).shape == (SEQ, DY)
    assert srv.batcher.predictor.calls == [(1, SEQ, DU)]


def test_http_meta_stats_healthz(stub_server, rng):
    srv, base = stub_server
    assert _http("GET", base + "/healthz") == (200, {"ok": True})
    code, meta = _http("GET", base + "/v1/meta")
    assert code == 200
    assert meta["predictor"] == "StubPredictor"
    assert (meta["seq_len"], meta["dim_u"], meta["dim_y"]) == (SEQ, DU, DY)
    assert meta["dtype"] == "float64"
    assert (meta["max_batch"], meta["max_wait_ms"]) == (32, 0.0)
    _http("POST", base + "/v1/predict", request_body(rng))
    code, stats = _http("GET", base + "/v1/stats")
    assert code == 200
    assert stats["requests"] == 1 and stats["batches"] == 1
    assert stats["http_requests"] >= 3 and stats["http_errors"] == 0


def test_http_error_surface(stub_server, rng):
    srv, base = stub_server
    body = request_body(rng)
    u, y = body["u"], body["y"]
    cases = [
        ("GET", "/nope", None, 404),
        ("POST", "/nope", body, 404),
        ("POST", "/v1/predict", {"u": u}, 400),          # missing y
        ("POST", "/v1/predict", [1, 2], 400),            # not an object
        ("POST", "/v1/predict", {"u": "text", "y": y}, 400),
        ("POST", "/v1/predict", {"u": np.zeros((SEQ + 1, DU)).tolist(), "y": y}, 400),
    ]
    for method, path, req, want in cases:
        code, resp = _http(method, base + path, req)
        assert code == want, (path, req, resp)
        assert "error" in resp
    req = urllib.request.Request(f"{base}/v1/predict", data=b"{not json", method="POST")
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(req, timeout=TIMEOUT)
    assert exc.value.code == 400
    exc.value.read()
    _, stats = _http("GET", base + "/v1/stats")
    assert stats["http_errors"] == 7
    assert _http("GET", base + "/healthz")[0] == 200


def test_http_batcher_closed_maps_to_503(stub_server, rng):
    srv, base = stub_server
    srv.batcher.close()
    code, resp = _http("POST", base + "/v1/predict", request_body(rng))
    assert code == 503 and "closed" in resp["error"]


def test_http_predictor_failure_maps_to_500(rng):
    srv = PredictionServer(StubPredictor(fail=True), port=0, max_wait_ms=0.0)
    srv.start()
    try:
        code, resp = _http("POST", _base(srv) + "/v1/predict", request_body(rng))
        assert code == 500 and "device on fire" in resp["error"]
        assert _http("GET", _base(srv) + "/healthz")[0] == 200
    finally:
        srv.close()


def test_http_concurrent_requests_coalesce(rng):
    """Three concurrent clients land in one predictor dispatch, and each
    gets its own row back."""
    pred = StubPredictor()
    srv = PredictionServer(pred, port=0, max_batch=3, max_wait_ms=500.0)
    srv.start()
    try:
        us = rng.normal(size=(3, SEQ, DU))
        ys = rng.normal(size=(3, SEQ, DY))
        results = [None] * 3

        def client(i):
            results[i] = _http("POST", _base(srv) + "/v1/predict",
                               {"u": us[i].tolist(), "y": ys[i].tolist()})

        threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        for i, (code, resp) in enumerate(results):
            assert code == 200
            np.testing.assert_allclose(resp["pred_mean"], us[i][:, :DY] + 1.0)
        assert pred.calls == [(3, SEQ, DU)]
    finally:
        srv.close()


def test_http_connection_burst_all_served():
    """48 simultaneous connections are all served (the accept queue is
    sized for bursts)."""
    srv = PredictionServer(StubPredictor(), port=0, max_wait_ms=0.0)
    srv.start()
    try:
        assert srv._httpd.request_queue_size >= 64
        n = 48
        barrier = threading.Barrier(n)
        results = [None] * n

        def client(i):
            barrier.wait(timeout=TIMEOUT)
            try:
                results[i] = _http("GET", _base(srv) + "/healthz", timeout=20)
            except OSError as e:
                results[i] = e

        threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert all(r == (200, {"ok": True}) for r in results), results
    finally:
        srv.close()


def test_close_is_idempotent_and_safe_without_serve_loop():
    srv = PredictionServer(StubPredictor(), port=0)
    srv.close()
    srv.close()
    with PredictionServer(StubPredictor(), port=0) as srv2:
        srv2.start()
    srv2.close()


def test_concurrent_close_is_idempotent_and_blocking(stub_server):
    srv, _ = stub_server
    errs = []

    def closer():
        try:
            srv.close()
        except Exception as e:  # pragma: no cover - failure detail
            errs.append(e)

    ts = [threading.Thread(target=closer) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
    assert not errs
    assert srv.batcher._closing


def test_server_bind_failure_leaks_no_dispatcher_thread():
    def named(prefix):
        return [t for t in threading.enumerate() if t.name.startswith(prefix) and t.is_alive()]

    blocker = socket.socket()
    try:
        blocker.bind(("127.0.0.1", 0))
        blocker.listen(1)
        before = len(named("cbfssm-microbatcher"))
        with pytest.raises(OSError):
            PredictionServer(StubPredictor(), port=blocker.getsockname()[1])
        assert len(named("cbfssm-microbatcher")) == before
    finally:
        blocker.close()


def test_http_keepalive_survives_error_replies(stub_server, rng):
    """An error reply sent before the body was read does not desync a
    keep-alive connection."""
    srv, _ = stub_server
    conn = http.client.HTTPConnection(srv.host, srv.port, timeout=TIMEOUT)
    body = json.dumps(request_body(rng)).encode()
    hdr = {"Content-Type": "application/json"}
    try:
        for path, payload, want in (("/nope", body, 404), ("/v1/predict", b'{"u": [[0.0]]}', 400),
                                    ("/v1/predict", b"not json", 400), ("/v1/predict", body, 200)):
            conn.request("POST", path, body=payload, headers=hdr)
            r = conn.getresponse()
            assert r.status == want, path
            out = json.loads(r.read())
        assert np.all(np.isfinite(out["pred_mean"]))
        conn.request("GET", "/healthz")
        r = conn.getresponse()
        assert r.status == 200 and json.loads(r.read()) == {"ok": True}
    finally:
        conn.close()


def test_keepalive_survives_success_reply_with_body(stub_server, rng):
    srv, _ = stub_server
    conn = http.client.HTTPConnection(srv.host, srv.port, timeout=TIMEOUT)
    try:
        conn.request("GET", "/healthz", body=b'{"why": "not"}',
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        assert r.status == 200 and json.loads(r.read()) == {"ok": True}
        conn.request("POST", "/v1/predict", body=json.dumps(request_body(rng)).encode(),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        assert r.status == 200
        assert np.all(np.isfinite(json.loads(r.read())["pred_mean"]))
    finally:
        conn.close()


def test_chunked_body_rejected_and_connection_closed(stub_server):
    srv, _ = stub_server
    with socket.create_connection((srv.host, srv.port), timeout=TIMEOUT) as s:
        s.sendall(b"POST /v1/predict HTTP/1.1\r\nHost: t\r\nTransfer-Encoding: chunked\r\n"
                  b"Content-Type: application/json\r\n\r\n5\r\nhello\r\n0\r\n\r\n")
        status, headers, body = _recv_http_reply(s)
        assert status == 400
        assert "chunked" in json.loads(body)["error"]
        assert headers.get("connection") == "close"
        assert s.recv(1 << 16) == b""


def test_stalled_body_drain_is_bounded(stub_server, monkeypatch):
    monkeypatch.setattr(serving_http, "DRAIN_TIMEOUT", 0.5)
    srv, _ = stub_server
    with socket.create_connection((srv.host, srv.port), timeout=TIMEOUT) as s:
        t0 = time.monotonic()
        s.sendall(b"POST /nope HTTP/1.1\r\nHost: t\r\nContent-Length: 100\r\n\r\n")
        status, headers, _ = _recv_http_reply(s)
        assert status == 404
        assert time.monotonic() - t0 < 10.0
        assert headers.get("connection") == "close"


def test_oversized_body_client_sees_reply_not_reset(stub_server):
    srv, _ = stub_server
    with socket.create_connection((srv.host, srv.port), timeout=TIMEOUT) as s:
        s.sendall(b"POST /v1/predict HTTP/1.1\r\nHost: t\r\nContent-Type: application/json\r\n"
                  b"Content-Length: " + str(MAX_BODY_BYTES + 1).encode() + b"\r\n\r\n")
        s.sendall(b"x" * (1 << 16))
        status, _, body = _recv_http_reply(s)
        assert status == 413
        assert "exceeds" in json.loads(body)["error"]
        try:
            s.sendall(b"y" * (1 << 16))
        except OSError:
            pass
        assert s.recv(1 << 16) == b""


def test_metrics_endpoint_prometheus_format(stub_server, rng):
    srv, base = stub_server
    assert _http("POST", base + "/v1/predict", request_body(rng))[0] == 200
    with urllib.request.urlopen(base + "/metrics", timeout=TIMEOUT) as r:
        assert r.status == 200
        assert r.headers["Content-Type"].startswith("text/plain")
        text = r.read().decode()
    metrics = {}
    for ln in text.strip().split("\n"):
        if ln.startswith("#"):
            assert ln.split()[2].startswith("cbfssm_")
            continue
        name, val = ln.split()
        metrics[name] = float(val)
    assert metrics["cbfssm_http_requests_total"] >= 1
    assert metrics["cbfssm_requests_total"] >= 1
    assert "cbfssm_mean_batch_size" in metrics
    _, stats = _http("GET", base + "/v1/stats")
    assert metrics["cbfssm_batches_total"] == stats["batches"]


def test_garbage_input_does_not_wedge_listener(stub_server, rng):
    srv, base = stub_server
    for payload in (b"\x00\x01\x02\xff garbage that is not HTTP\r\n\r\n",
                    b"GET " + b"/" * 70000 + b" HTTP/1.1\r\n\r\n",
                    b"POST /v1/predict HTTP/1.1\r\nBad-Header-No-Colon\r\n\r\n", b""):
        with socket.create_connection((srv.host, srv.port), timeout=TIMEOUT) as s:
            if payload:
                s.sendall(payload)
            s.shutdown(socket.SHUT_WR)
            s.settimeout(TIMEOUT)
            while s.recv(1 << 16):
                pass
    code, resp = _http("POST", base + "/v1/predict", request_body(rng))
    assert code == 200 and np.all(np.isfinite(resp["pred_mean"]))


def test_npz_predict_matches_json_exactly(stub_server, rng):
    _, base = stub_server
    u = rng.normal(size=(SEQ, DU))
    y = rng.normal(size=(SEQ, DY))
    code, js = _http("POST", base + "/v1/predict", {"u": u.tolist(), "y": y.tolist()})
    assert code == 200
    out = post_predict_npz(base, u, y, timeout=TIMEOUT)
    assert set(out) == set(js)
    for f, v in js.items():
        np.testing.assert_array_equal(out[f], np.asarray(v, dtype=out[f].dtype), err_msg=f)
    assert out["pred_mean"].shape == (SEQ, DY) and out["mse"].ndim == 0


def test_npz_zip_bomb_rejected_before_materialization(stub_server, rng):
    bomb = io.BytesIO()
    with zipfile.ZipFile(bomb, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("u.npy", b"\x00" * (2 * MAX_BODY_BYTES))
    body = bomb.getvalue()
    assert len(body) < MAX_BODY_BYTES
    srv, _ = stub_server
    conn = http.client.HTTPConnection(srv.host, srv.port, timeout=TIMEOUT)
    try:
        conn.request("POST", "/v1/predict", body=body,
                     headers={"Content-Type": "application/x-npz"})
        r = conn.getresponse()
        assert r.status == 413
        assert "decompresses" in json.loads(r.read())["error"]
        buf = io.BytesIO()
        np.savez(buf, u=rng.normal(size=(SEQ, DU)), y=rng.normal(size=(SEQ, DY)))
        conn.request("POST", "/v1/predict", body=buf.getvalue(),
                     headers={"Content-Type": "application/x-npz"})
        r = conn.getresponse()
        assert r.status == 200
        r.read()
    finally:
        conn.close()


def test_npz_predict_keepalive_and_error_surface(stub_server, rng):
    srv, _ = stub_server
    conn = http.client.HTTPConnection(srv.host, srv.port, timeout=TIMEOUT)
    npz = {"Content-Type": "application/x-npz"}
    try:
        conn.request("POST", "/v1/predict", body=b"\x00not-a-zip", headers=npz)
        r = conn.getresponse()
        assert r.status == 400 and "npz" in json.loads(r.read())["error"]
        buf = io.BytesIO()
        np.savez(buf, u=rng.normal(size=(SEQ, DU)))
        conn.request("POST", "/v1/predict", body=buf.getvalue(), headers=npz)
        r = conn.getresponse()
        assert r.status == 400 and "'u' and 'y'" in json.loads(r.read())["error"]
        pickled = io.BytesIO()
        np.save(pickled, np.array([{"a": 1}], dtype=object), allow_pickle=True)
        zbuf = io.BytesIO()
        with zipfile.ZipFile(zbuf, "w") as zf:
            zf.writestr("u.npy", pickled.getvalue())
            zf.writestr("y.npy", pickled.getvalue())
        conn.request("POST", "/v1/predict", body=zbuf.getvalue(), headers=npz)
        r = conn.getresponse()
        assert r.status == 400
        r.read()
        buf = io.BytesIO()
        np.savez(buf, u=rng.normal(size=(SEQ, DU)), y=rng.normal(size=(SEQ, DY)))
        conn.request("POST", "/v1/predict", body=buf.getvalue(), headers=npz)
        r = conn.getresponse()
        assert r.status == 200 and r.headers["Content-Type"] == "application/x-npz"
        with np.load(io.BytesIO(r.read()), allow_pickle=False) as z:
            assert np.all(np.isfinite(z["pred_mean"]))
    finally:
        conn.close()


def test_predict_auth_required(auth_stub_server, rng):
    """With a token, POST /v1/predict answers 401 without or with wrong
    credentials (counted, WWW-Authenticate set) and 200 with the right
    one; the monitoring GETs stay open."""
    srv, base = auth_stub_server
    body = request_body(rng)
    code, resp = _http("POST", base + "/v1/predict", body)
    assert code == 401 and "auth token" in resp["error"]
    for header in (("Authorization", "Bearer wrong"), ("Authorization", "s3cret")):
        assert _http("POST", base + "/v1/predict", body, headers=(header,))[0] == 401
    req = urllib.request.Request(base + "/v1/predict", method="POST",
                                 data=json.dumps(body).encode())
    req.add_header("Content-Type", "application/json")
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(req, timeout=TIMEOUT)
    assert exc.value.code == 401 and exc.value.headers["WWW-Authenticate"] == "Bearer"
    exc.value.read()
    assert _http("POST", base + "/v1/predict", body, headers=AUTH)[0] == 200
    for path in ("/healthz", "/v1/meta", "/v1/stats"):
        assert _http("GET", base + path)[0] == 200, path
    assert srv.stats()["http_errors"] == 4


def test_predict_npz_and_params_auth(auth_stub_server, rng):
    """The binary path and /v1/params are gated the same way; the client
    helpers carry the token."""
    _, base = auth_stub_server
    u = rng.normal(size=(SEQ, DU))
    y = rng.normal(size=(SEQ, DY))
    with pytest.raises(urllib.error.HTTPError) as exc:
        post_predict_npz(base, u, y, timeout=TIMEOUT)
    assert exc.value.code == 401
    exc.value.read()
    out = post_predict_npz(base, u, y, timeout=TIMEOUT, auth_token="s3cret")
    np.testing.assert_allclose(out["pred_mean"], u[:, :DY] + 1.0)
    with pytest.raises(urllib.error.HTTPError) as exc:
        post_params_npz(base, [np.zeros(2)], timeout=TIMEOUT)
    assert exc.value.code == 401
    exc.value.read()


def test_no_token_server_stays_open(stub_server, rng):
    _, base = stub_server
    assert _http("POST", base + "/v1/predict", request_body(rng))[0] == 200


def test_params_refused_without_reload_params(stub_server):
    """A predictor without reload_params (an exported artifact's) refuses
    a hot-swap with 400."""
    _, base = stub_server
    with pytest.raises(urllib.error.HTTPError) as exc:
        post_params_npz(base, [np.zeros(2)], timeout=TIMEOUT)
    assert exc.value.code == 400
    assert b"exported" in exc.value.read()


# --- a real tiny model behind the server --------------------------------


@pytest.fixture(scope="module")
def tiny():
    """A float64 CBFSSM and two checkpoints (seeds 0 and 1)."""
    model = CBFSSM(tiny_config(), device="cpu")
    return (model, model.init(torch.Generator().manual_seed(0)),
            model.init(torch.Generator().manual_seed(1)))


def windows(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, SEQ, TinyDS.dim_u)), rng.normal(size=(n, SEQ, TinyDS.dim_y))


def assert_reply_equals(reply: dict, direct, row: int = 0):
    for f in ("pred_mean", "pred_var", "internal_mean", "internal_var", "sde"):
        np.testing.assert_array_equal(np.asarray(reply[f]), getattr(direct, f)[row], err_msg=f)


def test_replies_equal_direct_calls_and_hot_swap(tiny):
    """Dispatch k runs with generator seed fold_seed(0, k): JSON and .npz
    replies equal the direct BucketedPredictor calls exactly, before and
    after a /v1/params swap; a wrong leaf shape and a JSON params body
    are refused and leave the served params as they were."""
    model, a, b = tiny
    u, y = windows(4)
    pred = BucketedPredictor(model, a, seq_len=SEQ, buckets=(1, 2))
    direct_a = BucketedPredictor(model, a, seq_len=SEQ, buckets=(1, 2))
    direct_b = BucketedPredictor(model, b, seq_len=SEQ, buckets=(1, 2))
    with PredictionServer(pred, port=0, max_wait_ms=0.0) as srv:
        srv.start()
        base = _base(srv)
        code, meta = _http("GET", base + "/v1/meta")  # the model's dtype is a torch.dtype
        assert code == 200 and meta["dtype"] == "float64" and meta["seq_len"] == SEQ
        code, js = _http("POST", base + "/v1/predict", {"u": u[0].tolist(), "y": y[0].tolist()})
        assert code == 200
        assert_reply_equals(js, direct_a(u[:1], y[:1], fold_seed(0, 0)))
        out = post_predict_npz(base, u[1], y[1], timeout=TIMEOUT)
        assert_reply_equals(out, direct_a(u[1:2], y[1:2], fold_seed(0, 1)))
        assert float(out["mse"]) == float(direct_a(u[1:2], y[1:2], fold_seed(0, 1)).mse)
        post_params_npz(base, b, timeout=TIMEOUT)
        code, js = _http("POST", base + "/v1/predict", {"u": u[2].tolist(), "y": y[2].tolist()})
        assert code == 200
        assert_reply_equals(js, direct_b(u[2:3], y[2:3], fold_seed(0, 2)))
        leaves = params_to_leaves(b)
        bad = [np.zeros((3, 3))] + leaves[1:]
        with pytest.raises(urllib.error.HTTPError) as exc:
            post_params_npz(base, bad, timeout=TIMEOUT)
        assert exc.value.code == 400 and b"leaf 0" in exc.value.read()
        with pytest.raises(urllib.error.HTTPError) as exc:
            post_params_npz(base, leaves[:-1], timeout=TIMEOUT)
        assert exc.value.code == 400 and b"exactly p0..p" in exc.value.read()
        assert _http("POST", base + "/v1/params", {"p0": [1.0]})[0] == 415
        out = post_predict_npz(base, u[3], y[3], timeout=TIMEOUT)
        assert_reply_equals(out, direct_b(u[3:4], y[3:4], fold_seed(0, 3)))


def test_coalesced_rows_equal_direct_batch(tiny):
    """Concurrent requests coalesced into one dispatch: each reply is its
    row of the direct call on the dispatched batch."""
    model, a, _ = tiny
    u, y = windows(3, seed=1)
    seen = []

    class Recording(BucketedPredictor):
        def __call__(self, u, y, seed=None):
            seen.append((u, y, seed))
            return super().__call__(u, y, seed)

    direct = BucketedPredictor(model, a, seq_len=SEQ, buckets=(1, 2, 4))
    with PredictionServer(Recording(model, a, SEQ, buckets=(1, 2, 4)), port=0, max_batch=3,
                          max_wait_ms=500.0) as srv:
        srv.start()
        replies = [None] * 3

        def client(i):
            replies[i] = post_predict_npz(_base(srv), u[i], y[i], timeout=TIMEOUT)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
    assert [s[2] for s in seen] == [fold_seed(0, k) for k in range(len(seen))]
    for i in range(3):
        k, row = next((k, r) for k, s in enumerate(seen) for r in range(s[0].shape[0])
                      if np.array_equal(s[0][r], u[i]))
        assert_reply_equals(replies[i], direct(seen[k][0], seen[k][1], seen[k][2]), row)


@pytest.mark.parametrize("kind", ["cbfssm", "half"])
def test_jax_written_params_body_is_accepted(kind):
    """A params .npz the JAX package's post_params_npz writes from JAX
    params is accepted as it is; the port then predicts as it does with
    convert's port params of the same tree, and params_to_leaves gives
    the JAX flatten order and layout (so the reverse holds too)."""
    if kind == "cbfssm":
        cfg, jax_cls, port_cls = tiny_config(), JaxCBFSSM, CBFSSM
        from_numpy, as_numpy = convert.cbfssm_params_from_numpy, cbfssm_numpy
    else:
        cfg, jax_cls, port_cls = half_config("rnn"), JaxCBFSSMHALF, CBFSSMHALF
        from_numpy, as_numpy = convert.cbfssmhalf_params_from_numpy, half_numpy
    jax_params = jax_cls(cfg).init(jax.random.PRNGKey(3))
    model = port_cls(cfg, device="cpu")
    want = from_numpy(as_numpy(jax_params), device="cpu")
    jax_leaves = jax.tree_util.tree_leaves(jax_params)
    for x, mine in zip(jax_leaves, params_to_leaves(want), strict=True):
        np.testing.assert_array_equal(mine, np.asarray(x))
        assert mine.dtype == np.asarray(x).dtype
    u, y = windows(1, seed=2)
    u = u[..., :model.dim_u]
    y = y[..., :model.dim_y]
    pred = BucketedPredictor(model, model.init(torch.Generator().manual_seed(0)), SEQ,
                             buckets=(1,))
    with PredictionServer(pred, port=0, max_wait_ms=0.0) as srv:
        srv.start()
        jax_http.post_params_npz(_base(srv), jax_params, timeout=TIMEOUT)
        out = post_predict_npz(_base(srv), u[0], y[0], timeout=TIMEOUT)
    direct = BucketedPredictor(model, want, SEQ, buckets=(1,))(u, y, fold_seed(0, 0))
    assert_reply_equals(out, direct)


# --- hot-swap of the predictors -----------------------------------------


def test_validate_params_like_errors(tiny):
    model, a, b = tiny
    out = validate_params_like(a, b)
    for x, w in zip(out.tensors(), b.tensors(), strict=True):
        assert torch.equal(x, w) and x.data_ptr() != w.data_ptr()  # a copy
    bad_shape = b.with_tensors([torch.zeros(3, 3, dtype=torch.float64)] + b.tensors()[1:])
    with pytest.raises(ValueError, match="leaf 0"):
        validate_params_like(a, bad_shape)
    with pytest.raises(ValueError, match="tree structure"):
        validate_params_like(a, tuple(b.tensors()))
    with pytest.raises(ValueError, match="tree structure"):
        validate_params_like(a, CBFSSMHALF(half_config("rnn"), device="cpu").init(
            torch.Generator().manual_seed(0)))
    bad_dtype = b.with_tensors([b.tensors()[0].float()] + b.tensors()[1:])
    with pytest.raises(ValueError, match="leaf 0 is float32"):
        validate_params_like(a, bad_dtype)
    with pytest.raises(ValueError, match="leaf 0"):
        params_from_leaves(a, [np.zeros((3, 3))] + params_to_leaves(b)[1:])


def test_compiled_and_bucketed_predictor_swap(tiny):
    model, a, b = tiny
    u, y = windows(3, seed=3)
    pred = CompiledPredictor(model, a, batch=1, seq_len=SEQ)
    pred.reload_params(b)
    want = CompiledPredictor(model, b, batch=1, seq_len=SEQ)
    assert torch.equal(pred(u[:1], y[:1]).pred_mean, want(u[:1], y[:1]).pred_mean)
    bp = BucketedPredictor(model, a, seq_len=SEQ, buckets=(1, 2))
    src = b.with_tensors([t.clone() for t in b.tensors()])
    bp.reload_params(src)
    with torch.no_grad():
        for t in src.tensors():  # the swap copied: later edits do not leak in
            t.add_(1.0)
    wb = BucketedPredictor(model, b, seq_len=SEQ, buckets=(1, 2))
    np.testing.assert_array_equal(bp(u, y).pred_mean, wb(u, y).pred_mean)
    with pytest.raises(ValueError, match="leaf 0"):
        bp.reload_params(a.with_tensors([torch.zeros(2, dtype=torch.float64)]
                                        + a.tensors()[1:]))
    np.testing.assert_array_equal(bp(u, y).pred_mean, wb(u, y).pred_mean)
