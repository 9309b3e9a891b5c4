"""Reference HTTP transport for the port's serving stack (stdlib only;
port of ``cbfssm_tpu/serving_http.py``).

``http.server`` + ``json``, no third-party dependency: how a socket
layer plugs into :class:`~cbfssm_tpu_torch.serving.MicroBatcher`. A
deployment with its own gRPC/asyncio stack can treat it as documentation
that runs; one without can use it as it is
(``python -m cbfssm_tpu_torch serve <dir>``). The routes, status codes,
JSON field names and error strings are the JAX module's, so a client of
one talks to the other. Two servers share the plumbing:
:class:`PredictionServer` (free-running prediction through a
MicroBatcher) and :class:`FilterServer` (online-estimation sessions
through a :class:`~cbfssm_tpu_torch.serving.FilterBatcher` and a
FilterPool; see its docstring for the session routes). The predictor
routes:

  GET  /healthz     -> {"ok": true}
  GET  /v1/meta     -> model dims / seq_len / batching parameters
  GET  /v1/stats    -> MicroBatcher.stats() + transport counters
  GET  /metrics     -> the same counters, Prometheus text format
  POST /v1/predict  {"u": [[...] x T], "y": [[...] x T]}
                    -> {"pred_mean": [[...] x T], "pred_var": ...,
                        "internal_mean": ..., "internal_var": ...,
                        "sde": ..., "mse": float}
                    Content-Type application/x-npz switches both body
                    and reply to binary .npz (same fields; see
                    post_predict_npz).
  POST /v1/params   an .npz of parameter leaves p0..pN in the JAX
                    package's ``jax.tree_util`` flatten order and layout
                    (``serving.params_to_leaves``): hot-swaps the served
                    checkpoint. A body the JAX package's
                    ``post_params_npz`` wrote is accepted as it is.

Threading model: each connection runs on its own handler thread
(``ThreadingHTTPServer``) and blocks on its request's Future, while the
single MicroBatcher dispatcher thread coalesces concurrent requests into
batched dispatches and does all the device work (a FilterBatcher's
dispatcher for the FilterServer). Dispatch ``k`` draws its noise from
the generator seed ``serving.fold_seed(seed, k)``, pool tick ``t`` from
``fold_seed(seed, t)`` (the JAX package folds ``k`` or ``t`` into a
threefry key instead, so the two packages' replies differ in their
noise; their filter state snapshots restore into each other).

Not ported here: ``ExportedBatchPredictor`` (serving an exported
artifact, ROADMAP A5.4).
"""

from __future__ import annotations

import hmac
import json
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from cbfssm_tpu_torch.serving import (FilterBatcher, MicroBatcher, params_from_leaves,
                                      params_to_leaves)

# Request bodies larger than this are rejected with 413 instead of
# being buffered: a predict request is two [T, d] float arrays, so
# anything near this bound is malformed or hostile, not traffic.
MAX_BODY_BYTES = 64 << 20

# How long an error reply waits for a declared-but-stalled request body
# before abandoning the connection (keep-alive resync requires reading
# the body; a stalled client must not pin a handler thread for long).
DRAIN_TIMEOUT = 5.0

# How long an abandoned connection lingers half-closed, discarding the
# client's in-flight bytes, so close() doesn't RST away the reply.
LINGER_TIMEOUT = 1.0

# Binary body/reply format for float-array payloads (np.savez archive).
# Negotiated per request: a POST body with this Content-Type gets the
# mirrored binary reply; a GET with this in Accept gets a binary reply.
NPZ_CONTENT_TYPE = "application/x-npz"


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # The stdlib default listen backlog is 5. Clients that open their
    # connections near-simultaneously (a fleet ticking in lockstep) pile
    # up past it, sit in handshake limbo until the kernel's SYN-ACK
    # retries run out (~3 min) and then see ECONNRESET. Size the accept
    # queue for bursts instead.
    request_queue_size = 128
    # the server object that owns this listener; set right after
    # construction (handlers reach it as self.server.app)
    app: object


class _JSONHandler(BaseHTTPRequestHandler):
    """JSON-over-HTTP plumbing: body limits, drain and linger, the
    ``.npz`` codec, Bearer auth and ``/metrics``."""

    protocol_version = "HTTP/1.1"

    # Per-read socket timeout (stdlib: applied in setup()): bounds the
    # request-line/header reads, so an idle keep-alive connection is
    # reclaimed instead of pinning a handler thread forever. Handler
    # threads spend their long waits on batcher futures, not socket
    # reads, so this does NOT bound slow model dispatches.
    timeout = 120.0

    def parse_request(self):
        # one handler instance serves every request on a keep-alive
        # connection; the body-consumed flag is per-request state
        self._body_consumed = False
        self._abandoned_input = False
        return super().parse_request()

    # stdlib default logs every request to stderr; the app keeps
    # counters instead (GET /v1/stats)
    def log_message(self, *_args):
        pass

    def _send(self, code: int, obj, extra_headers=()) -> None:
        # Drain any unread request body FIRST (success paths too — a
        # keep-alive GET/DELETE carrying a payload would otherwise
        # desync the connection just like an error reply would), and
        # before the Connection header is decided, since an abandoned
        # drain flips close_connection.
        self._drain_body()
        # compact separators: responses are dominated by float arrays
        # (a 300-step predict reply is ~1 MB); the default ", " padding
        # is ~15% pure whitespace on the wire and host-CPU time to
        # produce — the transport's bottleneck on small hosts
        body = json.dumps(obj, separators=(",", ":")).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for name, value in extra_headers:
            self.send_header(name, value)
        if self.close_connection:
            # we will drop the socket after this reply (unreadable or
            # oversized body) — tell keep-alive clients, don't surprise
            # their next request
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def _drain_body(self) -> None:
        """Consume (or abandon) an unread request body before a reply.
        With HTTP/1.1 keep-alive, replying while body bytes sit unread
        on the socket would desync the connection: the next request
        would be parsed starting at the stale body bytes. Oversized,
        chunked, unreadable, or stalled (> ``DRAIN_TIMEOUT``) bodies
        drop the connection instead (with a lingering close, see
        :meth:`finish`)."""
        if self._body_consumed:
            return
        self._body_consumed = True
        if self.headers.get("Transfer-Encoding"):
            # we never parse chunked framing; the body's extent is
            # unknowable from Content-Length, so the connection can't
            # be resynced — drop it after the reply
            self._abandon_input()
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            self._abandon_input()
            return
        if length <= 0:
            return
        if length > MAX_BODY_BYTES:
            # don't buffer a hostile body just to keep the connection
            self._abandon_input()
            return
        # Bound the drain: a client that declared a body but stalls
        # sending it must not pin this thread past DRAIN_TIMEOUT —
        # pre-bound, N stalled connections pinned N threads.
        conn = self.connection
        prev_timeout = conn.gettimeout()
        deadline = time.monotonic() + DRAIN_TIMEOUT
        try:
            while length > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self._abandon_input()
                    return
                conn.settimeout(min(remaining, DRAIN_TIMEOUT))
                chunk = self.rfile.read(min(length, 1 << 20))
                if not chunk:
                    self.close_connection = True
                    return
                length -= len(chunk)
        except OSError:  # includes TimeoutError
            self._abandon_input()
        finally:
            try:
                conn.settimeout(prev_timeout)
            except OSError:
                pass

    def _abandon_input(self) -> None:
        """Mark the request body as unrecoverable: close after the
        reply, and linger on close so the reply survives (see
        :meth:`finish`)."""
        self.close_connection = True
        self._abandoned_input = True

    def finish(self):
        # flushes wfile (the reply is on the wire) and closes the
        # buffered file objects
        super().finish()
        if not getattr(self, "_abandoned_input", False):
            return
        # Lingering close: unread bytes sit in the kernel receive
        # buffer (oversized/chunked/stalled body we refused to drain).
        # A bare close() would turn into TCP RST, which can destroy the
        # in-flight error reply before the client reads it — the
        # client would see ECONNRESET instead of the 413/400
        # diagnostic. Half-close and discard the client's remaining
        # bytes for a bounded window first (the nginx lingering_close
        # strategy); the server's shutdown_request then closes cleanly.
        try:
            conn = self.connection
            conn.shutdown(socket.SHUT_WR)
            deadline = time.monotonic() + LINGER_TIMEOUT
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                conn.settimeout(remaining)
                if not conn.recv(1 << 16):
                    break  # client saw our FIN and closed: done
        except OSError:
            pass

    def _fail(self, code: int, msg: str, extra_headers=()) -> None:
        self.server.app._count("http_errors")
        self._send(code, {"error": msg}, extra_headers=extra_headers)

    def _require_auth(self) -> bool:
        """Bearer-token gate for the state-mutating and state-leaking
        routes (every POST / DELETE, and GET /v1/state). No-op unless the
        server was built with ``auth_token``: the loopback default needs
        none, a non-loopback bind should set one.
        Constant-time compare; replies 401 + WWW-Authenticate on
        mismatch and returns False (the caller returns immediately)."""
        token = self.server.app.auth_token
        if token is None:
            return True
        supplied = self.headers.get("Authorization", "")
        if hmac.compare_digest(
            supplied.encode(), f"Bearer {token}".encode()
        ):
            return True
        self._fail(
            401,
            "missing or invalid auth token "
            "(send 'Authorization: Bearer <token>')",
            extra_headers=(("WWW-Authenticate", "Bearer"),),
        )
        return False

    def _send_metrics(self) -> None:
        """GET /metrics: the app's stats() counters in the Prometheus
        text exposition format (text/plain; stdlib-only, so scrapers
        work against the reference transport without an adapter).
        Monotonic counts get the ``_total`` counter convention;
        occupancy/latency summaries are gauges."""
        self._drain_body()
        counters = {"requests", "batches", "errors", "http_requests",
                    "http_errors", "replay_steps", "coalesced_groups"}
        lines = []
        for key, val in sorted(self.server.app.stats().items()):
            if not isinstance(val, (int, float)):
                continue
            name = f"cbfssm_{key}"
            kind = "counter" if key in counters else "gauge"
            if kind == "counter":
                name += "_total"
            lines.append(f"# TYPE {name} {kind}")
            lines.append(f"{name} {float(val):g}")
        body = ("\n".join(lines) + "\n").encode()
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        if self.close_connection:
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self, empty_msg: str, limit: int = MAX_BODY_BYTES):
        """The raw request body as bytes, or None after a 400/413
        reply. The ONE place body framing is validated — both parsers
        (JSON and .npz) go through it, so the Transfer-Encoding
        rejection below cannot silently diverge between them.
        ``limit`` defaults to the predict-request cap; routes whose
        legitimate bodies scale with deployment size (the /v1/state
        fleet snapshot) pass their own bound.
        Chunked bodies are refused because reading Content-Length raw
        bytes from a chunked stream desyncs the keep-alive connection
        (residual chunk framing would be parsed as the next request
        line — CL.TE request smuggling behind a proxy)."""
        if self.headers.get("Transfer-Encoding"):
            self._fail(400, "chunked transfer encoding not supported; "
                            "send Content-Length")
            return None
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            self._fail(400, "bad Content-Length")
            return None
        if length <= 0:
            self._fail(400, empty_msg)
            return None
        if length > limit:
            self._fail(413, f"body {length} bytes exceeds {limit}")
            return None
        raw = self.rfile.read(length)
        self._body_consumed = True
        return raw

    def _read_json(self, limit: int = MAX_BODY_BYTES):
        """Parsed JSON object body, or None after a 400/413 reply."""
        raw = self._read_body("empty body (send a JSON object)", limit)
        if raw is None:
            return None
        try:
            req = json.loads(raw)
        except (json.JSONDecodeError, UnicodeDecodeError):
            self._fail(400, "body is not valid JSON")
            return None
        if not isinstance(req, dict):
            self._fail(400, "body must be a JSON object")
            return None
        return req

    def _read_npz(self, empty_msg: str, limit: int = MAX_BODY_BYTES):
        """Parsed ``{name: np.ndarray}`` from an .npz body, or None
        after a 400/413 reply. Binary alternative to the JSON body,
        whose host-side encode/decode of float arrays numpy's C
        serialization replaces. ``allow_pickle=False`` — object arrays
        in a hostile body must not execute anything, and the zip
        central directory's DECLARED uncompressed sizes are bounded
        before any member is materialized: MAX_BODY_BYTES caps only
        the wire bytes, and deflate reaches ~1000:1, so a 64 MB
        compressed bomb could otherwise demand ~64 GB of allocations
        (ZipExtFile stops at the declared size, so checking the
        declaration bounds the real materialization)."""
        import io
        import zipfile

        raw = self._read_body(empty_msg, limit)
        if raw is None:
            return None
        try:
            with zipfile.ZipFile(io.BytesIO(raw)) as zf:
                declared = sum(info.file_size for info in zf.infolist())
            if declared > limit:
                self._fail(413, f"npz decompresses to {declared} bytes, "
                                f"exceeds {limit}")
                return None
            with np.load(io.BytesIO(raw), allow_pickle=False) as z:
                return {k: z[k] for k in z.files}
        except (ValueError, OSError, zipfile.BadZipFile, KeyError,
                MemoryError):
            self._fail(400, "body is not a valid .npz archive")
            return None

    def _send_npz(self, arrays: dict) -> None:
        """Reply 200 with ``arrays`` packed as an .npz archive."""
        import io

        buf = io.BytesIO()
        np.savez(buf, **arrays)
        body = buf.getvalue()
        self._drain_body()
        self.send_response(200)
        self.send_header("Content-Type", NPZ_CONTENT_TYPE)
        self.send_header("Content-Length", str(len(body)))
        if self.close_connection:
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def _read_params_npz(self, template):
        """POST /v1/params body: an .npz of parameter leaves ``p0..pN``
        in the JAX package's ``jax.tree_util`` flatten order and layout
        (:func:`~cbfssm_tpu_torch.serving.params_to_leaves`), rebuilt
        into params shaped like ``template``. Binary-only by design:
        params are float arrays. Returns None after an error reply."""
        if not self._body_is_npz():
            self._fail(415, "params are binary: POST an "
                            f"{NPZ_CONTENT_TYPE} body with leaves "
                            "p0..pN (jax.tree_util flatten order)")
            return None
        req = self._read_npz("empty body (send an .npz with p0..pN)")
        if req is None:
            return None
        n_leaves = len(params_to_leaves(template))
        want = [f"p{i}" for i in range(n_leaves)]
        if set(req) != set(want):
            self._fail(400, f"params npz must contain exactly p0..p"
                            f"{n_leaves - 1}; got "
                            f"{sorted(req)[:6]}{'...' if len(req) > 6 else ''}")
            return None
        try:
            return params_from_leaves(template, [req[k] for k in want])
        except ValueError as e:  # a leaf of the wrong shape or dtype
            self._fail(400, str(e))
            return None

    def _body_is_npz(self) -> bool:
        return (self.headers.get("Content-Type", "")
                .split(";")[0].strip().lower() == NPZ_CONTENT_TYPE)

    def _accepts_npz(self) -> bool:
        # join ALL Accept field lines (RFC 9110 permits splitting
        # list-valued fields across header lines)
        accept = ",".join(self.headers.get_all("Accept") or [])
        best = None
        for part in accept.split(","):
            media, _, params = part.partition(";")
            if media.strip().lower() != NPZ_CONTENT_TYPE:
                continue
            q = 1.0
            for p in params.split(";"):
                k, _, v = p.strip().partition("=")
                if k.strip().lower() == "q":
                    try:
                        q = float(v.strip() or "0")
                    except ValueError:
                        q = 0.0  # malformed q: fall back to JSON
            best = q if best is None else max(best, q)
        # RFC 9110: q=0 means "explicitly not acceptable"; among
        # duplicate ranges the highest q wins
        return best is not None and best > 0.0


def post_predict_npz(base_url: str, u, y, timeout: float | None = None,
                     auth_token: str | None = None):
    """Client-side helper for the binary predict body: POST
    ``{u, y}`` as an .npz archive and parse the mirrored .npz reply
    into ``{field: np.ndarray}``. Exactly the JSON endpoint's numbers
    (pinned in tests) at a fraction of the host encode cost — use this
    from fleet clients with long sequences."""
    import io
    import urllib.request

    buf = io.BytesIO()
    np.savez(buf, u=np.asarray(u), y=np.asarray(y))
    req = urllib.request.Request(
        base_url.rstrip("/") + "/v1/predict", method="POST",
        data=buf.getvalue(),
    )
    req.add_header("Content-Type", NPZ_CONTENT_TYPE)
    if auth_token is not None:
        req.add_header("Authorization", f"Bearer {auth_token}")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        raw = r.read()
    with np.load(io.BytesIO(raw), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def get_state_npz(base_url: str, timeout: float | None = None,
                  auth_token: str | None = None) -> bytes:
    """Fetch a :class:`FilterServer`'s whole-fleet failover snapshot as
    an opaque binary blob (GET /v1/state with ``Accept:
    application/x-npz``). Pass it unchanged to :func:`post_state_npz` on
    a standby of either package; the binary form skips the JSON float
    text of the fleet ensemble."""
    import urllib.request

    req = urllib.request.Request(base_url.rstrip("/") + "/v1/state")
    req.add_header("Accept", NPZ_CONTENT_TYPE)
    if auth_token is not None:
        req.add_header("Authorization", f"Bearer {auth_token}")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        ctype = r.headers.get("Content-Type", "").split(";")[0].strip()
        if ctype.lower() != NPZ_CONTENT_TYPE:
            # a server (or a proxy) that ignores Accept replies JSON;
            # shipping that blob on would fail on the standby with a
            # misleading "not a valid .npz" 400
            raise RuntimeError(
                f"server returned {ctype or 'no Content-Type'} instead of "
                f"{NPZ_CONTENT_TYPE}; the primary does not support binary "
                "snapshots — fall back to the JSON /v1/state path")
        return r.read()


def post_state_npz(base_url: str, blob: bytes,
                   timeout: float | None = None,
                   auth_token: str | None = None) -> None:
    """Restore a :func:`get_state_npz` blob into a standby
    :class:`FilterServer` (POST /v1/state, binary body). Raises
    ``urllib.error.HTTPError`` on a rejected snapshot (400: shape or
    table mismatch with the standby's pool)."""
    import urllib.request

    req = urllib.request.Request(
        base_url.rstrip("/") + "/v1/state", method="POST", data=blob,
    )
    req.add_header("Content-Type", NPZ_CONTENT_TYPE)
    if auth_token is not None:
        req.add_header("Authorization", f"Bearer {auth_token}")
    with urllib.request.urlopen(req, timeout=timeout):
        pass


def post_params_npz(base_url: str, params, timeout: float | None = None,
                    auth_token: str | None = None) -> None:
    """Hot-swap a server's checkpoint: POST /v1/params with the params'
    leaves as an .npz (``p0..pN`` in the JAX package's flatten order and
    layout, :func:`~cbfssm_tpu_torch.serving.params_to_leaves`; a
    sequence of arrays already in that order is sent as it is), which a
    server of either package accepts, a :class:`FilterServer` too (its
    sessions keep their state). In-flight requests see the old or the
    new params, never a mix. Raises ``urllib.error.HTTPError`` on a
    rejected checkpoint (400: wrong shapes/dtypes/structure)."""
    import io
    import urllib.request

    leaves = params_to_leaves(params) if hasattr(params, "tensors") else list(params)
    buf = io.BytesIO()
    np.savez(buf, **{f"p{i}": np.asarray(leaf)
                     for i, leaf in enumerate(leaves)})
    req = urllib.request.Request(
        base_url.rstrip("/") + "/v1/params", method="POST",
        data=buf.getvalue(),
    )
    req.add_header("Content-Type", NPZ_CONTENT_TYPE)
    if auth_token is not None:
        req.add_header("Authorization", f"Bearer {auth_token}")
    with urllib.request.urlopen(req, timeout=timeout):
        pass


class _Handler(_JSONHandler):
    def do_GET(self):  # noqa: N802 (stdlib handler naming)
        app = self.server.app
        app._count("http_requests")
        if self.path == "/healthz":
            self._send(200, {"ok": True})
        elif self.path == "/v1/meta":
            self._send(200, app.meta())
        elif self.path == "/v1/stats":
            self._send(200, app.stats())
        elif self.path == "/metrics":
            self._send_metrics()
        else:
            self._fail(404, f"unknown path {self.path!r} "
                            "(try /healthz, /v1/meta, /v1/stats, /metrics)")

    def do_POST(self):  # noqa: N802
        app = self.server.app
        app._count("http_requests")
        if not self._require_auth():
            return
        if self.path == "/v1/params":
            # checkpoint hot-swap; a predictor without reload_params
            # (an exported artifact's) refuses
            pred = app.batcher.predictor
            if not hasattr(pred, "reload_params"):
                self._fail(400, "this server serves an exported "
                                "artifact; artifacts freeze "
                                "params+program — re-export and "
                                "restart (hot-swap is for "
                                "checkpoint-backed servers)")
                return
            tree = self._read_params_npz(pred.params)
            if tree is None:
                return
            try:
                # atomic reference swap: an in-flight dispatch sees the
                # old or the new checkpoint, never a torn mix
                pred.reload_params(tree)
            except ValueError as e:
                self._fail(400, str(e))
                return
            self._send(200, {"ok": True})
            return
        if self.path != "/v1/predict":
            self._fail(404, f"unknown path {self.path!r} "
                            "(try /v1/predict, /v1/params)")
            return
        # content negotiation: the reply format mirrors the body format
        binary = self._body_is_npz()
        req = (self._read_npz("empty body (send an .npz with 'u' and 'y')")
               if binary else self._read_json())
        if req is None:
            return
        try:
            u, y = req["u"], req["y"]
        except KeyError:
            self._fail(400, "npz body must contain 'u' and 'y' arrays"
                       if binary else
                       "body must be a JSON object with 'u' and 'y'")
            return
        try:
            u = np.asarray(u, dtype=app.np_dtype)
            y = np.asarray(y, dtype=app.np_dtype)
        except (ValueError, TypeError):
            self._fail(400, "'u'/'y' must be numeric [T, d] arrays")
            return
        try:
            fut = app.batcher.submit(u, y)
        except ValueError as e:  # shape mismatch — client error
            self._fail(400, str(e))
            return
        except RuntimeError as e:  # batcher closed — shutting down
            self._fail(503, str(e))
            return
        try:
            out = fut.result(timeout=app.request_timeout)
        except Exception as e:  # dispatch failed server-side
            self._fail(500, f"{type(e).__name__}: {e}")
            return
        if binary:
            arrays = {}
            for field in out.__dataclass_fields__:
                leaf = np.asarray(getattr(out, field))
                arrays[field] = leaf if leaf.ndim == 0 else leaf[0]
            self._send_npz(arrays)
            return
        resp = {}
        for field in out.__dataclass_fields__:
            leaf = np.asarray(getattr(out, field))
            # leaves are [1, T, d] row views; mse is scalar
            resp[field] = (
                float(leaf) if leaf.ndim == 0 else leaf[0].tolist()
            )
        self._send(200, resp)


class _ServerBase:
    """Listener lifecycle of :class:`PredictionServer` and
    :class:`FilterServer`: bind, transport counters, background/
    foreground serve, and the ordered shutdown (stop accepting first,
    then drain the batcher so in-flight futures resolve before handler
    threads are abandoned). Subclasses set ``_handler_cls`` /
    ``_thread_name`` and pass a batcher factory.
    """

    # abstract — subclasses must provide a handler with do_* methods
    # (bare _JSONHandler would 501 everything) and a thread name
    _handler_cls: type
    _thread_name: str
    # seconds between the serve loop's shutdown checks: close() waits up
    # to one of them (the stdlib default is 0.5)
    poll_interval = 0.1

    def __init__(self, host: str, port: int,
                 request_timeout: float | None, make_batcher,
                 auth_token: str | None = None):
        self.request_timeout = request_timeout
        # Shared secret for the mutating routes (_require_auth). None =
        # open (safe with the loopback default bind); set one for any
        # non-loopback bind.
        self.auth_token = auth_token
        # Bind BEFORE building the batcher: a failed bind (port already
        # in use) raises out of __init__ with no object to close(), so
        # nothing allocated-but-unowned may exist yet — the batcher
        # spawns a dispatcher thread.
        self._httpd = _HTTPServer((host, port), self._handler_cls)
        try:
            self.batcher = make_batcher()
        except BaseException:
            self._httpd.server_close()
            raise
        self._httpd.app = self
        self.host, self.port = self._httpd.server_address[:2]
        self._counters = {"http_requests": 0, "http_errors": 0}
        self._lock = threading.Lock()
        self._close_lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._served = False
        self._closed = False

    def _count(self, name: str) -> None:
        with self._lock:
            self._counters[name] += 1

    def stats(self) -> dict:
        s = self.batcher.stats()
        with self._lock:
            s.update(self._counters)
        return s

    def start(self) -> None:
        """Serve on a background thread (tests / embedding)."""
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._served = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, args=(self.poll_interval,),
            name=self._thread_name, daemon=True,
        )
        self._thread.start()

    def serve_forever(self) -> None:
        """Serve on the calling thread (the CLI path); returns after
        :meth:`close` (or raises KeyboardInterrupt through)."""
        self._served = True
        self._httpd.serve_forever(self.poll_interval)

    def close(self) -> None:
        # Serialize the whole teardown: two concurrent closers (e.g. a
        # signal handler plus a finally/__exit__) must not both run it,
        # and the loser must not return while the winner is still
        # mid-shutdown with the batcher undrained. Handler/dispatcher
        # threads never take this lock, so holding it across
        # shutdown/join/drain cannot deadlock.
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
            self._close_locked()

    def _close_locked(self) -> None:
        if self._served:
            # stop accepting; returns once the serve loop acknowledges.
            # Guarded: BaseServer.shutdown() waits on an event only
            # serve_forever's finally sets — calling it on a listener
            # whose loop never ran deadlocks.
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join()
        self.batcher.close()     # drain in-flight requests

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class PredictionServer(_ServerBase):
    """One listener + one :class:`MicroBatcher` around a batch
    predictor (:class:`~cbfssm_tpu_torch.serving.BucketedPredictor`
    over a trained checkpoint). Bodies are read in the model's numpy
    dtype, ``model.np_dtype`` (its ``dtype`` is a ``torch.dtype``).

    >>> pred = BucketedPredictor(model, params, seq_len=300)
    >>> with PredictionServer(pred, port=0) as srv:   # 0 = ephemeral
    ...     srv.start()                               # background thread
    ...     requests.post(f"http://{srv.host}:{srv.port}/v1/predict", ...)
    """

    _handler_cls = _Handler
    _thread_name = "cbfssm-http"

    def __init__(self, predictor, host: str = "127.0.0.1", port: int = 0,
                 *, max_batch: int = 32, max_wait_ms: float = 2.0,
                 queue_size: int = 1024, seed: int = 0,
                 request_timeout: float | None = None,
                 auth_token: str | None = None):
        self.np_dtype = np.dtype(predictor.model.np_dtype)
        super().__init__(host, port, request_timeout, lambda: MicroBatcher(
            predictor, max_batch=max_batch, max_wait_ms=max_wait_ms,
            queue_size=queue_size, seed=seed,
        ), auth_token=auth_token)

    def meta(self) -> dict:
        pred = self.batcher.predictor
        return {
            "predictor": type(pred).__name__,
            "seq_len": int(pred.seq_len),
            "dim_u": int(pred.model.dim_u),
            "dim_y": int(pred.model.dim_y),
            "dtype": self.np_dtype.name,
            "max_batch": self.batcher.max_batch,
            "max_wait_ms": self.batcher.max_wait * 1e3,
        }



class _FilterHandler(_JSONHandler):
    """Online-estimation session endpoints (see :class:`FilterServer`)."""

    def _route(self):
        """('sessions',) | ('session_op', sid, op) | None."""
        parts = self.path.rstrip("/").split("/")
        if parts[:3] == ["", "v1", "sessions"]:
            if len(parts) == 3:
                return ("sessions",)
            if len(parts) in (4, 5) and parts[3].isdigit():
                return ("session_op", int(parts[3]),
                        parts[4] if len(parts) == 5 else None)
        return None

    def do_GET(self):  # noqa: N802
        app = self.server.app
        app._count("http_requests")
        if self.path == "/healthz":
            self._send(200, {"ok": True})
        elif self.path == "/v1/meta":
            self._send(200, app.meta())
        elif self.path == "/v1/stats":
            self._send(200, app.stats())
        elif self.path == "/v1/state":
            # the snapshot holds the whole fleet's state: token-gated
            # like the mutating routes
            if not self._require_auth():
                return
            if self._accepts_npz():
                self._resolve(app.batcher.state,
                              encode=app._encode_state_npz, binary=True)
            else:
                self._resolve(app.batcher.state, encode=app._encode_state)
        elif self.path == "/metrics":
            self._send_metrics()
        else:
            self._fail(404, f"unknown path {self.path!r} (try /healthz, "
                            "/v1/meta, /v1/stats, /v1/state, /v1/sessions, "
                            "/metrics)")

    def do_DELETE(self):  # noqa: N802
        app = self.server.app
        app._count("http_requests")
        if not self._require_auth():
            return
        route = self._route()
        if not route or route[0] != "session_op" or route[2] is not None:
            self._fail(404, f"unknown path {self.path!r} "
                            "(try DELETE /v1/sessions/<sid>)")
            return
        self._resolve(app.batcher.detach, route[1],
                      encode=lambda _r: {"ok": True})

    def do_POST(self):  # noqa: N802
        app = self.server.app
        app._count("http_requests")
        if not self._require_auth():
            return
        if self.path == "/v1/params":
            # fleet checkpoint hot-swap: sessions keep their state; the
            # batcher lands the swap between dispatches
            tree = self._read_params_npz(app.batcher.pool.params)
            if tree is None:
                return
            self._resolve(app.batcher.reload_params, tree,
                          encode=lambda _r: {"ok": True})
            return
        if self.path == "/v1/state":
            binary = self._body_is_npz()
            # a fleet snapshot's size scales with the pool: the server's
            # own bound
            limit = app.state_body_limit
            req = (self._read_npz("empty body (send an .npz state "
                                  "snapshot)", limit)
                   if binary else self._read_json(limit))
            if req is None:
                return
            try:
                state = (app._decode_state_npz(req) if binary
                         else app._decode_state(req))
            except (KeyError, TypeError, ValueError, AttributeError) as e:
                # AttributeError: wrong-typed fields ("slots" a list)
                self._fail(400, f"bad state snapshot: {e}")
                return
            self._resolve(app.batcher.load_state, state,
                          encode=lambda _r: {"ok": True})
            return
        route = self._route()
        if route is None:
            self._fail(404, f"unknown path {self.path!r} (try "
                            "/v1/sessions[/<sid>/{step,forecast,replay}], "
                            "/v1/state, or /v1/params)")
            return
        req = self._read_json()
        if req is None:
            return
        if route[0] == "sessions":
            try:
                submit = app.batcher.attach(req["u_prefix"], req["y_prefix"])
            except KeyError:
                self._fail(400, "body needs 'u_prefix' and 'y_prefix'")
                return
            except (ValueError, TypeError) as e:
                self._fail(400, str(e))
                return
            except RuntimeError as e:  # closed
                self._fail(503, str(e))
                return
            self._resolve_fut(submit, encode=lambda sid: {"sid": sid})
            return
        _, sid, op = route
        fields = {"step": ("u_prev", "y_new"), "forecast": ("u_future",),
                  "replay": ("u", "y")}.get(op)
        if fields is None:
            self._fail(404, f"unknown session operation {op!r} "
                            "(try step, forecast, replay)")
            return
        try:
            args = [req[f] for f in fields]
        except KeyError:
            self._fail(400, f"body needs {' and '.join(repr(f) for f in fields)}")
            return
        self._resolve(getattr(app.batcher, op), sid, *args)

    def _resolve(self, submit_fn, *args, encode=None, binary=False):
        """Submit on the batcher, mapping submit-side errors to client
        codes, then block on the future."""
        try:
            fut = submit_fn(*args)
        except (ValueError, TypeError) as e:
            self._fail(400, str(e))
            return
        except RuntimeError as e:  # batcher closed
            self._fail(503, str(e))
            return
        self._resolve_fut(fut, encode=encode, binary=binary)

    def _resolve_fut(self, fut, encode=None, binary=False):
        app = self.server.app
        try:
            out = fut.result(timeout=app.request_timeout)
        except KeyError as e:  # unknown session at dispatch
            self._fail(404, str(e.args[0]) if e.args else "unknown session")
            return
        except RuntimeError as e:
            # pool full (attach) or closed before dispatch: retryable
            self._fail(503, str(e))
            return
        except ValueError as e:
            # content only the pool can judge (a snapshot of another
            # capacity): client-side and permanent, so 400, not 5xx
            self._fail(400, str(e))
            return
        except Exception as e:
            self._fail(500, f"{type(e).__name__}: {e}")
            return
        if binary:
            self._send_npz(encode(out))
        elif encode is not None:
            self._send(200, encode(out))
        else:  # (mean, var) numpy pairs from step / forecast / replay
            mean, var = out
            self._send(200, {"mean": np.asarray(mean).tolist(),
                             "var": np.asarray(var).tolist()})


class FilterServer(_ServerBase):
    """Online state estimation over HTTP: one listener + one
    :class:`~cbfssm_tpu_torch.serving.FilterBatcher` around a
    :class:`~cbfssm_tpu_torch.serving.FilterPool`.

    Each estimator drives its own session with JSON requests; concurrent
    step / forecast / replay requests of different sessions coalesce
    into single pool calls. Protocol (the JAX server's):

      POST   /v1/sessions                {"u_prefix": [[...] x R],
                                          "y_prefix": [[...] x R]}
                                         -> {"sid": n}
      POST   /v1/sessions/<sid>/step     {"u_prev": [du], "y_new": [dy]}
                                         -> {"mean": [dy], "var": [dy]}
      POST   /v1/sessions/<sid>/forecast {"u_future": [[...] x H]}
                                         -> {"mean"/"var": [[...] x H]}
      POST   /v1/sessions/<sid>/replay   {"u": [[...] x K], "y": ...}
                                         -> {"mean"/"var": [[...] x K]}
      DELETE /v1/sessions/<sid>          -> {"ok": true}
      GET    /v1/state                   -> whole-fleet failover snapshot
                                            (Accept: application/x-npz
                                            for the binary form)
      POST   /v1/state                   <- restore it (JSON or .npz)
      POST   /v1/params                  <- checkpoint hot-swap (.npz of
                                            leaves p0..pN; sessions keep
                                            their state)
      GET    /healthz | /v1/meta | /v1/stats | /metrics

    Errors: bad shapes or JSON 400, unknown session 404, oversized body
    413, pool full or shutting down 503. The snapshot is the pool's
    ``state`` (ensemble, tick, session table, base key uint32[2]); a
    standby of either package restores it, also one built with another
    seed. Use the binary form (:func:`get_state_npz` /
    :func:`post_state_npz`) for large fleets.
    """

    _handler_cls = _FilterHandler
    _thread_name = "cbfssm-filter-http"

    def __init__(self, pool, host: str = "127.0.0.1", port: int = 0,
                 *, max_wait_ms: float = 2.0, queue_size: int = 1024,
                 request_timeout: float | None = None,
                 auth_token: str | None = None):
        super().__init__(host, port, request_timeout, lambda: FilterBatcher(
            pool, max_wait_ms=max_wait_ms, queue_size=queue_size,
        ), auth_token=auth_token)

    @staticmethod
    def _encode_state(state) -> dict:
        x, tick, slots, next_sid, key = state
        x = np.asarray(x)
        key = np.asarray(key)
        return {
            "x": x.tolist(), "dtype": x.dtype.name, "tick": int(tick),
            "slots": {str(sid): int(slot) for sid, slot in slots.items()},
            "next_sid": int(next_sid),
            "key": key.tolist(), "key_dtype": key.dtype.name,
        }

    @staticmethod
    def _decode_state(obj):
        slots = {int(s): int(v) for s, v in obj["slots"].items()}
        if len(slots) != len(obj["slots"]):
            # int() aliases keys like "5" / "+5" onto one sid
            raise ValueError("duplicate session ids in snapshot")
        state = (
            np.asarray(obj["x"], dtype=np.dtype(obj["dtype"])),
            int(obj["tick"]),
            slots,
            int(obj["next_sid"]),
        )
        if "key" in obj:  # pre-key snapshots: 4-tuple keeps the pool's key
            state += (np.asarray(
                obj["key"], dtype=np.dtype(obj.get("key_dtype", "uint32"))
            ),)
        return state

    @staticmethod
    def _encode_state_npz(state) -> dict:
        """The snapshot as arrays for np.savez: the ensemble in its own
        dtype, the session table as two parallel int64 vectors."""
        x, tick, slots, next_sid, key = state
        n = len(slots)
        return {
            "x": np.asarray(x),
            "tick": np.int64(tick),
            "slot_sids": np.fromiter(slots.keys(), np.int64, count=n),
            "slot_rows": np.fromiter(slots.values(), np.int64, count=n),
            "next_sid": np.int64(next_sid),
            "base_key": np.asarray(key),
        }

    @staticmethod
    def _decode_state_npz(obj):
        sids = np.asarray(obj["slot_sids"], dtype=np.int64).ravel()
        rows = np.asarray(obj["slot_rows"], dtype=np.int64).ravel()
        if sids.shape != rows.shape:
            raise ValueError("slot_sids/slot_rows length mismatch")
        if len(np.unique(sids)) != len(sids):
            raise ValueError("duplicate session ids in snapshot")
        state = (
            np.asarray(obj["x"]),
            int(obj["tick"]),
            {int(s): int(v) for s, v in zip(sids, rows)},
            int(obj["next_sid"]),
        )
        if "base_key" in obj:  # pre-key snapshots keep the pool's key
            state += (np.asarray(obj["base_key"]),)
        return state

    @property
    def state_body_limit(self) -> int:
        """Body cap of POST /v1/state: the generic cap plus 8x the raw
        ensemble (capacity x S x dx), which bounds its JSON float text
        (~20 bytes a float) and its .npz with margin."""
        pool = self.batcher.pool
        m = pool.model
        raw = pool.capacity * int(m.samples) * int(m.dim_x) * m.np_dtype.itemsize
        return MAX_BODY_BYTES + 8 * raw

    def meta(self) -> dict:
        pool = self.batcher.pool
        model = pool.model
        return {
            "server": "FilterServer",
            "model": type(model).__name__,
            "capacity": pool.capacity,
            "active": pool.active,
            "recog_len": int(model.config.recog_len),
            "dim_u": int(model.dim_u),
            "dim_y": int(model.dim_y),
            "dtype": model.np_dtype.name,
            "max_wait_ms": self.batcher.max_wait * 1e3,
        }

    def stats(self) -> dict:
        s = super().stats()
        s["active_sessions"] = self.batcher.pool.active
        return s
