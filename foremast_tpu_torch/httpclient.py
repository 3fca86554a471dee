"""A small HTTP/1.1 client over the standard library, with the session
seam the job store and the metric source call.

The JAX package's Elasticsearch store and Prometheus source talk through
a `requests.Session`; the card's machine has no `requests`, so the port
keeps the same seam on `http.client`: `get / put / post(url, json=,
data=, headers=, timeout=)` returning a response with `status_code`,
`ok`, `json()` and `raise_for_status()`. Tests inject their own session
object with that seam (an in-process fake Elasticsearch).

On the wire a call is what `requests` sends for it: the method, the
path and query as given, a `json=` body as `json.dumps(obj,
allow_nan=False)` in UTF-8 with `Content-Type: application/json`, a
`data=` body as given. Connections are kept alive per (scheme, host,
port) and a request that finds a pooled connection closed by the peer is
sent again once on a fresh one. Transport failures raise the builtin
`TimeoutError` or `ConnectionError` (the transient set of
`metrics.source._transient_exceptions`). One session may be shared
between threads, as a `requests.Session` is: each thread keeps its own
keep-alive connections, so two threads never interleave requests on one
connection (a sliced sweep's writer thread and the tick thread's nested
micro-tick share the job store's session).
"""

from __future__ import annotations

import base64
import http.client
import json as _json
import socket
import ssl
import string
import threading
from urllib.parse import quote, unquote, urlsplit

USER_AGENT = "foremast-tpu-torch"

_UNRESERVED = frozenset(string.ascii_letters + string.digits + "-._~")


def requote(target: str) -> str:
    """Percent-encode what may not stand in a request line, as `requests`
    does (`requests.utils.requote_uri`): escapes of unreserved
    characters are decoded, every other valid escape is kept, and the
    rest is quoted."""
    parts = target.split("%")
    out = [parts[0]]
    for h in parts[1:]:
        code = h[:2]
        if len(code) == 2 and all(c in string.hexdigits for c in code):
            c = chr(int(code, 16))
            out.append(c + h[2:] if c in _UNRESERVED else "%" + h)
        else:
            # not an escape: quote the lone '%' too
            return quote(target, safe="!#$&'()*+,/:;=?@[]~")
    return quote("".join(out), safe="!#$%&'()*+,/:;=?@[]~")


class HTTPError(RuntimeError):
    """A 4xx/5xx answer, raised by `Response.raise_for_status`; carries
    the response like `requests.HTTPError`."""

    def __init__(self, message: str, response: "Response"):
        super().__init__(message)
        self.response = response


class Response:
    def __init__(self, status_code: int, content: bytes, url: str):
        self.status_code = status_code
        self.content = content
        self.url = url

    @property
    def ok(self) -> bool:
        return self.status_code < 400

    def json(self):
        return _json.loads(self.content)

    def raise_for_status(self) -> None:
        if self.status_code >= 400:
            kind = "Client" if self.status_code < 500 else "Server"
            raise HTTPError(f"{self.status_code} {kind} Error for url: {self.url}", self)


class Session:
    """Keep-alive HTTP client; `headers` go with every request."""

    def __init__(self, headers: dict | None = None):
        self.headers = dict(headers or {})
        self._local = threading.local()

    @property
    def _conns(self) -> dict[tuple, http.client.HTTPConnection]:
        """This thread's keep-alive connections by (scheme, host, port)."""
        conns = getattr(self._local, "conns", None)
        if conns is None:
            conns = self._local.conns = {}
        return conns

    def get(self, url, **kw) -> Response:
        return self.request("GET", url, **kw)

    def put(self, url, **kw) -> Response:
        return self.request("PUT", url, **kw)

    def post(self, url, **kw) -> Response:
        return self.request("POST", url, **kw)

    def request(self, method, url, json=None, data=None, headers=None, timeout=None) -> Response:
        parts = urlsplit(url)
        if parts.scheme not in ("http", "https"):
            raise ValueError(f"unsupported URL scheme in {url!r}")
        target = requote((parts.path or "/") + (f"?{parts.query}" if parts.query else ""))
        hdrs = {
            "User-Agent": USER_AGENT,
            "Accept-Encoding": "identity",
            "Accept": "*/*",
            "Connection": "keep-alive",
        }
        if parts.username is not None:
            cred = f"{unquote(parts.username)}:{unquote(parts.password or '')}"
            hdrs["Authorization"] = "Basic " + base64.b64encode(cred.encode("latin-1")).decode()
        hdrs.update(self.headers)
        body = None
        if json is not None and not data:
            body = _json.dumps(json, allow_nan=False).encode("utf-8")
            hdrs["Content-Type"] = "application/json"
        elif data:
            body = data.encode("utf-8") if isinstance(data, str) else bytes(data)
        if body is not None or method in ("PUT", "POST"):
            hdrs["Content-Length"] = str(len(body or b""))
        hdrs.update(headers or {})
        key = (parts.scheme, parts.hostname, parts.port)
        for attempt in (0, 1):
            conn = self._conns.get(key)
            reused = conn is not None
            if conn is None:
                conn = self._connect(parts, timeout)
                self._conns[key] = conn
            conn.timeout = timeout
            if conn.sock is not None:
                conn.sock.settimeout(timeout)
            try:
                if conn.sock is None:
                    conn.connect()
                    # as urllib3: no Nagle delay between a request's
                    # segments and the peer's delayed ACK
                    conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                conn.request(method, target, body=body, headers=hdrs)
                resp = conn.getresponse()
                content = resp.read()
            except (socket.timeout, TimeoutError) as e:
                self._drop(key)
                raise TimeoutError(f"{method} {url}: timed out") from e
            except (http.client.RemoteDisconnected, BrokenPipeError, ConnectionResetError) as e:
                self._drop(key)
                if reused and attempt == 0:
                    continue  # the peer closed an idle pooled connection
                raise ConnectionError(f"{method} {url}: {type(e).__name__}: {e}") from e
            except (OSError, http.client.HTTPException) as e:
                self._drop(key)
                raise ConnectionError(f"{method} {url}: {type(e).__name__}: {e}") from e
            if resp.will_close:
                self._drop(key)
            return Response(resp.status, content, url)
        raise AssertionError("unreachable")  # pragma: no cover

    def _connect(self, parts, timeout) -> http.client.HTTPConnection:
        if parts.scheme == "https":
            return http.client.HTTPSConnection(
                parts.hostname, parts.port, timeout=timeout, context=ssl.create_default_context()
            )
        return http.client.HTTPConnection(parts.hostname, parts.port, timeout=timeout)

    def _drop(self, key) -> None:
        conn = self._conns.pop(key, None)
        if conn is not None:
            conn.close()
