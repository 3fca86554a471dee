"""Loopback fakes of the worker's two dependencies, free of JAX: an
Elasticsearch `documents` index and a Prometheus `query_range` endpoint,
each behind a real HTTP socket on 127.0.0.1.

`FakeElasticsearch` serves the subset of the REST API the job store uses
(the root ping, index creation with mappings, `_mapping`, `_doc` GET/PUT
with `op_type=create` and seq_no CAS, `_search` with the claim query's
terms / bool / range / sort, `_bulk` with per-item CAS, `_count`), with
the mapping-strict query checks of `tests/test_es_store.py`'s `FakeES`.
`FakePrometheus` answers `GET <path>?<query>` with the series registered
under that exact path and query, as a `matrix` result of string values,
and counts requests by path. `put_grid` registers a series of values on
a grid, encoded from a table of the grid's values (phase 13's fleet of
1,024 distinct histories, under the URLs the watch plane's Barrelman
builds).

Used by the port's CLI worker test, its dashboard tests and
`chip_smoke.py` phases 9, 13 and 14; the port's HTTP store and source,
and the dashboard through the gateway's query proxy, are the clients."""

from __future__ import annotations

import bisect
import json
import re
import threading
import urllib.parse
from collections import Counter
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


class FakeElasticsearch:
    """`documents` with seq_no versioning; every method returns (status,
    body). `writes[id]` counts the writes of each document."""

    def __init__(self):
        self.docs: dict[str, dict] = {}  # id -> {"_source": ..., "_seq_no": int}
        self.mappings: dict | None = None
        self.writes: Counter = Counter()
        self._seq = 0
        self.lock = threading.Lock()

    # -- fixtures ---------------------------------------------------------

    def load(self, sources: list[dict], modified_at: str = "2000-01-01T00:00:00Z") -> None:
        """Put documents (JSON form) straight into the index, stamped
        `modified_at` so they sort before anything a worker writes."""
        with self.lock:
            for src in sources:
                src = dict(src, modifiedAt=modified_at)
                self._seq += 1
                self.docs[src["id"]] = {"_source": src, "_seq_no": self._seq}

    def sources(self) -> dict[str, dict]:
        with self.lock:
            return {k: dict(r["_source"]) for k, r in self.docs.items()}

    def set_status(self, status: str | None, modified_at: str = "2000-01-01T00:00:00Z") -> None:
        """Give every document `status` (None keeps each one's) and the
        stamp `modified_at`: the fleet as if last written long ago, so a
        claim's oldest-first page holds every document before any the
        next worker writes."""
        with self.lock:
            for rec in self.docs.values():
                self._seq += 1
                src = dict(rec["_source"], modifiedAt=modified_at)
                if status is not None:
                    src["status"] = status
                rec["_source"] = src
                rec["_seq_no"] = self._seq

    # -- REST -------------------------------------------------------------

    def _type(self, field: str) -> str | None:
        return ((self.mappings or {}).get("properties", {}).get(field) or {}).get("type")

    def handle(self, method: str, target: str, body: bytes, content_type: str):
        u = urllib.parse.urlsplit(target)
        path, q = u.path, urllib.parse.parse_qs(u.query)
        if method == "GET" and path in ("", "/"):
            return 200, {"cluster_name": "fake", "version": {"number": "7.10.2"}}
        if path == "/documents" and method == "PUT":
            if self.mappings is not None:
                return 400, {"error": {"type": "resource_already_exists_exception",
                                       "reason": "resource_already_exists_exception"}}
            self.mappings = json.loads(body).get("mappings", {})
            return 200, {"acknowledged": True}
        if self.mappings is None:
            return 404, {"error": {"type": "index_not_found_exception"}}
        if path == "/documents/_mapping":
            if method == "GET":
                return 200, {"documents": {"mappings": self.mappings}}
            self.mappings.setdefault("properties", {}).update(json.loads(body).get("properties", {}))
            return 200, {"acknowledged": True}
        m = re.fullmatch(r"/documents/_doc/([^/]+)", path)
        if m:
            doc_id = urllib.parse.unquote(m.group(1))
            rec = self.docs.get(doc_id)
            if method == "GET":
                if rec is None:
                    return 404, {"found": False}
                return 200, {"found": True, "_id": doc_id, "_source": rec["_source"]}
            if q.get("op_type") == ["create"] and rec is not None:
                return 409, {"error": "version_conflict_engine_exception"}
            if "if_seq_no" in q and (rec is None or rec["_seq_no"] != int(q["if_seq_no"][0])):
                return 409, {"error": "version_conflict_engine_exception"}
            self._write(doc_id, json.loads(body))
            return 200, {"result": "updated"}
        if path == "/documents/_bulk":
            if content_type != "application/x-ndjson":
                return 406, {"error": f"bulk needs application/x-ndjson, got {content_type!r}"}
            return self._bulk(body.decode())
        if path == "/documents/_count":
            query = json.loads(body).get("query", {})
            return 200, {"count": sum(self._matches(query, r["_source"]) for r in self.docs.values())}
        if path == "/documents/_search":
            return self._search(json.loads(body))
        return 404, {"error": f"no route {method} {path}"}

    def _write(self, doc_id: str, source: dict) -> None:
        self._seq += 1
        self.docs[doc_id] = {"_source": source, "_seq_no": self._seq}
        self.writes[doc_id] += 1

    def _bulk(self, data: str):
        lines = [ln for ln in data.split("\n") if ln.strip()]
        items, errors = [], False
        for action_ln, doc_ln in zip(lines[0::2], lines[1::2]):
            action = json.loads(action_ln)["index"]
            doc_id = action["_id"]
            rec = self.docs.get(doc_id)
            if "if_seq_no" in action and (rec is None or rec["_seq_no"] != action["if_seq_no"]):
                items.append({"index": {"_id": doc_id, "status": 409}})
                errors = True
                continue
            self._write(doc_id, json.loads(doc_ln))
            items.append({"index": {"_id": doc_id, "status": 200}})
        return 200, {"items": items, "errors": errors}

    def _search(self, req: dict):
        query = req.get("query", {})
        err = self._invalid(query)
        for spec in req.get("sort", []):
            ((field, _),) = spec.items()
            if err is None and self._type(field) != "date":
                err = f"sort on non-date field {field!r}"
        if err is not None:
            return 400, {"error": {"type": "search_phase_execution_exception", "reason": err}}
        hits = [
            {"_id": k, "_source": r["_source"], "_seq_no": r["_seq_no"], "_primary_term": 1}
            for k, r in self.docs.items()
            if self._matches(query, r["_source"])
        ]
        for spec in req.get("sort", []):
            ((field, opts),) = spec.items()
            hits.sort(key=lambda h: h["_source"].get(field, ""), reverse=opts.get("order") == "desc")
        return 200, {"hits": {"total": {"value": len(hits)}, "hits": hits[: req.get("size", 10)]}}

    def _invalid(self, query: dict) -> str | None:
        """Query shapes dynamic mapping would not support: exact `terms`
        need an explicit keyword field, `range` a date."""
        if "terms" in query:
            ((field, _),) = query["terms"].items()
            if self._type(field) != "keyword":
                return f"terms on non-keyword field {field!r}"
        if "range" in query:
            ((field, _),) = query["range"].items()
            if self._type(field) != "date":
                return f"range on non-date field {field!r}"
        if "bool" in query:
            b = query["bool"]
            subs = [*b.get("must", []), *b.get("should", [])]
            if "must_not" in b:
                subs.append(b["must_not"])
            for sub in subs:
                err = self._invalid(sub)
                if err:
                    return err
        return None

    @classmethod
    def _matches(cls, query: dict, source: dict) -> bool:
        if "terms" in query:
            ((field, values),) = query["terms"].items()
            return source.get(field) in values
        if "range" in query:
            ((field, cond),) = query["range"].items()
            value = source.get(field, "")
            return ("lt" not in cond or value < cond["lt"]) and ("gt" not in cond or value > cond["gt"])
        if "bool" in query:
            b = query["bool"]
            ok = all(cls._matches(s, source) for s in b.get("must", []))
            if "should" in b:
                ok = ok and any(cls._matches(s, source) for s in b["should"])
            if "must_not" in b:
                ok = ok and not cls._matches(b["must_not"], source)
            return ok
        return True


# an exposition sample `name{labels} value [timestamp]`, and a selector
_SAMPLE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)(?: \S+)?$')
_SAMPLE_NAME = re.compile(r'([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?')
_LABEL = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def _unescape(v: str) -> str:
    return re.sub(r'\\(.)', lambda m: "\n" if m.group(1) == "n" else m.group(1), v)


class FakePrometheus:
    """`query_range` answers from `data`: "<path>?<query>" -> (times,
    values). `faults[key]` is a list of statuses to answer (in order)
    before the real body; `split` > 1 spreads each answer over that many
    series (the source sums them per timestamp). Unknown keys answer an
    empty matrix. `prepare()` encodes every answer up front (set-up,
    not serving time); change a series through `set_series` then.

    It also keeps scraped samples, as a Prometheus server does: `scrape`
    stores an exposition's samples at a time, `put_samples` a series.
    A `query_range` whose exact key is not registered is then evaluated
    over them: its query a selector `name{label="value",...}`, each
    matching series answered at start, start + step, ... end with its
    last sample at or before that time (at most `LOOKBACK` seconds
    before it, Prometheus' staleness)."""

    LOOKBACK = 300.0

    def __init__(self, data: dict | None = None, split: int = 1):
        self.data = dict(data or {})
        self.split = split
        self.faults: dict[str, list[int]] = {}
        self.requests: Counter = Counter()  # path -> count
        self.lock = threading.Lock()
        self._pre: dict = {}
        self._bodies: dict[str, bytes] = {}
        self.samples: dict[tuple, tuple[list, list]] = {}  # (name, sorted label items) -> (times, values)

    # -- scraped samples --------------------------------------------------

    def put_samples(self, name: str, labels: dict, t, v) -> None:
        """Append a series' samples (times ascending, after any it has)."""
        with self.lock:
            ts, vs = self.samples.setdefault((name, tuple(sorted(labels.items()))), ([], []))
            ts.extend(float(x) for x in np.asarray(t).tolist())
            vs.extend(float(x) for x in np.asarray(v).tolist())

    def scrape(self, text: str, t: float) -> int:
        """Store every sample of an exposition at time `t`; the count."""
        n = 0
        for line in text.splitlines():
            m = _SAMPLE.match(line) if line and not line.startswith("#") else None
            if m is not None:
                labels = {k: _unescape(v) for k, v in _LABEL.findall(m.group(2) or "")}
                self.put_samples(m.group(1), labels, [t], [float(m.group(3))])
                n += 1
        return n

    def evaluate(self, query: str, start: float, end: float, step: float) -> list:
        """The matrix result of a bare selector over the stored samples."""
        m = _SAMPLE_NAME.fullmatch(query.strip())
        if m is None or step <= 0:
            return []
        want = {k: _unescape(v) for k, v in _LABEL.findall(m.group(2) or "")}
        grid = [start + k * step for k in range(int((end - start) // step) + 1)]
        with self.lock:
            items = [(key, list(ts), list(vs)) for key, (ts, vs) in self.samples.items() if key[0] == m.group(1)]
        out = []
        for (name, labels), ts, vs in items:
            lab = dict(labels)
            if any(lab.get(k) != v for k, v in want.items()):
                continue
            values = []
            for at in grid:
                i = bisect.bisect_right(ts, at) - 1
                if i >= 0 and at - ts[i] <= self.LOOKBACK:
                    values.append([int(at) if float(at).is_integer() else at, repr(vs[i])])
            if values:
                out.append({"metric": {"__name__": name, **lab}, "values": values})
        return out

    def put_grid(self, key: str, t, codes, denom: int = 64) -> None:
        """Answer `key` with the series (t, codes / denom): integer codes
        on a 1/denom grid, encoded from a table of the grid's values (a
        fleet of distinct rows encodes in a fraction of `body`'s time).
        The bytes equal `body`'s for that series."""
        codes = np.asarray(codes, np.int64)
        self.data[key] = (t, (codes / denom).astype(np.float32))
        if self.split != 1 or not len(codes):
            self._bodies[key] = self.body(key)
            return
        lo = int(codes.min())
        table = [repr(k / denom) + '"],' for k in range(lo, int(codes.max()) + 1)]
        parts = [None] * (2 * len(codes))
        parts[0::2] = self._prefixes(t)
        parts[1::2] = [table[k - lo] for k in codes.tolist()]
        pts = "".join(parts)[:-1]
        self._bodies[key] = ('{"status":"success","data":{"resultType":"matrix","result":[{"metric":{"series":"0"},'
                             '"values":[' + pts + "]}]}}").encode()

    def prepare(self) -> None:
        self._bodies = {key: self.body(key) for key in self.data}

    def set_series(self, key: str, series) -> None:
        self.data[key] = series
        if self._bodies:
            self._bodies[key] = self.body(key)

    def body(self, key: str) -> bytes:
        series = self.data.get(key)
        result = []
        if series is not None:
            t, v = series
            pre = self._prefixes(t)
            vals = list(map(repr, np.asarray(v, np.float64).tolist()))
            for s in range(self.split):
                # the first series carries the value, the others zeros,
                # so the sum per timestamp is the value itself
                pts = '"],'.join(map(str.__add__, pre, vals if s == 0 else ["0.0"] * len(vals)))
                result.append(f'{{"metric":{{"series":"{s}"}},"values":[{pts}"]' + "]}" if pre else
                              f'{{"metric":{{"series":"{s}"}},"values":[]}}')
        return ('{"status":"success","data":{"resultType":"matrix","result":[' + ",".join(result) + "]}}").encode()

    def _prefixes(self, t) -> list[str]:
        """'[<t>,"' per timestamp, cached per times array (a fleet's
        histories share one)."""
        key = id(t)
        hit = self._pre.get(key)
        if hit is None or hit[0] is not t:
            hit = self._pre[key] = (t, [f'[{ti},"' for ti in np.asarray(t).tolist()])
        return hit[1]

    def handle(self, target: str):
        u = urllib.parse.urlsplit(target)
        key = f"{u.path}?{u.query}"
        with self.lock:
            self.requests[u.path] += 1
            pending = self.faults.get(key)
            status = pending.pop(0) if pending else None
        if status is not None:
            return status, json.dumps({"status": "error", "error": f"injected {status}"}).encode()
        cached = self._bodies.get(key)
        if cached is None and key not in self.data and u.path == "/api/v1/query_range" and self.samples:
            q = dict(urllib.parse.parse_qsl(u.query))
            try:
                result = self.evaluate(q.get("query", ""), float(q["start"]), float(q["end"]), float(q["step"]))
            except (KeyError, ValueError):
                return 400, json.dumps({"status": "error", "error": "bad start/end/step"}).encode()
            return 200, json.dumps({"status": "success", "data": {"resultType": "matrix", "result": result}}).encode()
        return 200, cached if cached is not None else self.body(key)


def _serve(handle) -> tuple[ThreadingHTTPServer, str]:
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # keep-alive, as a real server
        disable_nagle_algorithm = True  # headers and body go out at once

        def log_message(self, *a):
            pass

        def _reply(self, status: int, payload: bytes):
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def _dispatch(self, method: str):
            n = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(n) if n else b""
            self._reply(*handle(method, self.path, raw, self.headers.get("Content-Type") or ""))

        def do_GET(self):
            self._dispatch("GET")

        def do_PUT(self):
            self._dispatch("PUT")

        def do_POST(self):
            self._dispatch("POST")

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def serve_fake_es(fake: FakeElasticsearch | None = None):
    """(server, fake, base URL): the fake index behind a loopback socket.
    Stop it with `server.shutdown(); server.server_close()`."""
    fake = fake or FakeElasticsearch()

    def handle(method, target, raw, content_type):
        with fake.lock:
            status, body = fake.handle(method, target, raw, content_type.split(";")[0].strip())
        return status, json.dumps(body).encode()

    srv, url = _serve(handle)
    return srv, fake, url


def serve_fake_prometheus(fake: FakePrometheus):
    """(server, base URL) for the fake `query_range` endpoint."""
    srv, url = _serve(lambda method, target, raw, content_type: fake.handle(target))
    return srv, url


def rebase(docs: list[dict], data: dict, old: str, base: str):
    """The fleet's documents and series with every URL prefix `old`
    replaced by `base`, and `data` re-keyed by "<path>?<query>" for
    `FakePrometheus`."""
    fields = ("currentConfig", "baselineConfig", "historicalConfig")
    docs = [dict(d, **{f: d[f].replace(old, base) for f in fields if d.get(f)}) for d in docs]
    keyed = {}
    for url, series in data.items():
        u = urllib.parse.urlsplit(url)
        keyed[f"{u.path}?{u.query}"] = series
    return docs, keyed
