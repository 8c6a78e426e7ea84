"""Retrieval server + HTTP search tool for Search-R1-style agents.

The port's own copy of ``rlinf_tpu/agents/retrieval.py`` (pure Python).
Reference analog: the searchr1 retrieval stack — an external retrieval
service queried by ``AsyncSearchClient`` from ``SearchToolWorker``
(reference rlinf/agents/searchr1/search_tool_worker.py:66-150: top-k
documents formatted into the conversation). Here the service is a real
localhost HTTP server over an in-process BM25 index, and the agent-side
tool is a plain HTTP client — the same process boundary the reference has,
without assuming an external corpus deployment.
"""

from __future__ import annotations

import json
import math
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence, Tuple
from urllib.request import Request, urlopen


def _tokenize(text: str) -> List[str]:
    return re.findall(r"[a-z0-9]+", text.lower())


class BM25Index:
    """Okapi BM25 over a {doc_id: text} corpus (k1=1.5, b=0.75)."""

    def __init__(self, corpus: Dict[str, str], k1: float = 1.5,
                 b: float = 0.75):
        self.k1, self.b = k1, b
        self.ids = list(corpus.keys())
        self.texts = [corpus[i] for i in self.ids]
        self.docs = [_tokenize(t) for t in self.texts]
        self.doc_len = [len(d) for d in self.docs]
        self.avg_len = (sum(self.doc_len) / len(self.docs)) if self.docs else 0.0
        self.tf: List[Dict[str, int]] = []
        df: Dict[str, int] = {}
        for d in self.docs:
            counts: Dict[str, int] = {}
            for w in d:
                counts[w] = counts.get(w, 0) + 1
            self.tf.append(counts)
            for w in counts:
                df[w] = df.get(w, 0) + 1
        n = len(self.docs)
        self.idf = {
            w: math.log(1 + (n - c + 0.5) / (c + 0.5)) for w, c in df.items()
        }

    def search(self, query: str, topk: int = 3) -> List[Tuple[str, str, float]]:
        """-> [(doc_id, text, score)] best-first."""
        q = _tokenize(query)
        scores = []
        for i, counts in enumerate(self.tf):
            s = 0.0
            dl = self.doc_len[i] or 1
            for w in q:
                f = counts.get(w)
                if not f:
                    continue
                idf = self.idf.get(w, 0.0)
                s += idf * f * (self.k1 + 1) / (
                    f + self.k1 * (1 - self.b + self.b * dl / self.avg_len)
                )
            scores.append(s)
        order = sorted(range(len(scores)), key=lambda i: -scores[i])[:topk]
        return [(self.ids[i], self.texts[i], scores[i]) for i in order
                if scores[i] > 0.0]


class RetrievalServer:
    """Localhost HTTP retrieval service.

    POST /retrieve  {"query": str, "topk": int} ->
        {"documents": [...], "ids": [...], "scores": [...]}
    GET  /health -> {"ok": true, "num_docs": N}
    """

    def __init__(self, corpus: Dict[str, str], host: str = "127.0.0.1",
                 port: int = 0):
        self.index = BM25Index(corpus)
        index = self.index

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _json(self, code: int, body: dict):
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/health":
                    self._json(200, {"ok": True,
                                     "num_docs": len(index.ids)})
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/retrieve":
                    self._json(404, {"error": "not found"})
                    return
                n = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(n) or b"{}")
                    hits = index.search(
                        str(body.get("query", "")),
                        topk=int(body.get("topk", 3)),
                    )
                except Exception as e:  # noqa: BLE001
                    self._json(400, {"error": str(e)})
                    return
                self._json(200, {
                    "ids": [h[0] for h in hits],
                    "documents": [h[1] for h in hits],
                    "scores": [h[2] for h in hits],
                })

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self):
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=10)


class HTTPSearchTool:
    """Agent-side search tool over a retrieval endpoint (the reference's
    AsyncSearchClient + top-k document formatting,
    search_tool_worker.py:88-112)."""

    name = "search"

    def __init__(self, url: str, topk: int = 3, timeout_s: float = 10.0,
                 max_doc_chars: int = 400):
        self.url = url.rstrip("/")
        self.topk = topk
        self.timeout_s = timeout_s
        self.max_doc_chars = max_doc_chars

    def __call__(self, args: str) -> str:
        req = Request(
            self.url + "/retrieve",
            data=json.dumps({"query": args, "topk": self.topk}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urlopen(req, timeout=self.timeout_s) as resp:
            body = json.loads(resp.read())
        docs = body.get("documents", [])
        if not docs:
            return "no results"
        return "\n".join(
            f"Doc {i + 1}: {d[: self.max_doc_chars]}"
            for i, d in enumerate(docs)
        )
