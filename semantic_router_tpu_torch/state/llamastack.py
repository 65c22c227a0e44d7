"""Llama-Stack vector-store wire client + VectorStore backend.

The port's copy of ``semantic_router_tpu.state.llamastack``: the same
requests and payloads, so each package's client talks to the other's
``MiniLlamaStack``.

Reference: pkg/vectorstore/llama_stack_{backend,http,search}.go —
POST/GET/DELETE /v1/vector_stores, POST /v1/vector-io/insert,
POST /v1/vector_stores/{id}/search. Llama Stack searches by TEXT query
(the server owns embedding); hybrid mode adds RRF ranking_options and
skips score thresholds (RRF scores live on a ~0.001-0.05 scale where a
cosine threshold would drop everything — llama_stack_search.go:58-66).

Zero-dependency urllib client; ``MiniLlamaStack`` is the embedded test
double, embedding server-side through the ``embed_fn`` it is given (on
the card, the engine's embedding task through the flash-attention
kernel).
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
import uuid
from typing import Any, Callable, Dict, List, Optional

import numpy as np


class LlamaStackError(Exception):
    pass


class LlamaStackClient:
    def __init__(self, base_url: str, api_key: str = "",
                 timeout: float = 10.0) -> None:
        self.base_url = base_url.rstrip("/")
        self.api_key = api_key
        self.timeout = timeout

    def _request(self, method: str, path: str,
                 body: Optional[Dict] = None) -> Dict[str, Any]:
        req = urllib.request.Request(
            self.base_url + path,
            data=json.dumps(body).encode() if body is not None else None,
            method=method,
            headers={"content-type": "application/json",
                     **({"authorization": f"Bearer {self.api_key}"}
                        if self.api_key else {})})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                raw = r.read()
        except urllib.error.HTTPError as e:
            raise LlamaStackError(
                f"{method} {path} → {e.code}: "
                f"{e.read()[:300]!r}") from e
        except OSError as e:
            raise LlamaStackError(f"{method} {path}: {e}") from e
        return json.loads(raw) if raw else {}

    # -- vector store lifecycle -----------------------------------------

    def create_store(self, name: str,
                     metadata: Optional[Dict] = None) -> str:
        out = self._request("POST", "/v1/vector_stores",
                            {"name": name, "metadata": metadata or {}})
        return str(out.get("id", ""))

    def list_stores(self) -> List[Dict[str, Any]]:
        return list(self._request("GET", "/v1/vector_stores")
                    .get("data", []))

    def get_store(self, store_id: str) -> Dict[str, Any]:
        return self._request("GET", f"/v1/vector_stores/{store_id}")

    def delete_store(self, store_id: str) -> None:
        self._request("DELETE", f"/v1/vector_stores/{store_id}")

    def resolve_store_id(self, name_or_id: str) -> Optional[str]:
        """Accept either a raw store id or a human name
        (llama_stack_backend.go resolveStoreID)."""
        for s in self.list_stores():
            if s.get("id") == name_or_id or s.get("name") == name_or_id:
                return str(s["id"])
        return None

    # -- data ------------------------------------------------------------

    def insert_chunks(self, store_id: str,
                      chunks: List[Dict[str, Any]]) -> None:
        self._request("POST", "/v1/vector-io/insert",
                      {"vector_db_id": store_id, "chunks": chunks})

    def search(self, store_id: str, query_text: str, top_k: int = 5,
               hybrid: bool = False,
               file_id: str = "") -> List[Dict[str, Any]]:
        body: Dict[str, Any] = {"query": query_text,
                                "max_num_results": top_k}
        if hybrid:
            body["ranking_options"] = {"ranker": "rrf"}
        if file_id:
            body["filters"] = {"type": "eq", "key": "file_id",
                               "value": file_id}
        out = self._request("POST",
                            f"/v1/vector_stores/{store_id}/search", body)
        return list(out.get("data", []))


def _text_content(content: List[Dict[str, Any]]) -> str:
    return "".join(c.get("text", "") for c in content or []
                   if c.get("type") == "text")


class LlamaStackVectorStore:
    """VectorStore protocol over one Llama-Stack store (chunking
    client-side like the other backends; embedding server-side — the
    client ships text, llama-stack owns vectors)."""

    def __init__(self, client: LlamaStackClient, name: str,
                 embed_fn: Callable[[str], np.ndarray] = None,
                 search_type: str = "vector",
                 chunk_sentences: int = 5,
                 overlap_sentences: int = 1) -> None:
        self.client = client
        self.name = name
        # accepted for VectorStore-protocol symmetry; llama-stack owns
        # embeddings server-side so this never computes vectors here
        self.embed_fn = embed_fn
        self.search_type = search_type
        self.chunk_sentences = chunk_sentences
        self.overlap_sentences = overlap_sentences
        self.store_id = client.resolve_store_id(name) or \
            client.create_store(name)

    def ingest(self, name: str, text: str,
               metadata: Optional[Dict[str, str]] = None):
        from ..vectorstore.store import Document, chunk_text

        doc = Document(id=uuid.uuid4().hex[:12], name=name, text=text,
                       metadata=dict(metadata or {}))
        chunks = []
        for i, piece in enumerate(chunk_text(text, self.chunk_sentences,
                                             self.overlap_sentences)):
            cid = uuid.uuid4().hex
            doc.chunk_ids.append(cid)
            chunks.append({
                "content": piece,
                "chunk_id": cid,
                "metadata": {**doc.metadata, "document_id": doc.id,
                             "document_name": name, "index": i,
                             "file_id": doc.id}})
        if chunks:
            self.client.insert_chunks(self.store_id, chunks)
        return doc

    def search(self, query: str, top_k: int = 5, threshold: float = 0.0,
               hybrid: bool = True):
        from ..vectorstore.store import Chunk, SearchHit

        # hybrid requires BOTH the store to be configured for it (the
        # server needs an RRF-capable provider) and the caller to ask —
        # hybrid=False on a hybrid store degrades to vector search with
        # normal cosine thresholding, matching the other backends
        use_hybrid = self.search_type == "hybrid" and hybrid
        hits = self.client.search(
            self.store_id, query, top_k=top_k, hybrid=use_hybrid)
        out = []
        for h in hits:
            score = float(h.get("score", 0.0))
            # RRF scores are not cosine-comparable — only threshold in
            # pure vector mode (llama_stack_search.go:58-66)
            if not use_hybrid and score < threshold:
                continue
            meta = dict(h.get("metadata", h.get("attributes", {})) or {})
            chunk = Chunk(
                id=str(h.get("chunk_id", meta.get("chunk_id", ""))),
                document_id=str(h.get("file_id",
                                      meta.get("document_id", ""))),
                text=_text_content(h.get("content")) or h.get("text", ""),
                index=int(meta.get("index", 0)),
                metadata={k: v for k, v in meta.items()
                          if k not in ("document_id", "document_name",
                                       "index", "file_id", "chunk_id")})
            out.append(SearchHit(chunk, score, score, 0.0))
        return out

    def delete_document(self, document_id: str) -> bool:
        try:
            self.client._request(
                "DELETE",
                f"/v1/vector_stores/{self.store_id}/files/{document_id}")
            return True
        except LlamaStackError:
            return False

    def stats(self) -> Dict[str, int]:
        info = self.client.get_store(self.store_id)
        counts = info.get("file_counts", {})
        return {"documents": int(counts.get("total", 0)),
                "chunks": int(info.get("chunk_count", 0))}


class MiniLlamaStack:
    """Embedded llama-stack vector-io test double: the subset of the API
    the client speaks, with server-side embedding via ``embed_fn`` (the
    real server owns embeddings too)."""

    def __init__(self, embed_fn: Callable[[str], np.ndarray],
                 port: int = 0) -> None:
        from ..router.httpserver import PooledHTTPServer
        from http.server import BaseHTTPRequestHandler

        mini = self
        self.embed_fn = embed_fn
        self.stores: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _json(self, status: int, payload: Dict) -> None:
                raw = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("content-type", "application/json")
                self.send_header("content-length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

            def _body(self) -> Dict:
                n = int(self.headers.get("content-length", 0) or 0)
                return json.loads(self.rfile.read(n) or b"{}")

            def do_POST(self):
                mini.handle(self, "POST")

            def do_GET(self):
                mini.handle(self, "GET")

            def do_DELETE(self):
                mini.handle(self, "DELETE")

        self.httpd = PooledHTTPServer(("127.0.0.1", port), Handler,
                                      max_workers=8)
        self.port = self.httpd.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MiniLlamaStack":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()

    # -- request handling -------------------------------------------------

    def handle(self, h, method: str) -> None:
        path = h.path.split("?")[0]
        parts = [p for p in path.split("/") if p]
        try:
            if parts[:2] == ["v1", "vector_stores"]:
                if method == "POST" and len(parts) == 2:
                    body = h._body()
                    sid = "vs_" + uuid.uuid4().hex[:10]
                    with self._lock:
                        self.stores[sid] = {"id": sid,
                                            "name": body.get("name", ""),
                                            "chunks": []}
                    return h._json(200, {"id": sid,
                                         "name": body.get("name", "")})
                if method == "GET" and len(parts) == 2:
                    with self._lock:
                        data = [{"id": s["id"], "name": s["name"]}
                                for s in self.stores.values()]
                    return h._json(200, {"data": data})
                sid = parts[2] if len(parts) > 2 else ""
                store = self.stores.get(sid)
                if store is None:
                    return h._json(404, {"error": "no such store"})
                if method == "GET" and len(parts) == 3:
                    files = {c["metadata"].get("file_id")
                             for c in store["chunks"]}
                    return h._json(200, {
                        "id": sid, "name": store["name"],
                        "file_counts": {"total": len(files - {None})},
                        "chunk_count": len(store["chunks"])})
                if method == "DELETE" and len(parts) == 3:
                    with self._lock:
                        self.stores.pop(sid, None)
                    return h._json(200, {"deleted": True})
                if method == "DELETE" and len(parts) == 5 \
                        and parts[3] == "files":
                    fid = parts[4]
                    with self._lock:
                        store["chunks"] = [
                            c for c in store["chunks"]
                            if c["metadata"].get("file_id") != fid]
                    return h._json(200, {"deleted": True})
                if method == "POST" and len(parts) == 4 \
                        and parts[3] == "search":
                    return self._search(h, store)
            if parts == ["v1", "vector-io", "insert"] and method == "POST":
                body = h._body()
                store = self.stores.get(body.get("vector_db_id", ""))
                if store is None:
                    return h._json(404, {"error": "no such store"})
                with self._lock:
                    for c in body.get("chunks", []):
                        emb = np.asarray(self.embed_fn(
                            c.get("content", "")), np.float32)
                        store["chunks"].append({
                            "content": c.get("content", ""),
                            "chunk_id": c.get("chunk_id", ""),
                            "metadata": dict(c.get("metadata", {})),
                            "embedding": emb})
                return h._json(200, {"ok": True})
            h._json(404, {"error": f"unknown route {method} {path}"})
        except Exception as e:  # a test double must answer, not hang
            h._json(500, {"error": str(e)})

    def _search(self, h, store) -> None:
        body = h._body()
        q = np.asarray(self.embed_fn(body.get("query", "")), np.float32)
        flt = body.get("filters") or {}
        hits = []
        for c in store["chunks"]:
            if flt and flt.get("type") == "eq":
                if c["metadata"].get(flt.get("key")) != flt.get("value"):
                    continue
            emb = c["embedding"]
            denom = float(np.linalg.norm(q) * np.linalg.norm(emb)) or 1e-9
            score = float(q @ emb / denom)
            hits.append((score, c))
        hits.sort(key=lambda x: -x[0])
        k = int(body.get("max_num_results", 5))
        if (body.get("ranking_options") or {}).get("ranker") == "rrf":
            data = [{"content": [{"type": "text", "text": c["content"]}],
                     "chunk_id": c["chunk_id"],
                     "file_id": c["metadata"].get("file_id", ""),
                     "metadata": c["metadata"],
                     "score": 1.0 / (60 + rank)}
                    for rank, (s, c) in enumerate(hits[:k], start=1)]
        else:
            data = [{"content": [{"type": "text", "text": c["content"]}],
                     "chunk_id": c["chunk_id"],
                     "file_id": c["metadata"].get("file_id", ""),
                     "metadata": c["metadata"],
                     "score": s}
                    for s, c in hits[:k]]
        h._json(200, {"data": data})
