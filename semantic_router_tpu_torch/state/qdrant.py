"""Qdrant wire client (REST) + vector-store/memory backends over it.

The port's copy of ``semantic_router_tpu.state.qdrant``: the same
requests and payloads, so each package's client talks to the other's
``MiniQdrant``.

Reference: pkg/vectorstore qdrant backend + pkg/cache/qdrant_cache.go —
the external ANN store for vectorstore/memory/cache state.  This client
speaks Qdrant's public REST API with zero dependencies:

  PUT    /collections/{name}                  create (vector size+metric)
  DELETE /collections/{name}
  PUT    /collections/{name}/points           upsert points
  POST   /collections/{name}/points/search    ANN search
  POST   /collections/{name}/points/delete    delete by ids/filter
  POST   /collections/{name}/points/scroll    list points

``QdrantVectorStore`` implements the same protocol as
InMemoryVectorStore (ingest/search/delete_document) with chunking reused
from the in-proc store; vectors and payloads live server-side, so
replicas share state and restarts lose nothing.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
import uuid
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ..vectorstore.store import Chunk, Document, SearchHit, chunk_text


class QdrantError(Exception):
    pass


class QdrantClient:
    def __init__(self, base_url: str = "http://127.0.0.1:6333",
                 api_key: str = "", timeout_s: float = 30.0) -> None:
        self.base_url = base_url.rstrip("/")
        self.api_key = api_key
        self.timeout_s = timeout_s

    def _request(self, method: str, path: str,
                 body: Optional[Dict] = None) -> Dict:
        req = urllib.request.Request(
            self.base_url + path,
            data=json.dumps(body).encode() if body is not None else None,
            method=method)
        req.add_header("content-type", "application/json")
        if self.api_key:
            req.add_header("api-key", self.api_key)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                return json.loads(r.read() or b"{}")
        except urllib.error.HTTPError as e:
            raise QdrantError(
                f"{method} {path} -> {e.code}: "
                f"{e.read().decode()[:200]}")
        except Exception as exc:
            raise QdrantError(f"{method} {path} failed: {exc}")

    # -- collections ------------------------------------------------------

    def create_collection(self, name: str, vector_size: int,
                          distance: str = "Cosine") -> None:
        self._request("PUT", f"/collections/{name}", {
            "vectors": {"size": vector_size, "distance": distance}})

    def delete_collection(self, name: str) -> None:
        self._request("DELETE", f"/collections/{name}")

    def collection_exists(self, name: str) -> bool:
        try:
            self._request("GET", f"/collections/{name}")
            return True
        except QdrantError:
            return False

    # -- points -----------------------------------------------------------

    def upsert(self, collection: str, points: List[Dict]) -> None:
        """points: [{id, vector: [...], payload: {...}}]"""
        self._request("PUT", f"/collections/{collection}/points",
                      {"points": points})

    def search(self, collection: str, vector: Sequence[float],
               limit: int = 5, score_threshold: float = 0.0,
               query_filter: Optional[Dict] = None,
               with_vectors: bool = False) -> List[Dict]:
        body: Dict[str, Any] = {"vector": list(map(float, vector)),
                                "limit": limit, "with_payload": True}
        if with_vectors:
            body["with_vector"] = True
        if score_threshold:
            body["score_threshold"] = score_threshold
        if query_filter:
            body["filter"] = query_filter
        out = self._request("POST",
                            f"/collections/{collection}/points/search",
                            body)
        return out.get("result", [])

    def set_payload(self, collection: str, payload: Dict,
                    ids: List) -> None:
        """Merge payload fields into existing points (no vector write —
        the cheap access-stat update path)."""
        self._request("POST",
                      f"/collections/{collection}/points/payload",
                      {"payload": payload, "points": ids})

    def delete_points(self, collection: str,
                      ids: Optional[List] = None,
                      query_filter: Optional[Dict] = None) -> None:
        body: Dict[str, Any] = {}
        if ids is not None:
            body["points"] = ids
        if query_filter is not None:
            body["filter"] = query_filter
        self._request("POST", f"/collections/{collection}/points/delete",
                      body)

    def scroll(self, collection: str, limit: int = 100,
               query_filter: Optional[Dict] = None,
               max_total: int = 100_000) -> List[Dict]:
        """Follows next_page_offset so listings never silently truncate
        at one page (bounded by max_total as a runaway guard)."""
        points: List[Dict] = []
        offset = None
        while len(points) < max_total:
            body: Dict[str, Any] = {"limit": limit, "with_payload": True}
            if query_filter:
                body["filter"] = query_filter
            if offset is not None:
                body["offset"] = offset
            out = self._request(
                "POST", f"/collections/{collection}/points/scroll", body)
            result = out.get("result", {}) or {}
            page = result.get("points", [])
            points.extend(page)
            offset = result.get("next_page_offset")
            if offset is None or not page:
                break
        return points


def any_of_filter(field: str, values) -> Dict:
    """Filter matching any of ``values`` for ``field`` (Qdrant
    ``should`` clause — used for 'this category OR uncategorized')."""
    return {"should": [{"key": field, "match": {"value": v}}
                       for v in values]}


def match_filter(field: str, value) -> Dict:
    return {"must": [{"key": field, "match": {"value": value}}]}


class MiniQdrant:
    """Embedded Qdrant-REST stand-in (the MiniRedis counterpart): the
    public API subset over real HTTP with in-memory cosine search.  Backs
    tests and single-node dev; the client cannot tell the difference for
    the operations the framework uses."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        import threading
        from http.server import (
            BaseHTTPRequestHandler,
            ThreadingHTTPServer,
        )

        store = self
        self._collections: Dict[str, Dict] = {}  # name → {size, points}
        self._lock = threading.Lock()

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply(self, status: int, payload: Dict) -> None:
                data = json.dumps({"status": "ok",
                                   "result": payload}).encode()
                self.send_response(status)
                self.send_header("content-type", "application/json")
                self.send_header("content-length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _body(self) -> Dict:
                n = int(self.headers.get("content-length", 0))
                return json.loads(self.rfile.read(n)) if n else {}

            def do_GET(self):
                name = self.path.split("/")[2]
                with store._lock:
                    if name not in store._collections:
                        self._reply(404, {})
                        return
                    self._reply(200, {"points_count": len(
                        store._collections[name]["points"])})

            def do_PUT(self):
                parts = self.path.strip("/").split("/")
                body = self._body()
                with store._lock:
                    if len(parts) == 2:  # create collection
                        store._collections[parts[1]] = {
                            "size": body["vectors"]["size"], "points": {}}
                        self._reply(200, {})
                    else:  # upsert points
                        col = store._collections.get(parts[1])
                        if col is None:
                            self._reply(404, {})
                            return
                        for p in body.get("points", []):
                            col["points"][str(p["id"])] = p
                        self._reply(200, {"status": "completed"})

            def do_DELETE(self):
                name = self.path.split("/")[2]
                with store._lock:
                    store._collections.pop(name, None)
                self._reply(200, {})

            def _matches(self, payload: Dict, qfilter: Dict) -> bool:
                for cond in (qfilter or {}).get("must", []):
                    key = cond.get("key")
                    want = (cond.get("match") or {}).get("value")
                    if payload.get(key) != want:
                        return False
                should = (qfilter or {}).get("should", [])
                if should:
                    if not any(payload.get(c.get("key"))
                               == (c.get("match") or {}).get("value")
                               for c in should):
                        return False
                return True

            def do_POST(self):
                parts = self.path.strip("/").split("/")
                body = self._body()
                name = parts[1]
                op = parts[3] if len(parts) > 3 else ""
                with store._lock:
                    col = store._collections.get(name)
                    if col is None:
                        self._reply(404, {})
                        return
                    points = list(col["points"].values())
                    if op == "search":
                        q = np.asarray(body["vector"], np.float32)
                        qn = q / (np.linalg.norm(q) or 1.0)
                        scored = []
                        for p in points:
                            if not self._matches(p.get("payload", {}),
                                                 body.get("filter")):
                                continue
                            v = np.asarray(p["vector"], np.float32)
                            score = float(
                                (v / (np.linalg.norm(v) or 1.0)) @ qn)
                            scored.append((score, p))
                        scored.sort(key=lambda t: -t[0])
                        thresh = body.get("score_threshold", -1e9)
                        out = []
                        for s, p in scored[:body.get("limit", 5)]:
                            if s < thresh:
                                continue
                            hit = {"id": p["id"], "score": s,
                                   "payload": p.get("payload", {})}
                            if body.get("with_vector"):
                                hit["vector"] = p["vector"]
                            out.append(hit)
                        self._reply(200, out)
                    elif op == "delete":
                        ids = set(map(str, body.get("points", []) or []))
                        qfilter = body.get("filter")
                        drop = [pid for pid, p in col["points"].items()
                                if pid in ids
                                or (qfilter and self._matches(
                                    p.get("payload", {}), qfilter))]
                        for pid in drop:
                            del col["points"][pid]
                        self._reply(200, {"deleted": len(drop)})
                    elif op == "payload":
                        # merge payload fields into the given points
                        ids = set(map(str, body.get("points", []) or []))
                        updated = 0
                        for pid, p in col["points"].items():
                            if pid in ids:
                                p.setdefault("payload", {}).update(
                                    body.get("payload", {}) or {})
                                updated += 1
                        self._reply(200, {"updated": updated})
                    elif op == "scroll":
                        qfilter = body.get("filter")
                        out = [{"id": p["id"],
                                "payload": p.get("payload", {})}
                               for p in points
                               if self._matches(p.get("payload", {}),
                                                qfilter)]
                        self._reply(200, {
                            "points": out[:body.get("limit", 100)]})
                    else:
                        self._reply(404, {})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()
        self.url = f"http://{host}:{self._httpd.server_address[1]}"

    def stop(self) -> None:
        self._httpd.shutdown()


class QdrantVectorStore:
    """VectorStore protocol over a Qdrant collection (vectors + payloads
    server-side; chunking + embedding client-side)."""

    def __init__(self, client: QdrantClient, collection: str,
                 embed_fn: Callable[[str], np.ndarray],
                 vector_size: Optional[int] = None,
                 chunk_sentences: int = 5,
                 overlap_sentences: int = 1) -> None:
        self.client = client
        self.collection = collection
        self.embed_fn = embed_fn
        self.chunk_sentences = chunk_sentences
        self.overlap_sentences = overlap_sentences
        if not client.collection_exists(collection):
            size = vector_size or len(np.asarray(embed_fn("probe")).ravel())
            client.create_collection(collection, size)

    def ingest(self, name: str, text: str,
               metadata: Optional[Dict[str, str]] = None) -> Document:
        doc = Document(id=uuid.uuid4().hex[:12], name=name, text=text,
                       metadata=dict(metadata or {}))
        pieces = chunk_text(text, self.chunk_sentences,
                            self.overlap_sentences)
        points = []
        for i, piece in enumerate(pieces):
            emb = np.asarray(self.embed_fn(piece), np.float32)
            cid = uuid.uuid4().hex  # qdrant wants uuid/int ids
            doc.chunk_ids.append(cid)
            # reserved keys win over user metadata — metadata named
            # "text"/"index" must not clobber the chunk payload
            points.append({"id": cid, "vector": emb.tolist(),
                           "payload": {**doc.metadata,
                                       "text": piece,
                                       "document_id": doc.id,
                                       "document_name": name,
                                       "index": i}})
        if points:
            self.client.upsert(self.collection, points)
        return doc

    def search(self, query: str, top_k: int = 5, threshold: float = 0.0,
               hybrid: bool = True) -> List[SearchHit]:
        emb = np.asarray(self.embed_fn(query), np.float32)
        hits = self.client.search(self.collection, emb, limit=top_k,
                                  score_threshold=threshold)
        out = []
        for h in hits:
            payload = h.get("payload", {}) or {}
            chunk = Chunk(
                id=str(h.get("id", "")),
                document_id=payload.get("document_id", ""),
                text=payload.get("text", ""),
                index=int(payload.get("index", 0)),
                metadata={k: v for k, v in payload.items()
                          if k not in ("text", "document_id",
                                       "document_name", "index")})
            score = float(h.get("score", 0.0))
            out.append(SearchHit(chunk, score, score, 0.0))
        return out

    def delete_document(self, document_id: str) -> bool:
        self.client.delete_points(
            self.collection,
            query_filter=match_filter("document_id", document_id))
        return True

    def stats(self) -> Dict[str, int]:
        points = self.client.scroll(self.collection, limit=10_000)
        docs = {p.get("payload", {}).get("document_id") for p in points}
        return {"documents": len(docs - {None}), "chunks": len(points)}

    def list_documents(self) -> List[Dict[str, Any]]:
        """[{id, name, chunks}] aggregated server-side (the management
        /files listing for stores without an in-proc documents map)."""
        agg: Dict[str, Dict[str, Any]] = {}
        for p in self.client.scroll(self.collection, limit=10_000):
            payload = p.get("payload", {}) or {}
            did = payload.get("document_id")
            if not did:
                continue
            entry = agg.setdefault(did, {
                "id": did, "name": payload.get("document_name", ""),
                "chunks": 0})
            entry["chunks"] += 1
        return list(agg.values())
