"""Milvus wire client (RESTful v2 API) + vector-store backend.

The port's copy of ``semantic_router_tpu.state.milvus``: the same
requests, rows and filter strings, so each package's client talks to the
other's ``MiniMilvus``.

Reference: pkg/vectorstore milvus backend + pkg/cache/milvus_cache.go —
the reference's default external ANN store.  Speaks Milvus's public
RESTful v2 surface (zero dependencies):

  POST /v2/vectordb/collections/create | /drop | /describe
  POST /v2/vectordb/entities/insert | /search | /delete | /query

``MilvusVectorStore`` mirrors QdrantVectorStore: chunking + embeddings
client-side, vectors + payload fields server-side, cross-replica
visibility.  ``MiniMilvus`` is the embedded REST stand-in for tests/dev.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
import uuid
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ..vectorstore.store import Chunk, Document, SearchHit, chunk_text


class MilvusError(Exception):
    pass


def escape_filter_value(value: str) -> str:
    """Escape a value for interpolation into a Milvus filter string — an
    unescaped quote would be a filter-injection (mass delete)."""
    return str(value).replace("\\", "\\\\").replace('"', '\\"')


class MilvusClient:
    def __init__(self, base_url: str = "http://127.0.0.1:19530",
                 token: str = "", db_name: str = "default",
                 timeout_s: float = 30.0) -> None:
        self.base_url = base_url.rstrip("/")
        self.token = token
        self.db_name = db_name
        self.timeout_s = timeout_s

    def _post(self, path: str, body: Dict) -> Dict:
        body = {"dbName": self.db_name, **body}
        req = urllib.request.Request(self.base_url + path,
                                     data=json.dumps(body).encode(),
                                     method="POST")
        req.add_header("content-type", "application/json")
        if self.token:
            req.add_header("authorization", f"Bearer {self.token}")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                out = json.loads(r.read() or b"{}")
        except urllib.error.HTTPError as e:
            raise MilvusError(f"POST {path} -> {e.code}: "
                              f"{e.read().decode()[:200]}")
        except Exception as exc:
            raise MilvusError(f"POST {path} failed: {exc}")
        if out.get("code", 0) not in (0, 200):
            raise MilvusError(f"POST {path} -> code {out.get('code')}: "
                              f"{out.get('message', '')[:200]}")
        return out

    # -- collections ------------------------------------------------------

    def create_collection(self, name: str, dimension: int,
                          metric: str = "COSINE") -> None:
        self._post("/v2/vectordb/collections/create", {
            "collectionName": name, "dimension": dimension,
            "metricType": metric})

    def drop_collection(self, name: str) -> None:
        self._post("/v2/vectordb/collections/drop",
                   {"collectionName": name})

    def has_collection(self, name: str) -> bool:
        try:
            self._post("/v2/vectordb/collections/describe",
                       {"collectionName": name})
            return True
        except MilvusError:
            return False

    # -- entities ---------------------------------------------------------

    def insert(self, collection: str, rows: List[Dict]) -> None:
        """rows: [{id, vector, **payload fields}]"""
        self._post("/v2/vectordb/entities/insert",
                   {"collectionName": collection, "data": rows})

    def search(self, collection: str, vector: Sequence[float],
               limit: int = 5, flt: str = "",
               output_fields: Optional[List[str]] = None) -> List[Dict]:
        body: Dict[str, Any] = {
            "collectionName": collection,
            "data": [list(map(float, vector))],
            "limit": limit,
            "outputFields": output_fields or ["*"]}
        if flt:
            body["filter"] = flt
        out = self._post("/v2/vectordb/entities/search", body)
        return out.get("data", [])

    def delete(self, collection: str, flt: str) -> None:
        self._post("/v2/vectordb/entities/delete",
                   {"collectionName": collection, "filter": flt})

    # Milvus's documented query limit ceiling; stats/list views use it so
    # truncation starts at 16384 rows, not the 1000 default
    MAX_QUERY_LIMIT = 16384

    def query(self, collection: str, flt: str = "",
              output_fields: Optional[List[str]] = None,
              limit: int = 1000) -> List[Dict]:
        out = self._post("/v2/vectordb/entities/query", {
            "collectionName": collection, "filter": flt or 'id != ""',
            "outputFields": output_fields or ["*"], "limit": limit})
        return out.get("data", [])


class MilvusVectorStore:
    """VectorStore protocol over a Milvus collection."""

    def __init__(self, client: MilvusClient, collection: str,
                 embed_fn: Callable[[str], np.ndarray],
                 vector_size: Optional[int] = None,
                 chunk_sentences: int = 5,
                 overlap_sentences: int = 1) -> None:
        self.client = client
        self.collection = collection
        self.embed_fn = embed_fn
        self.chunk_sentences = chunk_sentences
        self.overlap_sentences = overlap_sentences
        if not client.has_collection(collection):
            size = vector_size or len(np.asarray(embed_fn("probe")).ravel())
            client.create_collection(collection, size)

    def ingest(self, name: str, text: str,
               metadata: Optional[Dict[str, str]] = None) -> Document:
        doc = Document(id=uuid.uuid4().hex[:12], name=name, text=text,
                       metadata=dict(metadata or {}))
        rows = []
        for i, piece in enumerate(chunk_text(text, self.chunk_sentences,
                                             self.overlap_sentences)):
            emb = np.asarray(self.embed_fn(piece), np.float32)
            cid = uuid.uuid4().hex
            doc.chunk_ids.append(cid)
            rows.append({**doc.metadata,
                         "id": cid, "vector": emb.tolist(),
                         "text": piece, "document_id": doc.id,
                         "document_name": name, "chunk_index": i})
        if rows:
            self.client.insert(self.collection, rows)
        return doc

    def search(self, query: str, top_k: int = 5, threshold: float = 0.0,
               hybrid: bool = True) -> List[SearchHit]:
        emb = np.asarray(self.embed_fn(query), np.float32)
        hits = self.client.search(self.collection, emb, limit=top_k)
        out = []
        for h in hits:
            score = float(h.get("distance", h.get("score", 0.0)))
            # threshold 0.0 means unfiltered (matches the qdrant backend:
            # a zero threshold must not drop negative-cosine hits)
            if threshold and score < threshold:
                continue
            chunk = Chunk(
                id=str(h.get("id", "")),
                document_id=h.get("document_id", ""),
                text=h.get("text", ""),
                index=int(h.get("chunk_index", 0)),
                metadata={k: v for k, v in h.items()
                          if k not in ("id", "vector", "text",
                                       "document_id", "document_name",
                                       "chunk_index", "distance",
                                       "score")})
            out.append(SearchHit(chunk, score, score, 0.0))
        return out

    def delete_document(self, document_id: str) -> bool:
        self.client.delete(
            self.collection,
            f'document_id == "{escape_filter_value(document_id)}"')
        return True

    def stats(self) -> Dict[str, int]:
        rows = self.client.query(self.collection,
                                 output_fields=["document_id"],
                                 limit=MilvusClient.MAX_QUERY_LIMIT)
        docs = {r.get("document_id") for r in rows}
        return {"documents": len(docs - {None}), "chunks": len(rows)}

    def list_documents(self) -> List[Dict[str, Any]]:
        agg: Dict[str, Dict[str, Any]] = {}
        for r in self.client.query(
                self.collection,
                output_fields=["document_id", "document_name"],
                limit=MilvusClient.MAX_QUERY_LIMIT):
            did = r.get("document_id")
            if not did:
                continue
            entry = agg.setdefault(did, {
                "id": did, "name": r.get("document_name", ""),
                "chunks": 0})
            entry["chunks"] += 1
        return list(agg.values())


class MiniMilvus:
    """Embedded Milvus-RESTv2 stand-in (MiniRedis/MiniQdrant sibling)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        import re
        import threading
        from http.server import (
            BaseHTTPRequestHandler,
            ThreadingHTTPServer,
        )

        store = self
        self._collections: Dict[str, Dict] = {}
        self._lock = threading.Lock()

        def eval_one(flt: str, row: Dict) -> bool:
            m = re.match(r'\s*(\w+)\s*(==|!=)\s*"((?:[^"\\]|\\.)*)"\s*$',
                         flt)
            if not m:
                return False  # unparsable filter matches NOTHING — a
                # permissive fallback would turn a bad filter into a
                # collection-wide delete
            field, op, value = m.groups()
            value = value.replace('\\"', '"').replace("\\\\", "\\")
            got = str(row.get(field, ""))
            return (got == value) if op == "==" else (got != value)

        def eval_filter(flt: str, row: Dict) -> bool:
            if not flt:
                return True
            # top-level OR of equality clauses (the subset the backends
            # emit, e.g. category == "x" or category == "")
            return any(eval_one(part, row)
                       for part in re.split(r"\s+or\s+", flt))

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply(self, payload, code=0) -> None:
                data = json.dumps({"code": code,
                                   "data": payload}).encode()
                self.send_response(200)
                self.send_header("content-type", "application/json")
                self.send_header("content-length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_POST(self):
                n = int(self.headers.get("content-length", 0))
                body = json.loads(self.rfile.read(n)) if n else {}
                path = self.path
                name = body.get("collectionName", "")
                with store._lock:
                    if path.endswith("/collections/create"):
                        store._collections[name] = {
                            "dim": body["dimension"], "rows": {}}
                        self._reply({})
                    elif path.endswith("/collections/drop"):
                        store._collections.pop(name, None)
                        self._reply({})
                    elif path.endswith("/collections/describe"):
                        if name in store._collections:
                            self._reply({"collectionName": name})
                        else:
                            self._reply({}, code=100)
                    elif name not in store._collections:
                        self._reply({}, code=100)
                    elif path.endswith("/entities/insert"):
                        col = store._collections[name]
                        for row in body.get("data", []):
                            col["rows"][str(row["id"])] = row
                        self._reply({"insertCount":
                                     len(body.get("data", []))})
                    elif path.endswith("/entities/search"):
                        col = store._collections[name]
                        q = np.asarray(body["data"][0], np.float32)
                        qn = q / (np.linalg.norm(q) or 1.0)
                        flt = body.get("filter", "")
                        scored = []
                        for row in col["rows"].values():
                            if not eval_filter(flt, row):
                                continue
                            v = np.asarray(row["vector"], np.float32)
                            s = float((v / (np.linalg.norm(v) or 1.0)) @ qn)
                            # real Milvus returns the vector only when
                            # explicitly named in outputFields
                            want_vec = "vector" in (
                                body.get("outputFields") or [])
                            out_row = {k: val for k, val in row.items()
                                       if k != "vector" or want_vec}
                            out_row["distance"] = s
                            scored.append((s, out_row))
                        scored.sort(key=lambda t: -t[0])
                        self._reply([r for _, r in
                                     scored[:body.get("limit", 5)]])
                    elif path.endswith("/entities/delete"):
                        col = store._collections[name]
                        flt = body.get("filter", "")
                        drop = [rid for rid, row in col["rows"].items()
                                if eval_filter(flt, row)]
                        for rid in drop:
                            del col["rows"][rid]
                        self._reply({"deleteCount": len(drop)})
                    elif path.endswith("/entities/query"):
                        col = store._collections[name]
                        flt = body.get("filter", "")
                        rows = [{k: v for k, v in row.items()
                                 if k != "vector"}
                                for row in col["rows"].values()
                                if eval_filter(flt, row)]
                        self._reply(rows[:body.get("limit", 1000)])
                    else:
                        self._reply({}, code=100)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()
        self.url = f"http://{host}:{self._httpd.server_address[1]}"

    def stop(self) -> None:
        self._httpd.shutdown()
