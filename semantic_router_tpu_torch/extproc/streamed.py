"""STREAMED request-body processing: chunk-wise early detection.

The port's copy of ``semantic_router_tpu.extproc.streamed``.  Reference
parity: ``pkg/extproc/processor_req_body_streamed.go`` — in
Envoy STREAMED / FULL_DUPLEX_STREAMED body mode the request body arrives
as multiple HttpBody frames. The handler is a small state machine:

  INIT         scan the partial JSON for the top-level ``model`` field
  PASSTHROUGH  non-auto model: eat chunks, emit the body at EOS
  ACCUMULATE   auto model: eat chunks, run the pipeline at EOS

with guards (max accumulated bytes → 413, accumulation deadline → 408).

Beyond the reference's early MODEL detection, this handler also starts
SIGNAL EVALUATION early: once the top-level ``messages`` array is
complete in the partial body (for large bodies the expensive classify
text is often fully known before trailing fields finish arriving),
classification kicks off on a worker thread and overlaps the remaining
network time — at EOS the pipeline reuses the prefetched signals
instead of paying classify latency serially (the reference's
streamed-vs-buffered e2e win, BASELINE.md:37).

Reuse safety: the prefetch evaluates on every COMPLETE top-level field
seen at kickoff; if a later chunk completes another signal-relevant
field (messages/model/tools/stream/user — everything
``RequestContext.from_openai_body`` feeds evaluators), the prefetch is
resubmitted with the updated view. At EOS the result is reused only
when the final body's signal projection matches what the last prefetch
saw — otherwise inline evaluation runs: never wrong signals, just no
overlap for that body shape.

The scanner is RESUMABLE: each chunk advances a byte-level tokenizer
(string/escape state + container depth) from where the previous chunk
stopped, so total scan work is O(body bytes) regardless of chunk count
— a 50 MiB body in 4 KiB frames costs one pass, not 12,800 rescans.
"""

from __future__ import annotations

import json
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Optional

__all__ = ["StreamedBodyHandler", "TopLevelScanner",
           "partial_top_level_fields"]

_WS = b" \t\r\n"


class TopLevelScanner:
    """Incremental scanner for the COMPLETE top-level fields of a
    possibly-truncated JSON object. ``feed(buf)`` resumes from the byte
    where the previous call stopped (``buf`` is the WHOLE accumulated
    body so far). Keys are only recognized at depth 1 — a ``"model"``
    inside message content never matches."""

    def __init__(self) -> None:
        self.fields: Dict[str, bytes] = {}
        self.pos = 0
        self.done = False    # saw the closing brace
        self.broken = False  # not an object / malformed framing
        self._state = "start"
        self._key: Optional[str] = None
        self._key_start = 0
        self._val_start = 0
        self._val_kind = ""
        self._depth = 0
        self._in_str = False
        self._esc = False

    def _emit(self, buf: bytes, end: int) -> None:
        if self._key is not None:
            self.fields[self._key] = bytes(buf[self._val_start:end])

    def feed(self, buf) -> None:
        i, n = self.pos, len(buf)
        while i < n and not self.done and not self.broken:
            c = buf[i]
            s = self._state
            if s == "start":
                if c in _WS:
                    i += 1
                elif c == 0x7B:  # {
                    self._state = "key_ws"
                    i += 1
                else:
                    self.broken = True
            elif s == "key_ws":
                if c in _WS or c == 0x2C:  # ws or comma
                    i += 1
                elif c == 0x7D:  # }
                    self.done = True
                elif c == 0x22:  # quote
                    self._state = "key"
                    self._key_start = i + 1
                    self._esc = False
                    i += 1
                else:
                    self.broken = True
            elif s == "key":
                if self._esc:
                    self._esc = False
                    i += 1
                elif c == 0x5C:
                    self._esc = True
                    i += 1
                elif c == 0x22:
                    self._key = buf[self._key_start:i].decode(
                        "utf-8", "replace")
                    self._state = "colon"
                    i += 1
                else:
                    i += 1
            elif s == "colon":
                if c in _WS:
                    i += 1
                elif c == 0x3A:  # :
                    self._state = "value_ws"
                    i += 1
                else:
                    self.broken = True
            elif s == "value_ws":
                if c in _WS:
                    i += 1
                    continue
                self._val_start = i
                if c == 0x22:
                    self._val_kind = "string"
                    self._esc = False
                    self._state = "value"
                    i += 1
                elif c in (0x7B, 0x5B):  # { [
                    self._val_kind = "container"
                    self._depth = 1
                    self._in_str = False
                    self._esc = False
                    self._state = "value"
                    i += 1
                else:
                    self._val_kind = "scalar"
                    self._state = "value"
                    i += 1
            elif s == "value" and self._val_kind == "string":
                if self._esc:
                    self._esc = False
                    i += 1
                elif c == 0x5C:
                    self._esc = True
                    i += 1
                elif c == 0x22:
                    i += 1
                    self._emit(buf, i)
                    self._state = "key_ws"
                else:
                    i += 1
            elif s == "value" and self._val_kind == "container":
                if self._in_str:
                    if self._esc:
                        self._esc = False
                    elif c == 0x5C:
                        self._esc = True
                    elif c == 0x22:
                        self._in_str = False
                    i += 1
                elif c == 0x22:
                    self._in_str = True
                    self._esc = False
                    i += 1
                elif c in (0x7B, 0x5B):
                    self._depth += 1
                    i += 1
                elif c in (0x7D, 0x5D):
                    self._depth -= 1
                    i += 1
                    if self._depth == 0:
                        self._emit(buf, i)
                        self._state = "key_ws"
                else:
                    i += 1
            else:  # scalar value
                if c in b",}] \t\r\n":
                    self._emit(buf, i)
                    self._state = "key_ws"
                    # do not consume: key_ws handles , and }
                else:
                    i += 1
        self.pos = i


def partial_top_level_fields(buf: bytes) -> Dict[str, bytes]:
    """One-shot convenience over :class:`TopLevelScanner`."""
    sc = TopLevelScanner()
    sc.feed(bytes(buf))
    return sc.fields


def _decode_json_string(raw: bytes) -> Optional[str]:
    try:
        v = json.loads(raw)
        return v if isinstance(v, str) else None
    except (ValueError, TypeError):
        return None


# everything RequestContext.from_openai_body feeds the evaluators — the
# prefetch result is reusable iff these match between the body the
# prefetch saw and the final body (signals/base.py:129-139)
_SIGNAL_FIELDS = ("messages", "model", "tools", "stream", "user")


# handler states
_INIT, _PASSTHROUGH, _ACCUMULATE = range(3)


class StreamedBodyHandler:
    """One per request-body stream. ``handle_chunk`` returns one of:

      ("continue", None)            eat the chunk, keep streaming
      ("route", (body, signals))    EOS on an auto request: run the
                                    pipeline (signals may be a resolved
                                    prefetch or None)
      ("passthrough", body)         EOS on a pinned-model request
      ("error", (status, payload))  guard tripped (413 / 408 / 400)
    """

    def __init__(self, router, headers: Dict[str, str],
                 prefetch_pool: Optional[ThreadPoolExecutor] = None,
                 max_bytes: int = 50 * 1024 * 1024,
                 deadline_s: float = 0.0,
                 auto_names: tuple = ("auto", "")) -> None:
        self.router = router
        self.headers = headers
        self.pool = prefetch_pool
        self.max_bytes = max_bytes
        self.deadline_t = (time.monotonic() + deadline_s) \
            if deadline_s > 0 else 0.0
        self.auto_names = auto_names
        self.state = _INIT
        self.buf = bytearray()
        self.scanner = TopLevelScanner()
        self.model: Optional[str] = None
        # diagnostics for telemetry/tests: chunk index (1-based) where
        # the model was detected / the signal prefetch (last) started
        self.chunks_seen = 0
        self.model_detected_at: Optional[int] = None
        self.prefetch_started_at: Optional[int] = None
        self._prefetch: Optional[Future] = None
        self._prefetch_body: Optional[Dict] = None
        self._prefetch_proj: Optional[Dict[str, bytes]] = None
        # pre-minted trace context (router.begin_pending_trace): the
        # prefetch's signal spans parent under the root span route()
        # will adopt, instead of orphaning in a throwaway trace.  The
        # frontend passes it to route(..., pending_trace=...).
        self.pending_trace = None

    # -- guards ----------------------------------------------------------

    def _guard_error(self):
        if len(self.buf) > self.max_bytes:
            return ("error", (413, {"error": {
                "message": f"request body exceeds the router's "
                           f"{self.max_bytes} byte buffer limit",
                "type": "payload_too_large"}}))
        if self.deadline_t and time.monotonic() > self.deadline_t:
            return ("error", (408, {"error": {
                "message": "request body accumulation timed out",
                "type": "request_timeout"}}))
        return None

    # -- chunk loop ------------------------------------------------------

    def handle_chunk(self, chunk: bytes, eos: bool):
        self.buf += chunk
        self.chunks_seen += 1
        err = self._guard_error()
        if err is not None:
            return err
        if not eos:
            # mid-stream early-detection work; the scanner resumes from
            # where the previous chunk left off (O(total bytes) overall)
            self.scanner.feed(self.buf)
            fields = self.scanner.fields
            if self.state == _INIT:
                self._detect(fields, eos=False)
            if self.state == _ACCUMULATE:
                self._maybe_prefetch(fields)
            return ("continue", None)
        # EOS: never start (or restart) a prefetch here — the pipeline
        # runs inline next; a pool hop would only add queueing
        # (single-frame BUFFERED bodies land here directly)
        return self._finish()

    def _detect(self, fields: Dict[str, bytes], eos: bool) -> None:
        model_raw = fields.get("model")
        if model_raw is None and not eos:
            return  # keep waiting for the model key
        self.model = _decode_json_string(model_raw) \
            if model_raw is not None else None
        if self.model is not None:
            self.model_detected_at = self.chunks_seen
        if self.model is None or self.model in self.auto_names:
            self.state = _ACCUMULATE
        else:
            self.state = _PASSTHROUGH

    def _maybe_prefetch(self, fields: Dict[str, bytes]) -> None:
        if self.pool is None or "messages" not in fields:
            return
        proj = {k: fields.get(k) for k in _SIGNAL_FIELDS}
        if proj == self._prefetch_proj:
            # same signal view as the last decision — whether that was a
            # running prefetch or a rate-limit decline, it stands (the
            # decline cache matters: without it an over-limit client
            # would force a full field re-parse on every chunk)
            return
        # rate-limit preview BEFORE any parsing or speculative
        # classification: route() checks the limiter before signal work,
        # and the prefetch must not hand an over-limit client a way to
        # burn classifier capacity (or parse CPU) that route() would
        # never have spent. peek consumes nothing; the authoritative
        # check still happens in route(). The user is taken from the
        # trusted header first, else the body's ``user`` field if it has
        # already arrived — if it arrives later, the proj changes and
        # this re-runs with the real identity.
        limiter = getattr(self.router, "rate_limiter", None)
        if limiter is not None:
            user = ""
            for k, v in self.headers.items():
                if k.lower() == "x-authz-user-id":
                    user = v
                    break
            if not user and fields.get("user") is not None:
                try:
                    user = str(json.loads(fields["user"]))
                except ValueError:
                    user = ""
            if not limiter.peek(user, self.model or "auto"):
                self._cancel_prefetch()
                self._prefetch_proj = proj  # cache the decline
                return
        if self._prefetch is not None:
            # a signal-relevant field completed after kickoff (e.g. a
            # tools array that followed messages): restart with the
            # richer view so the result stays reusable
            self._prefetch.cancel()
        # evaluate on EVERY complete field seen so far, not a stripped
        # {model, messages} body — evaluators read tools/stream/user too
        body: Dict = {}
        for key, raw in fields.items():
            try:
                body[key] = json.loads(raw)
            except ValueError:
                return  # scanner/JSON disagreement: skip the prefetch
        if not isinstance(body.get("messages"), list):
            return
        body.setdefault("model", self.model or "auto")
        headers = dict(self.headers)
        self._prefetch_body = body
        self._prefetch_proj = proj
        self.prefetch_started_at = self.chunks_seen
        router = self.router
        # capture the pending trace context ONCE at first kickoff (the
        # trace seam: restarted prefetches stay in the same trace, so an
        # operator sees discarded speculative evaluations too); routers
        # without the seam (test stubs) keep the two-arg call
        begin = getattr(router, "begin_pending_trace", None)
        if self.pending_trace is None and begin is not None:
            try:
                self.pending_trace = begin(headers)
            except Exception:
                self.pending_trace = None
        if self.pending_trace is not None:
            self._prefetch = self.pool.submit(
                router.evaluate_signals, dict(body), headers,
                self.pending_trace)
        else:
            self._prefetch = self.pool.submit(
                router.evaluate_signals, dict(body), headers)

    def _cancel_prefetch(self) -> None:
        if self._prefetch is not None:
            self._prefetch.cancel()
            self._prefetch = None
            self._prefetch_body = None

    def _finish(self):
        raw = bytes(self.buf)
        try:
            body = json.loads(raw or b"{}")
        except json.JSONDecodeError:
            return ("error", (400, {"error": {
                "message": "invalid JSON"}}))
        if self.state == _PASSTHROUGH:
            return ("passthrough", body)
        signals = None
        if self._prefetch is not None:
            pre = self._prefetch_body or {}
            if all(pre.get(k) == body.get(k) for k in _SIGNAL_FIELDS):
                # cancel-first: if the future is still QUEUED behind other
                # streams' work (shared small pool), cancel() succeeds and
                # route() evaluates inline immediately — waiting on an
                # unstarted future would add queueing delay on top of the
                # inline work it doesn't save
                if self._prefetch.cancel():
                    signals = None
                else:
                    try:
                        signals = self._prefetch.result(timeout=30)
                    except Exception:
                        signals = None
            else:
                # the final body's signal view differs from what the
                # prefetch saw (late field, duplicate key): inline
                # evaluation — never wrong signals
                self._prefetch.cancel()
        return ("route", (body, signals))
