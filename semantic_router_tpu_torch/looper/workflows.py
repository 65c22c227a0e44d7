"""Agentic workflows engine: planner → staged execution → tool
interrupt/resume → final synthesis (the port's copy of
``semantic_router_tpu.looper.workflows``).

Capability parity with pkg/looper/workflows*.go (6.9k LoC, 16 files):

- **dynamic mode**: a planner model writes a JSON plan
  ``{steps: [{id, role, models, prompt, access_list}], final: {model,
  prompt}}``; the plan is fence/brace-extracted, validated against the
  decision's worker models, and falls back to a single-step fan-out when
  ``on_error: skip`` (workflows_planner.go, workflows_plan_parse.go,
  workflows_validation.go).
- **static mode**: the plan comes from configured roles
  (workflows_static.go).
- **staged execution**: steps run sequentially; a step's models run in
  parallel (bounded by max_parallel); each step's prompt sees the original
  request plus the outputs of previous steps its ``access_list`` allows
  (workflows.go:255, workflows_access.go).
- **tool interrupt/resume**: a worker response carrying tool_calls pauses
  the workflow — pending state (plan, step index, conversation, completed
  sibling responses) is saved in a TTL state store and the tool_calls are
  returned to the client with the state id embedded in each tool_call_id
  (``vsrwf-<state>::<original>``). When tool results come back, the
  trailing tool messages are matched by that prefix, state is taken, the
  model is re-called with the tool results, and the remaining plan
  executes (workflows_tool_state.go:90, workflows_tool_resume.go,
  workflows_state_store.go; the port keeps the in-memory store, and its
  loader refuses the redis / valkey ones).
- **final synthesis + output contracts**: a final model fuses step
  outputs; contracts post-process the final response — ``json_action``
  extracts the first JSON object, ``reference_selection`` resolves an
  index over candidates, single-choice fallback picks the best worker
  answer when synthesis fails (workflows_output_contract.go).
- the execution trace (plan, per-step responses, tool trajectories,
  models used) returns with the response (workflows_summary.go).
"""

from __future__ import annotations

import json
import re
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..config.schema import ModelRef
from .looper import LLMClient, LooperResponse, _content, _last_user

TOOL_CALL_ID_PREFIX = "vsrwf-"
TOOL_CALL_ID_SEP = "::"


# ---------------------------------------------------------------------------
# config / plan
# ---------------------------------------------------------------------------


@dataclass
class WorkflowConfig:
    mode: str = "dynamic"  # dynamic | static
    planner_model: str = ""
    roles: List[dict] = field(default_factory=list)
    final_model: str = ""
    final_prompt: str = ""
    max_steps: int = 4
    max_parallel: int = 3
    min_successful: int = 1
    on_error: str = "error"  # error | skip
    include_intermediate: bool = False
    output_contract: Dict[str, Any] = field(default_factory=dict)
    planner_max_tokens: int = 1024
    state_ttl_s: float = 600.0

    @classmethod
    def from_algorithm(cls, conf: Dict[str, Any]) -> "WorkflowConfig":
        conf = conf or {}
        final = conf.get("final", {}) or {}
        return cls(
            mode=str(conf.get("mode", "dynamic")),
            planner_model=str(conf.get("planner_model", "")),
            roles=list(conf.get("roles", []) or []),
            final_model=str(final.get("model", "")),
            final_prompt=str(final.get("prompt", "")),
            max_steps=int(conf.get("max_steps", 4)),
            max_parallel=int(conf.get("max_parallel", 3)),
            min_successful=int(conf.get("min_successful", 1)),
            on_error=str(conf.get("on_error", "error")),
            include_intermediate=bool(
                conf.get("include_intermediate_responses", False)),
            output_contract=dict(conf.get("output_contract", {}) or {}),
            planner_max_tokens=int(conf.get("planner_max_tokens", 1024)),
            state_ttl_s=float(conf.get("state_ttl_seconds", 600.0)),
        )


@dataclass
class PlanStep:
    id: str = ""
    role: str = ""
    models: List[str] = field(default_factory=list)
    prompt: str = ""
    # None → every previous step visible; [] → none (the reference keeps
    # Go's nil-vs-empty distinction, workflows_access.go:28)
    access_list: Optional[List[str]] = None


@dataclass
class WorkflowPlan:
    steps: List[PlanStep] = field(default_factory=list)
    final_model: str = ""
    final_prompt: str = ""

    def to_dict(self) -> dict:
        return {"steps": [asdict(s) for s in self.steps],
                "final": {"model": self.final_model,
                          "prompt": self.final_prompt}}

    @classmethod
    def from_dict(cls, d: dict) -> "WorkflowPlan":
        final = d.get("final", {}) or {}
        return cls(
            steps=[PlanStep(
                id=str(s.get("id", "")), role=str(s.get("role", "")),
                models=[str(m) for m in (s.get("models", []) or [])],
                prompt=str(s.get("prompt", "")),
                access_list=None if s.get("access_list") is None
                else [str(a) for a in s["access_list"]])
                for s in d.get("steps", []) or []],
            final_model=str(final.get("model", "")),
            final_prompt=str(final.get("prompt", "")))


_JSON_FENCE_RE = re.compile(r"```(?:json)?\s*(.*?)```", re.DOTALL)


def extract_json_object(text: str) -> Optional[dict]:
    """Fence-first, then outermost-braces JSON extraction
    (workflows_plan_parse.go candidates order)."""
    candidates = [m.group(1) for m in _JSON_FENCE_RE.finditer(text)]
    candidates.append(text)
    start = text.find("{")
    end = text.rfind("}")
    if 0 <= start < end:
        candidates.append(text[start:end + 1])
    for cand in candidates:
        try:
            obj = json.loads(cand.strip())
        except json.JSONDecodeError:
            continue
        if isinstance(obj, dict):
            return obj
    return None


def parse_workflow_plan(text: str) -> WorkflowPlan:
    obj = extract_json_object(text)
    if obj is None or "steps" not in obj:
        raise ValueError("planner output contains no workflow plan JSON")
    return WorkflowPlan.from_dict(obj)


def validate_plan(plan: WorkflowPlan, worker_models: Sequence[str],
                  cfg: WorkflowConfig) -> None:
    if not plan.steps:
        raise ValueError("workflow plan has no steps")
    if len(plan.steps) > cfg.max_steps:
        raise ValueError(
            f"plan has {len(plan.steps)} steps > max_steps={cfg.max_steps}")
    known = set(worker_models)
    seen_ids = set()
    for i, step in enumerate(plan.steps):
        if not step.id:
            step.id = f"step_{i + 1}"
        if step.id in seen_ids:
            raise ValueError(f"duplicate step id {step.id!r}")
        seen_ids.add(step.id)
        if not step.models:
            step.models = list(worker_models)
        bad = [m for m in step.models if m not in known]
        if bad:
            raise ValueError(f"step {step.id!r} uses unknown models {bad}")
        if not step.prompt:
            raise ValueError(f"step {step.id!r} has no prompt")
        for a in (step.access_list or ()):
            if a not in seen_ids:
                raise ValueError(
                    f"step {step.id!r} access_list references unknown or "
                    f"later step {a!r}")
    if plan.final_model and plan.final_model not in known:
        raise ValueError(f"final model {plan.final_model!r} not a worker")


def fallback_plan(worker_models: Sequence[str], original: str,
                  cfg: WorkflowConfig) -> WorkflowPlan:
    """One fan-out step over every worker (buildDynamicWorkflowFallbackPlan
    role) used when the planner output is unusable and on_error=skip."""
    return WorkflowPlan(steps=[PlanStep(
        id="step_1", role="worker", models=list(worker_models),
        prompt="Answer the request as well as you can.")],
        final_model=cfg.final_model, final_prompt=cfg.final_prompt)


def build_planner_prompt(original: str, worker_models: Sequence[str],
                         cfg: WorkflowConfig) -> str:
    return (
        "You are a workflow planner. Decompose the user request into a "
        "short sequence of steps executed by worker models.\n"
        f"Available worker models: {', '.join(worker_models)}\n"
        f"At most {cfg.max_steps} steps.\n"
        "Reply with ONLY a JSON object:\n"
        '{"steps": [{"id": "step_1", "role": "...", '
        '"models": ["<worker>"], "prompt": "...", "access_list": []}], '
        '"final": {"model": "<worker>", "prompt": "..."}}\n'
        "access_list lists ids of EARLIER steps whose outputs the step "
        "needs.\n\nUser request:\n" + original)


# ---------------------------------------------------------------------------
# pending tool state + stores
# ---------------------------------------------------------------------------


@dataclass
class PendingToolState:
    state_id: str
    phase: str  # "step" | "final"
    step_index: int
    model: str
    messages: List[dict]  # conversation incl. the assistant tool_calls turn
    plan: dict
    step_results: List[dict]  # completed steps: {id, role, responses}
    sibling_responses: List[dict]  # completed (model, text) of current step
    original_body: dict
    config: dict
    tool_trajectory: List[dict] = field(default_factory=list)
    usage: Dict[str, Dict[str, int]] = field(default_factory=dict)
    created_t: float = field(default_factory=time.time)


class MemoryWorkflowStateStore:
    """TTL-bound in-memory pending-state store
    (workflowMemoryToolStateStore)."""

    def __init__(self, ttl_s: float = 600.0) -> None:
        self.ttl_s = ttl_s
        self._items: Dict[str, PendingToolState] = {}
        self._lock = threading.Lock()

    def put(self, state: PendingToolState) -> str:
        with self._lock:
            self._cleanup()
            self._items[state.state_id] = state
        return state.state_id

    def take(self, state_id: str) -> Optional[PendingToolState]:
        with self._lock:
            self._cleanup()
            return self._items.pop(state_id, None)

    def _cleanup(self) -> None:
        cutoff = time.time() - self.ttl_s
        for k in [k for k, v in self._items.items()
                  if v.created_t < cutoff]:
            del self._items[k]


def build_workflow_state_store(looper_cfg: Optional[Dict[str, Any]]):
    """State-store factory from the ``looper.workflow_state`` config block
    (newWorkflowToolStateStoreFromConfig role): the in-memory store."""
    wf_cfg = (looper_cfg or {}).get("workflow_state", {}) or {}
    ttl = float(wf_cfg.get("ttl_seconds", 600.0))
    if wf_cfg.get("backend") in ("redis", "valkey"):
        # a RESP client this port does not have; the loader refuses it
        raise ValueError(f"looper.workflow_state.backend "
                         f"{wf_cfg['backend']!r} is not served by this port "
                         f"yet (memory only)")
    return MemoryWorkflowStateStore(ttl_s=ttl)


def make_interrupt_tool_call_id(state_id: str, original_id: str) -> str:
    return f"{TOOL_CALL_ID_PREFIX}{state_id}{TOOL_CALL_ID_SEP}{original_id}"


def parse_tool_call_state_id(tool_call_id: str) -> Optional[str]:
    if not tool_call_id.startswith(TOOL_CALL_ID_PREFIX):
        return None
    rest = tool_call_id[len(TOOL_CALL_ID_PREFIX):]
    idx = rest.find(TOOL_CALL_ID_SEP)
    return rest[:idx] if idx > 0 else None


def find_workflow_state_id(body: Dict[str, Any]) -> Optional[str]:
    """Trailing tool messages carry the state id inside tool_call_id
    (findWorkflowToolStateID, workflows_tool_state.go:90)."""
    messages = body.get("messages") or []
    for msg in reversed(messages):
        if msg.get("role") != "tool":
            break
        state_id = parse_tool_call_state_id(str(msg.get("tool_call_id", "")))
        if state_id:
            return state_id
    return None


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


@dataclass
class _Ctx:
    """Per-request call context. The engine instance is shared across
    concurrent requests, so credentials/trace headers and usage MUST travel
    on the stack — an instance attribute would leak user A's credentials
    into user B's fan-out calls."""

    headers: Dict[str, str]
    headers_for: Optional[Callable[[str], Dict[str, str]]]
    usage: Dict[str, Dict[str, int]] = field(default_factory=dict)
    errors: List[str] = field(default_factory=list)


class WorkflowsLooper:
    """One instance per router; execute() is re-entrant (per-call state
    only on the stack / in the state store)."""

    def __init__(self, client: LLMClient,
                 pool: Optional[ThreadPoolExecutor] = None,
                 state_store=None) -> None:
        self.client = client
        self._owns_pool = pool is None
        self.pool = pool or ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="workflow")
        self.state_store = state_store or MemoryWorkflowStateStore()

    def shutdown(self) -> None:
        if self._owns_pool:
            self.pool.shutdown(wait=False, cancel_futures=True)

    # -- public ----------------------------------------------------------

    def execute(self, algorithm: Dict[str, Any], refs: Sequence[ModelRef],
                body: Dict[str, Any],
                headers: Optional[Dict[str, str]] = None,
                headers_for: Optional[Callable[[str], Dict[str, str]]] = None
                ) -> LooperResponse:
        cfg = WorkflowConfig.from_algorithm(
            algorithm.get("workflows", algorithm) or {})
        workers = [r.model for r in refs]
        if not workers:
            raise ValueError("workflows requires decision modelRefs")
        ctx = _Ctx(headers=dict(headers or {}), headers_for=headers_for)

        state_id = find_workflow_state_id(body)
        if state_id:
            return self._resume(state_id, body, ctx)

        original = _last_user(body)
        plan, planner_text = self._plan(cfg, workers, original, body, ctx)
        step_results, interrupt = self._run_steps(
            cfg, plan, body, original, ctx, start_index=0,
            prior_results=[], trajectory=[])
        if interrupt is not None:
            return interrupt
        return self._finish(cfg, plan, body, original, step_results,
                            ctx, trajectory=[])

    # -- planning --------------------------------------------------------

    def _plan(self, cfg: WorkflowConfig, workers: List[str], original: str,
              body: Dict[str, Any], ctx: _Ctx
              ) -> tuple[WorkflowPlan, str]:
        if cfg.mode == "static":
            if not cfg.roles:
                raise ValueError("static workflow mode requires roles")
            steps = []
            for i, role in enumerate(cfg.roles):
                # keep configured models verbatim — validate_plan raises on
                # unknown names (a typo must not silently fan out to every
                # worker; dynamic mode raises for the same mistake)
                steps.append(PlanStep(
                    id=str(role.get("id", f"step_{i + 1}")),
                    role=str(role.get("role", f"role_{i + 1}")),
                    models=list(role.get("models") or workers),
                    prompt=str(role.get("prompt",
                                        "Answer the request.")),
                    access_list=None if role.get("access_list") is None
                    else [str(a) for a in role["access_list"]]))
            plan = WorkflowPlan(steps=steps, final_model=cfg.final_model,
                                final_prompt=cfg.final_prompt)
            validate_plan(plan, workers, cfg)
            return plan, ""

        planner_model = cfg.planner_model or workers[0]
        prompt = build_planner_prompt(original, workers, cfg)
        resp = self._call({"messages": [{"role": "user", "content": prompt}],
                           "temperature": 0.0,
                           "max_tokens": cfg.planner_max_tokens},
                          planner_model, ctx)
        text = _content(resp) if resp else ""
        try:
            plan = parse_workflow_plan(text)
            if cfg.final_model:
                plan.final_model = cfg.final_model
            if cfg.final_prompt:
                plan.final_prompt = cfg.final_prompt
            validate_plan(plan, workers, cfg)
            return plan, text
        except ValueError as exc:
            if cfg.on_error != "skip":
                if ctx.errors:
                    raise ValueError(
                        f"{exc} (call errors: "
                        f"{'; '.join(ctx.errors[:4])})") from exc
                raise
            plan = fallback_plan(workers, original, cfg)
            validate_plan(plan, workers, cfg)
            return plan, text

    # -- step execution --------------------------------------------------

    def _step_prompt(self, step: PlanStep, original: str,
                     previous: List[dict]) -> str:
        visible = previous
        if step.access_list is not None:
            allowed = set(step.access_list)
            visible = [p for p in previous if p["id"] in allowed]
        parts = [step.prompt, f"\nOriginal request:\n{original}"]
        for p in visible:
            for r in p["responses"]:
                parts.append(
                    f"\n[{p['id']} · {r['model']}]\n{r['content'][:4000]}")
        return "\n".join(parts)

    def _run_steps(self, cfg: WorkflowConfig, plan: WorkflowPlan,
                   body: Dict[str, Any], original: str, ctx: _Ctx,
                   start_index: int, prior_results: List[dict],
                   trajectory: List[dict],
                   ) -> tuple[List[dict], Optional[LooperResponse]]:
        results = list(prior_results)
        for idx in range(start_index, len(plan.steps)):
            step = plan.steps[idx]
            prompt = self._step_prompt(step, original, results)
            messages = [{"role": "user", "content": prompt}]
            ask = {"messages": messages}
            if body.get("tools"):
                ask["tools"] = body["tools"]
            responses, pending = [], None
            deferred_tool_models = []
            # every model runs; max_parallel bounds CONCURRENCY (waves),
            # it never drops models from the step
            wave_size = max(1, cfg.max_parallel)
            for w in range(0, len(step.models), wave_size):
                wave = step.models[w:w + wave_size]
                futures = {m: self.pool.submit(self._call, ask, m, ctx)
                           for m in wave}
                for m, fut in futures.items():
                    resp = fut.result()
                    if resp is None:
                        continue
                    tool_calls = self._tool_calls(resp)
                    if tool_calls and pending is None:
                        pending = (m, resp, tool_calls, messages)
                    elif tool_calls:
                        # one pending interrupt at a time (reference
                        # parity); other tool-callers are recorded so the
                        # trace shows why their output is absent
                        deferred_tool_models.append(m)
                    elif _content(resp):
                        responses.append({"model": m,
                                          "content": _content(resp)})
                if pending is not None:
                    # stop dispatching further waves: they would be paid
                    # for and then discarded by the pause
                    break
            if pending is not None:
                if deferred_tool_models:
                    trajectory = trajectory + [{
                        "dropped_tool_models": deferred_tool_models}]
                return results, self._interrupt(
                    cfg, plan, body, idx, pending, responses, results,
                    trajectory, ctx, phase="step")
            if len(responses) < cfg.min_successful \
                    and cfg.on_error != "skip":
                detail = f" (call errors: {'; '.join(ctx.errors[:4])})" \
                    if ctx.errors else ""
                raise RuntimeError(
                    f"workflow step {step.id!r}: "
                    f"{len(responses)}/{cfg.min_successful} successful "
                    f"responses{detail}")
            results.append({"id": step.id, "role": step.role,
                            "responses": responses})
        return results, None

    # -- tool interrupt / resume ----------------------------------------

    @staticmethod
    def _tool_calls(resp: Dict[str, Any]) -> List[dict]:
        try:
            return (resp["choices"][0]["message"] or {}).get(
                "tool_calls") or []
        except (KeyError, IndexError, TypeError):
            return []

    def _interrupt(self, cfg: WorkflowConfig, plan: WorkflowPlan,
                   body: Dict[str, Any], step_index: int,
                   pending, sibling_responses: List[dict],
                   results: List[dict], trajectory: List[dict],
                   ctx: _Ctx, phase: str) -> LooperResponse:
        model, resp, tool_calls, messages = pending
        state_id = uuid.uuid4().hex[:16]
        assistant_msg = dict(resp["choices"][0]["message"])
        state = PendingToolState(
            state_id=state_id, phase=phase, step_index=step_index,
            model=model,
            messages=messages + [assistant_msg],
            plan=plan.to_dict(), step_results=results,
            sibling_responses=sibling_responses,
            original_body={k: v for k, v in body.items()
                           if k in ("messages", "tools", "model")},
            config=asdict(cfg), tool_trajectory=trajectory,
            usage=ctx.usage)  # pre-interrupt spend survives the pause
        self.state_store.put(state)

        # return the tool_calls to the CLIENT with the state id riding in
        # each id — the client runs the tools and sends results back
        out_calls = []
        for tc in tool_calls:
            tc = dict(tc)
            tc["id"] = make_interrupt_tool_call_id(
                state_id, str(tc.get("id", "")))
            out_calls.append(tc)
        out_msg = dict(assistant_msg)
        out_msg["tool_calls"] = out_calls
        resp_body = {
            "id": f"chatcmpl-{uuid.uuid4().hex[:24]}",
            "object": "chat.completion",
            "created": int(time.time()),
            "model": model,
            "choices": [{"index": 0, "message": out_msg,
                         "finish_reason": "tool_calls"}],
            "usage": resp.get("usage", {}),
        }
        return LooperResponse(resp_body, model, "workflows",
                              [model], {}, rounds=step_index + 1)

    def _resume(self, state_id: str, body: Dict[str, Any],
                ctx: _Ctx) -> LooperResponse:
        state = self.state_store.take(state_id)
        if state is None:
            raise RuntimeError(
                f"workflow state {state_id!r} expired or unknown")
        cfg = WorkflowConfig(**state.config)
        plan = WorkflowPlan.from_dict(state.plan)
        original = _last_user(state.original_body)
        # merge pre-interrupt usage so accounting covers the whole workflow
        for model, counts in (state.usage or {}).items():
            agg = ctx.usage.setdefault(model, {})
            for k, v in counts.items():
                agg[k] = agg.get(k, 0) + int(v)

        # trailing tool messages from the client, original ids restored
        tool_messages = []
        for msg in reversed(body.get("messages") or []):
            if msg.get("role") != "tool":
                break
            msg = dict(msg)
            tcid = str(msg.get("tool_call_id", ""))
            if parse_tool_call_state_id(tcid) == state_id:
                rest = tcid[len(TOOL_CALL_ID_PREFIX):]
                msg["tool_call_id"] = rest.split(TOOL_CALL_ID_SEP, 1)[1]
            tool_messages.append(msg)
        tool_messages.reverse()
        if not tool_messages:
            raise RuntimeError("workflow resume carries no tool results")

        messages = state.messages + tool_messages
        trajectory = state.tool_trajectory + [{
            "model": state.model,
            "tool_call_ids": [m.get("tool_call_id", "")
                              for m in tool_messages]}]
        ask = {"messages": messages}
        if state.original_body.get("tools"):
            ask["tools"] = state.original_body["tools"]
        resp = self._call(ask, state.model, ctx)
        if resp is None:
            raise RuntimeError(
                f"workflow resume call to {state.model!r} failed")
        tool_calls = self._tool_calls(resp)
        if tool_calls:  # the model chained another tool call
            return self._interrupt(
                cfg, plan, state.original_body, state.step_index,
                (state.model, resp, tool_calls, messages),
                state.sibling_responses, state.step_results, trajectory,
                ctx, phase=state.phase)

        if state.phase == "final":
            final_resp = resp
            return self._package(cfg, plan, final_resp,
                                 state.step_results, ctx, trajectory)

        responses = state.sibling_responses + [{
            "model": state.model, "content": _content(resp)}]
        results = state.step_results + [{
            "id": plan.steps[state.step_index].id,
            "role": plan.steps[state.step_index].role,
            "responses": responses}]
        step_results, interrupt = self._run_steps(
            cfg, plan, state.original_body, original, ctx,
            start_index=state.step_index + 1, prior_results=results,
            trajectory=trajectory)
        if interrupt is not None:
            return interrupt
        return self._finish(cfg, plan, state.original_body, original,
                            step_results, ctx, trajectory)

    # -- final synthesis + contracts ------------------------------------

    def _finish(self, cfg: WorkflowConfig, plan: WorkflowPlan,
                body: Dict[str, Any], original: str,
                step_results: List[dict], ctx: _Ctx,
                trajectory: List[dict]) -> LooperResponse:
        final_model = plan.final_model or cfg.final_model \
            or (plan.steps[-1].models[0] if plan.steps else "")
        final_prompt = plan.final_prompt or cfg.final_prompt or \
            "Synthesize the best final answer from the step outputs."
        parts = [final_prompt, f"\nOriginal request:\n{original}"]
        for p in step_results:
            for r in p["responses"]:
                parts.append(
                    f"\n[{p['id']} · {r['model']}]\n{r['content'][:4000]}")
        ask = {"messages": [{"role": "user",
                             "content": "\n".join(parts)}]}
        if body.get("tools"):
            ask["tools"] = body["tools"]
        resp = self._call(ask, final_model, ctx)
        if resp is not None:
            tool_calls = self._tool_calls(resp)
            if tool_calls:
                return self._interrupt(
                    cfg, plan, body, len(plan.steps) - 1,
                    (final_model, resp, tool_calls, ask["messages"]),
                    [], step_results, trajectory, ctx, phase="final")
        if resp is None or not _content(resp):
            # single-choice fallback: best worker answer
            # (applyWorkflowSingleChoiceFallback)
            if cfg.on_error != "skip":
                raise RuntimeError("workflow final synthesis failed")
            resp = self._fallback_final(step_results)
            if resp is None:
                raise RuntimeError(
                    "workflow final synthesis failed and no worker "
                    "responses to fall back to")
        return self._package(cfg, plan, resp, step_results, ctx,
                             trajectory)

    @staticmethod
    def _fallback_final(step_results: List[dict]) -> Optional[dict]:
        best = None
        for p in reversed(step_results):
            for r in p["responses"]:
                if best is None or len(r["content"]) > len(best[1]):
                    best = (r["model"], r["content"])
        if best is None:
            return None
        return {"choices": [{"message": {"role": "assistant",
                                         "content": best[1]},
                             "finish_reason": "stop"}],
                "model": best[0], "usage": {}}

    def _package(self, cfg: WorkflowConfig, plan: WorkflowPlan,
                 final_resp: dict, step_results: List[dict], ctx: _Ctx,
                 trajectory: List[dict]) -> LooperResponse:
        self._apply_contract(cfg.output_contract, final_resp, step_results)
        models_used = sorted({r["model"] for p in step_results
                              for r in p["responses"]}
                             | {final_resp.get("model", "")} - {""})
        trace = {
            "mode": cfg.mode,
            "plan": plan.to_dict(),
            "steps": step_results if cfg.include_intermediate else [
                {"id": p["id"], "role": p["role"],
                 "models": [r["model"] for r in p["responses"]]}
                for p in step_results],
            "tool_trajectory": trajectory,
        }
        final_resp.setdefault("vsr_annotations", {})[
            "workflow_trace"] = trace
        return LooperResponse(
            final_resp, final_resp.get("model", ""), "workflows",
            models_used, ctx.usage, rounds=len(step_results) + 1)

    @staticmethod
    def _apply_contract(contract: Dict[str, Any], resp: dict,
                        step_results: List[dict]) -> None:
        ctype = (contract or {}).get("type", "")
        if not ctype:
            return
        msg = resp["choices"][0]["message"]
        text = msg.get("content") or ""
        if ctype == "json_action":
            obj = extract_json_object(text)
            if obj is None:  # search candidates newest-first
                for p in reversed(step_results):
                    for r in p["responses"]:
                        obj = extract_json_object(r["content"])
                        if obj is not None:
                            break
                    if obj is not None:
                        break
            if obj is not None:
                msg["content"] = json.dumps(obj)
        elif ctype == "reference_selection":
            candidates = [r for p in step_results
                          for r in p["responses"]]
            m = re.search(r"\b(\d+)\b", text)
            if m and candidates:
                idx = int(m.group(1)) - int(
                    bool(contract.get("one_indexed", True)))
                if 0 <= idx < len(candidates):
                    msg["content"] = candidates[idx]["content"]

    # -- shared ----------------------------------------------------------

    def _call(self, ask: Dict[str, Any], model: str,
              ctx: _Ctx) -> Optional[Dict[str, Any]]:
        hdrs = dict(ctx.headers)
        try:
            if ctx.headers_for is not None:
                hdrs.update(ctx.headers_for(model))
            resp = self.client.complete(ask, model, headers=hdrs)
        except Exception as exc:
            # remember the real cause: a 401 must not surface as
            # "planner produced no JSON" / "0 successful responses"
            ctx.errors.append(f"{model}: {type(exc).__name__}: {exc}")
            return None
        u = resp.get("usage") or {}
        if u:
            agg = ctx.usage.setdefault(model, {})
            for k, v in u.items():
                if isinstance(v, (int, float)):
                    agg[k] = agg.get(k, 0) + int(v)
        return resp
