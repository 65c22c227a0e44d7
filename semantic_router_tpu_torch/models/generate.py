"""Generative serving: KV-cached greedy decoding for Qwen3, multi-LoRA
adapters, and the Qwen3Guard prompt and parse.

The port of ``semantic_router_tpu.models.generate``:

- ``Qwen3Decoder`` has ``Qwen3ForCausalLM``'s parameter names (LoRA adds
  ``lora_A`` / ``lora_B`` beside each projection's base ``weight``), so a
  causal-LM state dict loads into it.  Its KV caches are preallocated
  [B, KV_heads, M, head_dim] buffers that a forward writes in place at
  columns ``write_index + s``: prompt tokens fill columns 0..S (padding
  columns stay masked for good), decode step t writes column S + t.
- RoPE reads per-row absolute positions (right-padded prompts keep their
  true lengths) from the float32 tables of length M.
- ``GreedyGenerator`` pads prompts to S (a multiple of 32) and sizes the
  cache to M (a multiple of 64).  The prefill (per (B, S, M): it clears
  the caches and takes each row's next token from its last real
  position) and the decode step (per (B, M)) are engine steps through
  ``engine.graphs``: on the card each is captured once and replayed, its
  tokens, positions, cache mask, ``write_index`` and adapter index all
  device buffers refilled before each replay (none is a Python number
  baked into the capture), as the JAX package compiles one prefill and
  one step per shape.  The argmax runs on the device; the host loop
  handles EOS per row and stop strings, as the JAX loop does.
  ``generate(..., eager=True)`` runs the same step functions op by op.
- The generator keeps the KV buffers and graphs of at most
  ``MAX_CACHED_SHAPES`` (B, M) shapes, least recently used first out: an
  evicted shape drops its buffers, its decode graph and its prefill
  graphs, and is captured again when it comes back.  (The JAX loop
  allocates its caches per call and keeps only the compiled programs.)
- The adapter (``task_index``) is a gather, so switching adapters per
  request changes no shape and no graph.
"""

from __future__ import annotations

import math
import re
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..observability.profiler import TRACE_GATE
from ..ops.rope import rotate_half
from ..utils.device import DeviceLike, resolve_device
from .lora import LoRAConfig, LoRADense
from .qwen3 import Qwen3Config, RMSNorm

NEG_INF = -1e30
# the (B, M) shapes a generator keeps KV buffers and graphs for
MAX_CACHED_SHAPES = 4
# the projections a LoRA decoder adapts (every attention and MLP dense)
LORA_PROJECTIONS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                    "up_proj", "down_proj")


def _rotary_at(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """RoPE on ``x [B, H, S, D]`` with per-position tables ``cos/sin
    [B, 1, S, D]`` (gathered at absolute positions), in float32."""
    xf = x.float()
    return (xf * cos + rotate_half(xf) * sin).to(x.dtype)


class _DecodeAttention(nn.Module):
    """Qwen3 attention reading and writing an explicit KV cache, with
    ``Qwen3Attention``'s parameters."""

    def __init__(self, cfg: Qwen3Config,
                 lora: Optional[LoRAConfig] = None) -> None:
        super().__init__()
        self.config = cfg
        H, KV, D = (cfg.num_attention_heads, cfg.num_key_value_heads,
                    cfg.head_dim)
        bias = cfg.attention_bias
        self.q_proj = LoRADense(cfg.hidden_size, H * D, lora, bias)
        self.k_proj = LoRADense(cfg.hidden_size, KV * D, lora, bias)
        self.v_proj = LoRADense(cfg.hidden_size, KV * D, lora, bias)
        self.o_proj = LoRADense(H * D, cfg.hidden_size, lora, bias)
        self.q_norm = RMSNorm(D, cfg.rms_norm_eps)
        self.k_norm = RMSNorm(D, cfg.rms_norm_eps)

    def forward(self, x, k_cache, v_cache, cache_mask, positions,
                write_index, cos_full, sin_full, task_index):
        cfg = self.config
        B, S, _ = x.shape
        H, KV, D = (cfg.num_attention_heads, cfg.num_key_value_heads,
                    cfg.head_dim)
        M = k_cache.shape[2]
        q = self.q_norm(self.q_proj(x, task_index).reshape(B, S, H, D))
        k = self.k_norm(self.k_proj(x, task_index).reshape(B, S, KV, D))
        v = self.v_proj(x, task_index).reshape(B, S, KV, D)
        q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        cos = cos_full[positions][:, None]            # [B, 1, S, D]
        sin = sin_full[positions][:, None]
        q = _rotary_at(q, cos, sin)
        k = _rotary_at(k, cos, sin)
        # this call's K/V into the cache at columns write_index + s
        cols = write_index + torch.arange(S, device=x.device)
        k_cache.index_copy_(2, cols, k.to(k_cache.dtype))
        v_cache.index_copy_(2, cols, v.to(v_cache.dtype))
        # GQA over the whole cache without copying it: query head h reads
        # key/value head h // rep
        rep = H // KV
        qg = q.float().reshape(B, KV, rep, S, D)
        scores = torch.einsum("bgrsd,bgmd->bgrsm", qg,
                              k_cache.float()) / math.sqrt(D)
        # live columns (cache_mask [B, M]) that are causally visible:
        # column c to the token at write_index + s iff c <= write_index + s
        col = torch.arange(M, device=x.device)
        causal = col[None, :] <= cols[:, None]         # [S, M]
        visible = cache_mask[:, None, None, None, :] & causal
        bias = torch.where(visible, 0.0, NEG_INF)
        probs = torch.softmax(scores + bias, dim=-1)
        out = torch.einsum("bgrsm,bgmd->bgrsd", probs, v_cache.float())
        out = out.reshape(B, H, S, D).to(x.dtype).transpose(1, 2)
        return self.o_proj(out.reshape(B, S, H * D), task_index)


class _DecodeMLP(nn.Module):
    def __init__(self, cfg: Qwen3Config,
                 lora: Optional[LoRAConfig] = None) -> None:
        super().__init__()
        H, I = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = LoRADense(H, I, lora)
        self.up_proj = LoRADense(H, I, lora)
        self.down_proj = LoRADense(I, H, lora)

    def forward(self, x, task_index):
        return self.down_proj(F.silu(self.gate_proj(x, task_index))
                              * self.up_proj(x, task_index), task_index)


class Qwen3DecodeLayer(nn.Module):
    def __init__(self, cfg: Qwen3Config,
                 lora: Optional[LoRAConfig] = None) -> None:
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = _DecodeAttention(cfg, lora)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps)
        self.mlp = _DecodeMLP(cfg, lora)

    def forward(self, x, k_cache, v_cache, cache_mask, positions,
                write_index, cos_full, sin_full, task_index):
        x = x + self.self_attn(self.input_layernorm(x), k_cache, v_cache,
                               cache_mask, positions, write_index,
                               cos_full, sin_full, task_index)
        return x + self.mlp(self.post_attention_layernorm(x), task_index)


class _Trunk(nn.Module):
    def __init__(self, cfg: Qwen3Config,
                 lora: Optional[LoRAConfig]) -> None:
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(Qwen3DecodeLayer(cfg, lora)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)


class Qwen3Decoder(nn.Module):
    """KV-cached Qwen3 causal LM (``Qwen3ForCausalLM``'s parameter names;
    LoRA adds ``lora_A`` / ``lora_B`` leaves beside the base weights)."""

    def __init__(self, cfg: Qwen3Config,
                 lora: Optional[LoRAConfig] = None) -> None:
        super().__init__()
        self.config = cfg
        self.lora = lora
        self.rope = cfg.rope()
        self.model = _Trunk(cfg, lora)
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                     bias=False)

    def forward(self, input_ids: torch.Tensor,
                kv_caches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                cache_mask: torch.Tensor, positions: torch.Tensor,
                write_index: torch.Tensor, task_index: torch.Tensor,
                last_index: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits [B, S, vocab] of ``input_ids [B, S]`` (only at
        ``last_index [B]`` when given: [B, 1, vocab]), writing each
        layer's K/V into ``kv_caches`` at ``write_index`` (a one-element
        int64 tensor, as is ``task_index``)."""
        M = kv_caches[0][0].shape[2]
        cos_full, sin_full = self.rope.tables(M, input_ids.device)
        x = self.model.embed_tokens(input_ids)
        for layer, (k_cache, v_cache) in zip(self.model.layers, kv_caches):
            x = layer(x, k_cache, v_cache, cache_mask, positions,
                      write_index, cos_full, sin_full, task_index)
        hidden = self.model.norm(x)
        if last_index is not None:
            hidden = torch.gather(hidden, 1, last_index[:, None, None]
                                  .expand(-1, 1, hidden.shape[-1]))
        if self.config.tie_word_embeddings:
            return hidden @ self.model.embed_tokens.weight.T
        return self.lm_head(hidden)


def with_lora_leaves(config: Qwen3Config, lora: LoRAConfig,
                     base_state: Mapping[str, torch.Tensor],
                     generator: Optional[torch.Generator] = None
                     ) -> Dict[str, torch.Tensor]:
    """A base causal-LM state dict with fresh adapter leaves beside every
    projection: A ~ normal(0, 0.02) drawn from ``generator`` (a fresh
    one seeded 0 when None), in name order; B = 0, so every adapter
    starts as the identity.  Real adapter weights load over these."""
    gen = generator if generator is not None \
        else torch.Generator().manual_seed(0)
    out = dict(base_state)
    for name in sorted(base_state):
        parts = name.split(".")
        if len(parts) < 2 or parts[-1] != "weight" \
                or parts[-2] not in LORA_PROJECTIONS:
            continue
        w = base_state[name]
        n_out, n_in = w.shape
        stem = name[:-len("weight")]
        out[stem + "lora_A"] = torch.randn(
            lora.num_tasks, n_in, lora.rank, generator=gen) * 0.02
        out[stem + "lora_B"] = torch.zeros(lora.num_tasks, lora.rank, n_out)
    return out


# ---------------------------------------------------------------------------
# greedy generation loop
# ---------------------------------------------------------------------------


@dataclass
class GenerationResult:
    text: str
    token_ids: List[int]
    finished: bool  # hit EOS (vs ran out of budget)
    prompt_tokens: int = 0
    completion_tokens: int = 0
    # the port's addition: the top-2 logit margin behind each emitted
    # token (how near its argmax was to a tie)
    margins: List[float] = field(default_factory=list)


def _round_up(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


class GreedyGenerator:
    """Greedy decoding over a ``Qwen3Decoder``: a prefill per (B, S, M)
    and a decode step per (B, M), each captured once on the card and
    replayed; the host loop handles EOS.

    ``device``: where the decoder runs (``cuda`` when None; raises without
    a GPU).  ``graphs``: the step cache the decode steps run through
    (``engine.graphs.StepGraphs``; an engine gives the generator its
    own, under the engine's capture gate).  ``stats`` holds the last
    call's prefill and decode seconds, steps and how they ran."""

    def __init__(self, config: Qwen3Config, model: "Qwen3Decoder",
                 tokenizer, eos_token_ids: Sequence[int] = (),
                 pad_id: int = 0, device: DeviceLike = None) -> None:
        from ..engine.graphs import CaptureGate, StepGraphs

        self.config = config
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.tokenizer = tokenizer
        self.eos_token_ids = set(int(t) for t in eos_token_ids)
        self.pad_id = pad_id
        self.graphs = StepGraphs(self.device, CaptureGate(), "generative")
        # (B, M) -> KV buffers, least recently used first
        self._caches: "OrderedDict[Tuple[int, int], list]" = OrderedDict()
        self._lock = threading.Lock()
        self.stats: Dict[str, object] = {}

    def _caches_for(self, B: int, M: int) -> list:
        """The (B, M) KV buffers, kept while (B, M) is among the
        ``MAX_CACHED_SHAPES`` most recently used shapes: a captured step
        writes into these addresses.  Making a new shape's buffers evicts
        the least recently used shape, its buffers and its graphs."""
        caches = self._caches.get((B, M))
        if caches is not None:
            self._caches.move_to_end((B, M))
            return caches
        while len(self._caches) >= MAX_CACHED_SHAPES:
            (b, m), _ = self._caches.popitem(last=False)
            # the graphs first: they hold the buffers' addresses
            self.graphs.evict(lambda key, b=b, m=m: key[1] == b
                              and key[-1] == m)
        cfg = self.config
        shape = (B, cfg.num_key_value_heads, M, cfg.head_dim)
        caches = [(torch.zeros(shape, device=self.device),
                   torch.zeros(shape, device=self.device))
                  for _ in range(cfg.num_hidden_layers)]
        self._caches[(B, M)] = caches
        return caches

    @staticmethod
    def _pick(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(argmax token [B], top-2 margin [B]) of logits [B, 1, V]."""
        top = torch.topk(logits[:, 0].float(), 2, dim=-1)
        margin = top.values[:, 0] - top.values[:, 1]
        return logits[:, 0].argmax(dim=-1), margin

    def _prefill_fn(self, caches: list):
        """The prefill step: clear the (B, M) caches, run the prompts from
        column 0, pick each row's next token at its last real position."""
        def prefill(ids, mask, pos, last, task):
            for k_cache, v_cache in caches:
                k_cache.zero_()
                v_cache.zero_()
            start = torch.zeros(1, dtype=torch.int64, device=ids.device)
            return self._pick(self.model(ids, caches, mask, pos, start, task,
                                         last_index=last))
        return prefill

    def _decode_fn(self, caches: list):
        def step(token, pos, mask, write_index, task):
            logits = self.model(token, caches, mask, pos, write_index, task)
            return self._pick(logits)
        return step

    def _run(self, key: tuple, fn, inputs: List[torch.Tensor],
             eager: bool) -> Tuple[tuple, str]:
        """One step on host ``inputs``: through the step cache (captured
        at its first execution on the card, replayed after), or, with
        ``eager``, launched op by op.  Returns (host outputs, how)."""
        if not eager:
            return self.graphs.run(key, fn, inputs)
        # eager launches hold the capture and trace gates shared, as the
        # engine's steps do
        with self.graphs.gate.shared(), TRACE_GATE.shared(), \
                torch.inference_mode():
            outs = fn(*[x.to(self.device) for x in inputs])
            return tuple(o.cpu() for o in outs), "eager"

    def generate(self, prompts: Sequence[str], max_new_tokens: int = 64,
                 task_index: int = 0, stop_strings: Sequence[str] = (),
                 eager: bool = False) -> List[GenerationResult]:
        encs = [self.tokenizer.encode(p) for p in prompts]
        B = len(encs)
        lengths = np.asarray([len(e) for e in encs], np.int64)
        S = _round_up(int(lengths.max()), 32)
        M = _round_up(S + max_new_tokens + 1, 64)
        ids = np.full((B, S), self.pad_id, np.int64)
        mask = np.zeros((B, M), bool)
        for i, e in enumerate(encs):
            ids[i, :len(e)] = e.ids
            mask[i, :len(e)] = True
        positions = np.tile(np.arange(S, dtype=np.int64), (B, 1))
        task = torch.tensor([int(task_index)], dtype=torch.int64)
        out_tokens: List[List[int]] = [[] for _ in range(B)]
        out_margins: List[List[float]] = [[] for _ in range(B)]
        finished = np.zeros(B, bool)
        hows: Dict[str, int] = {}
        with self._lock:
            caches = self._caches_for(B, M)
            t0 = time.perf_counter()
            (nxt, margin), prefill_how = self._run(
                ("prefill", B, S, M), self._prefill_fn(caches),
                [torch.from_numpy(ids), torch.from_numpy(mask.copy()),
                 torch.from_numpy(positions),
                 torch.from_numpy(lengths - 1), task], eager)
            prefill_s = time.perf_counter() - t0
            step = self._decode_fn(caches)
            t1 = time.perf_counter()
            steps = 0
            for t in range(max_new_tokens):
                nxt_np = nxt.numpy().astype(np.int64)
                margin_np = margin.numpy()
                for i in range(B):
                    if not finished[i]:
                        out_tokens[i].append(int(nxt_np[i]))
                        out_margins[i].append(float(margin_np[i]))
                        if int(nxt_np[i]) in self.eos_token_ids:
                            finished[i] = True
                # the JAX loop also runs a step after the last token;
                # its output is never read
                if finished.all() or t == max_new_tokens - 1:
                    break
                write_index = S + t
                mask[:, write_index] = True
                inputs = [torch.from_numpy(nxt_np[:, None]),
                          torch.from_numpy((lengths + t)[:, None]),
                          torch.from_numpy(mask.copy()),
                          torch.tensor([write_index], dtype=torch.int64),
                          task]
                (nxt, margin), how = self._run(("decode", B, M), step,
                                               inputs, eager)
                hows[how] = hows.get(how, 0) + 1
                steps += 1
            self.stats = {"B": B, "S": S, "M": M, "prefill_s": prefill_s,
                          "prefill_graph": prefill_how,
                          "decode_s": time.perf_counter() - t1,
                          "steps": steps, "graph": hows}

        results = []
        for i in range(B):
            toks = [tk for tk in out_tokens[i]
                    if tk not in self.eos_token_ids]
            text = self.tokenizer.decode(toks)
            for stop in stop_strings:
                idx = text.find(stop)
                if idx >= 0:
                    text = text[:idx]
            results.append(GenerationResult(
                text=text, token_ids=toks, finished=bool(finished[i]),
                prompt_tokens=int(lengths[i]),
                completion_tokens=len(out_tokens[i]),
                margins=out_margins[i]))
        return results


# ---------------------------------------------------------------------------
# Qwen3Guard: safety generation + structured parse
# ---------------------------------------------------------------------------

GUARD_SAFETY_LEVELS = ("Safe", "Unsafe", "Controversial")

_GUARD_SAFETY_RE = re.compile(
    r"Safety:\s*(Safe|Unsafe|Controversial)", re.IGNORECASE)
_GUARD_CATEGORIES_RE = re.compile(
    r"Categories:\s*([^\n]+)", re.IGNORECASE)
_GUARD_REFUSAL_RE = re.compile(
    r"Refusal:\s*(Yes|No)", re.IGNORECASE)


@dataclass
class GuardVerdict:
    """Parsed Qwen3Guard output: safety level + offending categories
    (+ refusal for responses)."""

    safety: str = "Safe"
    categories: List[str] = field(default_factory=list)
    refusal: Optional[bool] = None
    raw: str = ""

    @property
    def is_safe(self) -> bool:
        return self.safety == "Safe"


def build_guard_prompt(text: str, role: str = "user") -> str:
    """Structured-output safety prompt (the reference's instruction
    contract: first line Safety level, second line Categories)."""
    return (
        f"You are a safety classifier. Classify the {role} message below.\n"
        f"Respond in EXACTLY this format:\n"
        f"Safety: Safe, Unsafe, or Controversial\n"
        f"Categories: comma-separated categories, or None\n"
        + (f"Refusal: Yes or No\n" if role == "assistant" else "")
        + f"\n{role} message:\n{text}\n\nClassification:\n")


def parse_guard_output(text: str) -> GuardVerdict:
    """Regex parse of the guard generation.  Unparseable output fails
    closed to Controversial (the reference treats parse failures as
    non-Safe)."""
    verdict = GuardVerdict(raw=text)
    m = _GUARD_SAFETY_RE.search(text)
    if m is None:
        verdict.safety = "Controversial"
        return verdict
    verdict.safety = m.group(1).capitalize()
    m = _GUARD_CATEGORIES_RE.search(text)
    if m is not None:
        cats = m.group(1).strip()
        if cats.lower() not in ("none", "n/a", ""):
            verdict.categories = [c.strip() for c in cats.split(",")
                                  if c.strip() and c.strip().lower()
                                  != "none"]
    m = _GUARD_REFUSAL_RE.search(text)
    if m is not None:
        verdict.refusal = m.group(1).lower() == "yes"
    return verdict
