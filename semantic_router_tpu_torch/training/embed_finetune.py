"""Embedding-model training on one device: cache embeddings (MNR) and
domain adaptation (iterative hard-negative mining).  The port of
``semantic_router_tpu.training.embed_finetune``.

- ``finetune_cache_embeddings``: LoRA fine-tune of the embedding trunk
  with the Multiple Negatives Ranking loss over (anchor, positive) pairs;
  the trained artifact is the adapter stack.
- ``finetune_domain_embeddings``: embed the corpus with the current
  model, mine the negatives that rank too close to the gold document,
  train with a margin triplet loss, re-mine, ``iterations`` rounds.

Only the adapters train, with Adam (no weight decay), as the JAX
trainer's ``optax.adam``; the base is frozen.  Every pair is tokenized to
one fixed length, so a step's shapes never change, and ``embed_texts``
pads its last batch to the fixed batch size and runs under
``torch.inference_mode``.  Entry points run on ``cuda`` unless the caller
names another device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..utils.device import DeviceLike, resolve_device
from ..utils.tokenization import HashTokenizer, Tokenizer

# -- synthetic data (zero-egress image: no public triplet sets) -----------

_DOMAIN_TOPICS = {
    "programming": ["binary search", "hash map", "rest api",
                    "race condition", "unit test", "garbage collector",
                    "b-tree index", "coroutine"],
    "finance": ["compound interest", "balance sheet", "index fund",
                "amortization", "hedging", "liquidity ratio",
                "options pricing", "credit spread"],
    "medical": ["hypertension", "insulin resistance", "mri contrast",
                "antibiotic resistance", "triage protocol",
                "clinical trial", "pathogen screening", "dosage titration"],
}

_PARAPHRASES = [
    "how does {t} work",
    "explain {t} to me",
    "what is {t} and why does it matter",
    "give me an overview of {t}",
    "can you describe {t} in simple terms",
    "i need help understanding {t}",
]

_DOC_TEMPLATES = [
    "{t} is a core concept: it is defined by its mechanism and its "
    "typical failure modes, and practitioners rely on it daily.",
    "reference notes on {t}: definition, common pitfalls, and three "
    "worked examples with step-by-step reasoning.",
]


@dataclasses.dataclass
class PairSet:
    """(anchor, positive) pairs plus a retrieval corpus for mining/eval."""

    anchors: List[str]
    positives: List[str]
    corpus: List[str]          # positives live in here too
    gold: List[int]            # corpus index of each anchor's gold doc


def synthetic_pair_dataset(domain: str = "programming", n: int = 96,
                           seed: int = 0) -> PairSet:
    """Deterministic paraphrase pairs: two phrasings of the same topic are
    a positive pair; every other topic's docs are (hard-ish) negatives."""
    topics = _DOMAIN_TOPICS.get(domain, _DOMAIN_TOPICS["programming"])
    rng = np.random.default_rng(seed)
    corpus = []
    topic_doc = {}
    for t in topics:
        topic_doc[t] = len(corpus)
        corpus.append(_DOC_TEMPLATES[0].format(t=t))
        corpus.append(_DOC_TEMPLATES[1].format(t=t))
    anchors, positives, gold = [], [], []
    for i in range(n):
        t = topics[i % len(topics)]
        a, b = rng.choice(len(_PARAPHRASES), size=2, replace=False)
        anchors.append(_PARAPHRASES[a].format(t=t))
        positives.append(_PARAPHRASES[b].format(t=t))
        gold.append(topic_doc[t])
    return PairSet(anchors, positives, corpus, gold)


def load_pairs_jsonl(path: str) -> PairSet:
    """Rows: {"anchor": ..., "positive": ..., ["negative": ...]} —
    the triplets.jsonl shape of the reference's generate_training_data."""
    anchors, positives, corpus, gold = [], [], [], []
    seen: Dict[str, int] = {}
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            row = json.loads(line)
            anchors.append(row["anchor"])
            pos = row["positive"]
            if pos not in seen:
                seen[pos] = len(corpus)
                corpus.append(pos)
            positives.append(pos)
            gold.append(seen[pos])
            neg = row.get("negative")
            if neg and neg not in seen:
                seen[neg] = len(corpus)
                corpus.append(neg)
    return PairSet(anchors, positives, corpus, gold)


# -- losses ---------------------------------------------------------------


def mnr_loss(emb_a: torch.Tensor, emb_p: torch.Tensor,
             temperature: float = 0.05) -> torch.Tensor:
    """Multiple Negatives Ranking: for L2-normalized towers the BxB cosine
    matrix's diagonal is the positive; every off-diagonal entry is an
    in-batch negative.  Cross-entropy toward the diagonal."""
    sims = (emb_a @ emb_p.T) / temperature          # [B, B]
    logp = torch.log_softmax(sims, dim=-1)
    return -logp.diagonal().mean()


def triplet_margin_loss(emb_a: torch.Tensor, emb_p: torch.Tensor,
                        emb_n: torch.Tensor,
                        margin: float = 0.1) -> torch.Tensor:
    """Cosine triplet loss with the reference's small margin."""
    pos = (emb_a * emb_p).sum(-1)
    neg = (emb_a * emb_n).sum(-1)
    return torch.clamp(margin - pos + neg, min=0.0).mean()


# -- training -------------------------------------------------------------


@dataclasses.dataclass
class EmbedTrainConfig:
    seq_len: int = 64
    batch_size: int = 16
    steps: int = 60
    learning_rate: float = 5e-4
    lora_rank: int = 8
    temperature: float = 0.05
    margin: float = 0.1
    iterations: int = 2           # domain adaptation mining rounds
    hard_neg_rank: int = 3        # mine negatives ranked at/after this
    seed: int = 0


def _tokenize_batch(tok: Tokenizer, texts: Sequence[str], seq_len: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    ids = np.zeros((len(texts), seq_len), np.int32)
    mask = np.zeros((len(texts), seq_len), np.int32)
    for i, t in enumerate(texts):
        enc = tok.encode(t, max_length=seq_len)
        n = min(len(enc.ids), seq_len)
        ids[i, :n] = enc.ids[:n]
        mask[i, :n] = 1
    return ids, mask


def default_embed_config():
    """The JAX trainer's default embedder trunk: hidden 128, 2 layers."""
    from ..models.modernbert import ModernBertConfig

    return ModernBertConfig(
        hidden_size=128, intermediate_size=256, num_hidden_layers=2,
        num_attention_heads=4, vocab_size=2048, pad_token_id=0)


def _make_lora_embedder(cfg: EmbedTrainConfig, model_cfg=None,
                        base_params: Optional[Dict[str, torch.Tensor]] = None,
                        device: DeviceLike = None):
    """(``LoRAMmBertEmbeddingModel`` on ``device``, its trunk config): the
    weights are ``base_params`` (a state dict) or fresh from
    ``torch.Generator`` seed ``cfg.seed``."""
    from ..models.lora import LoRAConfig, LoRAMmBertEmbeddingModel
    from .finetune import build_lora_module

    mcfg = model_cfg or default_embed_config()
    module = LoRAMmBertEmbeddingModel(
        mcfg, LoRAConfig(rank=cfg.lora_rank, num_tasks=1))
    return build_lora_module(module, cfg.seed, base_params, device), mcfg


def make_adapter_adam(module: nn.Module,
                      learning_rate: float) -> torch.optim.Adam:
    """Adam (optax's ``b1``, ``b2``, ``eps``; no weight decay) over
    ``module``'s adapters; the base frozen."""
    from ..parallel.train_step import trainable_parameters

    return torch.optim.Adam(trainable_parameters(module), lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-8)


def _train(module: nn.Module, batches: Callable[[int], Tuple],
           cfg: EmbedTrainConfig, loss_kind: str) -> List[Dict[str, float]]:
    """Adapter-only optimization of ``module`` in place
    (``make_adapter_adam``).  ``batches(step)`` yields numpy (ids, mask)
    pairs: two towers for ``pair`` (MNR), three for ``triplet``."""
    opt = make_adapter_adam(module, cfg.learning_rate)
    device = next(module.parameters()).device
    module.train()
    history: List[Dict[str, float]] = []
    for i in range(cfg.steps):
        arrs = [torch.from_numpy(a).to(device) for a in batches(i)]
        towers = [module(arrs[j], arrs[j + 1]).float()
                  for j in range(0, len(arrs), 2)]
        if loss_kind == "pair":
            loss = mnr_loss(towers[0], towers[1], cfg.temperature)
        else:
            loss = triplet_margin_loss(*towers, cfg.margin)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if (i + 1) % 20 == 0 or i == cfg.steps - 1:
            history.append({"step": i + 1, "loss": loss.item()})
    module.eval()
    return history


def finetune_cache_embeddings(pairs: PairSet,
                              cfg: Optional[EmbedTrainConfig] = None,
                              tokenizer: Optional[Tokenizer] = None,
                              module: Optional[nn.Module] = None,
                              base_params: Optional[
                                  Dict[str, torch.Tensor]] = None,
                              device: DeviceLike = None):
    """LoRA + MNR cache-embedding fine-tune of ``module`` in place (when
    None, the default LoRA embedder with ``base_params`` or seeded weights
    on ``device``).  Returns (module, history); the adapters are the only
    parameters that change."""
    cfg = cfg or EmbedTrainConfig()
    tok = tokenizer or HashTokenizer(vocab_size=2048)
    if module is None:
        module, _ = _make_lora_embedder(cfg, None, base_params, device)
    rng = np.random.default_rng(cfg.seed)
    n = len(pairs.anchors)

    def batches(step: int):
        idx = rng.choice(n, size=min(cfg.batch_size, n), replace=False)
        ia, ma = _tokenize_batch(tok, [pairs.anchors[i] for i in idx],
                                 cfg.seq_len)
        ip, mp = _tokenize_batch(tok, [pairs.positives[i] for i in idx],
                                 cfg.seq_len)
        return ia, ma, ip, mp

    history = _train(module, batches, cfg, "pair")
    return module, history


def embed_texts(module: nn.Module, tok: Tokenizer, texts: Sequence[str],
                seq_len: int, batch: int = 32) -> np.ndarray:
    """Batched embedding under ``torch.inference_mode`` on the module's
    device; the last batch pads up to the fixed ``batch`` shape, so every
    call runs the one shape (mining re-embeds the corpus every round)."""
    device = next(module.parameters()).device
    out = []
    with torch.inference_mode():
        for i in range(0, len(texts), batch):
            chunk = list(texts[i:i + batch])
            n = len(chunk)
            chunk += [""] * (batch - n)
            ids, mask = _tokenize_batch(tok, chunk, seq_len)
            emb = module(torch.from_numpy(ids).to(device),
                         torch.from_numpy(mask).to(device))
            out.append(emb.float().cpu().numpy()[:n])
    return np.concatenate(out, axis=0)


def mine_hard_negatives(module: nn.Module, tok: Tokenizer, pairs: PairSet,
                        cfg: EmbedTrainConfig) -> List[int]:
    """For each anchor: rank the corpus with the CURRENT model; the hard
    negative is the best-ranked non-gold document at/after
    ``hard_neg_rank`` (documents the model currently confuses with
    gold)."""
    qa = embed_texts(module, tok, pairs.anchors, cfg.seq_len)
    dc = embed_texts(module, tok, pairs.corpus, cfg.seq_len)
    sims = qa @ dc.T
    negs = []
    for qi in range(len(pairs.anchors)):
        order = np.argsort(-sims[qi])
        non_gold = [int(d) for d in order if int(d) != pairs.gold[qi]]
        if not non_gold:
            raise ValueError(
                "cannot mine hard negatives: corpus has no non-gold "
                f"document for anchor {qi} ({pairs.anchors[qi]!r}) — "
                "add negatives or more corpus documents")
        pick = non_gold[min(cfg.hard_neg_rank - 1, len(non_gold) - 1)]
        negs.append(pick)
    return negs


def finetune_domain_embeddings(pairs: PairSet,
                               cfg: Optional[EmbedTrainConfig] = None,
                               tokenizer: Optional[Tokenizer] = None,
                               module: Optional[nn.Module] = None,
                               device: DeviceLike = None):
    """Iterative hard-negative-mined domain adaptation: mine → triplet
    train → re-mine, ``cfg.iterations`` rounds, on ``module`` in place (a
    fresh seeded LoRA embedder on ``device`` when None).  Returns (module,
    per-round history)."""
    cfg = cfg or EmbedTrainConfig()
    tok = tokenizer or HashTokenizer(vocab_size=2048)
    if module is None:
        module, _ = _make_lora_embedder(cfg, device=device)
    rng = np.random.default_rng(cfg.seed)
    n = len(pairs.anchors)
    all_history: List[Dict[str, float]] = []
    gold_texts = [pairs.corpus[g] for g in pairs.gold]

    for rnd in range(cfg.iterations):
        negs = mine_hard_negatives(module, tok, pairs, cfg)
        neg_texts = [pairs.corpus[j] for j in negs]

        def batches(step: int):
            idx = rng.choice(n, size=min(cfg.batch_size, n), replace=False)
            ia, ma = _tokenize_batch(tok, [pairs.anchors[i] for i in idx],
                                     cfg.seq_len)
            ip, mp = _tokenize_batch(tok, [gold_texts[i] for i in idx],
                                     cfg.seq_len)
            in_, mn = _tokenize_batch(tok, [neg_texts[i] for i in idx],
                                      cfg.seq_len)
            return ia, ma, ip, mp, in_, mn

        history = _train(module, batches, cfg, "triplet")
        for h in history:
            h["round"] = rnd
        all_history.extend(history)
    return module, all_history


def evaluate_retrieval_mrr(module: nn.Module, tok: Tokenizer,
                           pairs: PairSet, seq_len: int, k: int = 5) -> float:
    """MRR@k over the pair set's corpus (the reference reports MRR@5)."""
    qa = embed_texts(module, tok, pairs.anchors, seq_len)
    dc = embed_texts(module, tok, pairs.corpus, seq_len)
    sims = qa @ dc.T
    rr = 0.0
    for qi in range(len(pairs.anchors)):
        order = np.argsort(-sims[qi])[:k]
        hits = np.where(order == pairs.gold[qi])[0]
        if hits.size:
            rr += 1.0 / (1 + int(hits[0]))
    return rr / len(pairs.anchors)


def save_embedding_adapters(module: nn.Module, path: str) -> None:
    from .finetune import save_adapters

    save_adapters(module, path)


def load_embedding_adapters(module: nn.Module, path: str) -> nn.Module:
    from .finetune import load_adapters

    return load_adapters(module, path)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="cache / domain embedding fine-tune")
    ap.add_argument("--mode", choices=["cache", "domain"], default="cache")
    ap.add_argument("--domain", default="programming")
    ap.add_argument("--train-data", default="",
                    help="triplets.jsonl (anchor/positive[/negative])")
    ap.add_argument("--output", default="models/cache-lora")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--iterations", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs on the host)")
    args = ap.parse_args(argv)

    resolve_device(args.device)  # no GPU and no --device: fail before work
    pairs = (load_pairs_jsonl(args.train_data) if args.train_data
             else synthetic_pair_dataset(args.domain))
    cfg = EmbedTrainConfig(steps=args.steps, iterations=args.iterations)
    tok = HashTokenizer(vocab_size=2048)
    if args.mode == "cache":
        module, history = finetune_cache_embeddings(
            pairs, cfg, tokenizer=tok, device=args.device)
    else:
        module, history = finetune_domain_embeddings(
            pairs, cfg, tokenizer=tok, device=args.device)
    mrr = evaluate_retrieval_mrr(module, tok, pairs, cfg.seq_len)
    os.makedirs(args.output, exist_ok=True)
    save_embedding_adapters(module, os.path.join(args.output,
                                                 "adapters.npz"))
    with open(os.path.join(args.output, "history.json"), "w") as f:
        json.dump({"history": history, "mrr": mrr}, f, indent=2)
    print(json.dumps({"mode": args.mode, "mrr": round(mrr, 4),
                      "final_loss": history[-1]["loss"] if history else None}))


if __name__ == "__main__":
    main()
