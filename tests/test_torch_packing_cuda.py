"""Sequence packing on the card, cut to tiny sizes: a fused group on dense
attention serves a mixed-length batch as a packed step, captured at its
first execution and replayed after; the packed step launches the head
epilogue (K2) as the unpacked step of its flavor does, and a wide bank
with BGMV launches K3 with pairs over segments; the results are within
1e-4 of the unpacked dense step on the card and of the CPU port's packed
step.  ``cuda``-marked: skips without a GPU.  Imports no JAX
(``python -m pytest --noconftest -m cuda tests/test_torch_packing_cuda.py``;
chip_smoke.py's phase 18 does)."""

import numpy as np
import pytest
import torch

from semantic_router_tpu_torch.config.schema import InferenceEngineConfig
from semantic_router_tpu_torch.engine.testing import (
    SHARED_TRUNK_TASKS,
    TINY,
    make_shared_trunk_engine,
)
from semantic_router_tpu_torch.ops import _cuda

TOL = 1e-4
TASKS = [name for name, _ in SHARED_TRUNK_TASKS]
TEXTS = ["hi", "what is the capital of france", "x",
         "sue them for breach of contract now and forever " * 2,
         "segfault in my rust program when the arena reallocs", "ok"]
PII = ("pii", ["O", "B-EMAIL_ADDRESS", "I-EMAIL_ADDRESS"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the heads run the K2 / K3 kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


def _engine(device, kernels, tasks=None, lora=("fact_check",)):
    return make_shared_trunk_engine(
        tasks=tasks, lora_tasks=lora, token_tasks=[PII], device=device,
        seed=6, engine_cfg=InferenceEngineConfig(
            max_batch_size=8, max_wait_ms=1.0, seq_len_buckets=[32, 128],
            kernels=kernels),
        model_config=dict(TINY, attention_impl="dense"))


def _same(got, want, tasks) -> None:
    for t in tasks:
        for g, w in zip(got[t], want[t]):
            assert g.label == w.label
            assert set(g.probs) == set(w.probs)
            assert max(abs(g.probs[k] - w.probs[k]) for k in g.probs) <= TOL


def _packed(steps):
    return [s for s in steps if s.get("variant", "").startswith("packed:")]


@pytest.mark.cuda
def test_packed_step_captures_replays_and_matches(cuda_device):
    kernels = {"epilogue": {"enabled": True}}
    card, cpu = _engine(cuda_device, kernels), _engine("cpu", kernels)
    try:
        want = cpu.classify_multi(TASKS, TEXTS)
        launches = []
        for _ in range(2):
            _cuda.reset_launch_counts()
            got = card.classify_multi(TASKS, TEXTS)
            launches.append(_cuda.launch_counts())
            _same(got, want, TASKS)
        packed = _packed(card.steps())
        assert [s["graph"] for s in packed] == ["captured", "replayed"]
        assert packed[0]["segments"] == len(TEXTS)
        assert launches[0] == launches[1]
        assert launches[0]["head_epilogue"] > 0
        assert launches[0]["flash_attention"] == 0   # dense attention
        # the unpacked step of the same flavor launches the same heads
        card.configure_packing({"enabled": False})
        _cuda.reset_launch_counts()
        plain = card.classify_multi(TASKS, TEXTS)
        assert _cuda.launch_counts()["head_epilogue"] == \
            launches[0]["head_epilogue"]
        assert card.steps()[-1].get("variant") is None
        _same(plain, got, TASKS)
    finally:
        card.shutdown()
        cpu.shutdown()


@pytest.mark.cuda
def test_packed_token_spans_match_the_cpu(cuda_device):
    kernels = {"epilogue": {"enabled": True}}
    card, cpu = _engine(cuda_device, kernels), _engine("cpu", kernels)
    try:
        from concurrent.futures import ThreadPoolExecutor

        def spans(eng):
            with ThreadPoolExecutor(max_workers=len(TEXTS)) as pool:
                return list(pool.map(lambda t: eng.token_classify(
                    "pii", t, threshold=0.0), TEXTS))

        for got, want in zip(spans(card), spans(cpu)):
            assert [(e.type, e.start, e.end) for e in got.entities] == \
                [(e.type, e.start, e.end) for e in want.entities]
            for a, b in zip(got.entities, want.entities):
                assert abs(a.score - b.score) <= TOL
    finally:
        card.shutdown()
        cpu.shutdown()


@pytest.mark.cuda
def test_wide_bank_packed_step_launches_bgmv_over_segments(cuda_device):
    tasks = [(f"tenant_{i:02d}", [f"l{j}" for j in range(2 + i % 5)])
             for i in range(10)]
    names = [n for n, _ in tasks]
    kernels = {"bgmv": {"enabled": True, "min_tasks": 8}}
    lora = names[1::2]
    card = _engine(cuda_device, kernels, tasks, lora)
    cpu = _engine("cpu", kernels, tasks, lora)
    try:
        want = cpu.classify_multi(names[:5], TEXTS)
        counts = []
        for _ in range(2):
            _cuda.reset_launch_counts()
            got = card.classify_multi(names[:5], TEXTS)
            counts.append(_cuda.launch_counts())
            _same(got, want, names[:5])
        packed = _packed(card.steps())
        assert [s["graph"] for s in packed] == ["captured", "replayed"]
        step = packed[-1]
        assert step["bgmv"] and step["pairs"] == 5 * step["segments"]
        assert counts[0]["bgmv"] > 0 and counts[0] == counts[1]
        # BGMV off on the card: the all-heads bank, the same results
        card.configure_kernels({})
        _same(card.classify_multi(names[:5], TEXTS), got, names[:5])
    finally:
        card.shutdown()
        cpu.shutdown()


@pytest.mark.cuda
def test_packed_warmup_replays_on_first_use(cuda_device):
    card = _engine(cuda_device, {"epilogue": {"enabled": True}})
    try:
        card.warmup(buckets=[32])
        census = card.packed_shape_census()["trunk0"]
        assert (32, 2, 1, "seq", 0) in census
        card.classify_multi(TASKS, ["a b", "c d"])
        step = _packed(card.steps())[-1]
        assert (step["k_pad"], step["padded_rows"]) == (2, 1)
        assert step["graph"] == "replayed"
        assert np.isfinite(step["seconds"])
    finally:
        card.shutdown()
