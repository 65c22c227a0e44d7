"""The dual-path engine and the LoRA trunk on the card, cut to tiny sizes:
``classify_multi`` on both paths of an engine whose four LoRA-head tasks
form one trunk group and one stacked bank gives the CPU port's labels
and probabilities (1e-4), each path's step captured once and replayed
after, K1 launched once a layer a pass on each path and K2 on the
traditional side only; a ``LoRAModernBertForSequenceClassification``
served as one captured step switches ``task_index`` across its adapters
with no new capture and the CPU's logits.  ``cuda``-marked: skips
without a GPU.  Imports no JAX (``python -m pytest --noconftest -m cuda
tests/test_torch_dual_path_cuda.py``; chip_smoke.py's phase 17 does)."""

import numpy as np
import pytest
import torch

from semantic_router_tpu_torch.config.schema import InferenceEngineConfig
from semantic_router_tpu_torch.engine.graphs import CaptureGate, StepGraphs
from semantic_router_tpu_torch.engine.testing import (
    DUAL_PATH_TASKS,
    TINY,
    init_weights,
    make_dual_path_engine,
)
from semantic_router_tpu_torch.models.lora import (
    LoRAConfig,
    LoRAModernBertForSequenceClassification,
)
from semantic_router_tpu_torch.models.modernbert import ModernBertConfig
from semantic_router_tpu_torch.ops import _cuda

TOL = 1e-4
TEXTS = ["hello routing world", "debug this function now please",
         "what is the capital of france", "a"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the trunk runs the flash kernel")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


def _engine(device, strategy):
    return make_dual_path_engine(
        device=device, strategy=strategy, seed=4,
        engine_cfg=InferenceEngineConfig(
            max_batch_size=16, max_wait_ms=1.0, seq_len_buckets=[32, 128],
            kernels={"epilogue": {"enabled": True}}),
        model_config=dict(TINY, attention_impl="flash"
                          if device == "cuda" else "dense"))


@pytest.mark.cuda
def test_both_paths_on_the_card_match_the_cpu(cuda_device):
    tasks = [n for n, _ in DUAL_PATH_TASKS]
    layers = TINY["num_hidden_layers"]
    card, cpu = _engine(cuda_device, "traditional"), _engine("cpu",
                                                             "traditional")
    try:
        for path in ("traditional", "stacked", "traditional", "stacked"):
            for e in (card, cpu):
                e.path_chooser.strategy = path
            _cuda.reset_launch_counts()
            got = card.classify_multi(tasks, TEXTS)
            launches = _cuda.launch_counts()
            want = cpu.classify_multi(tasks, TEXTS)
            assert card.last_path_selection.selected_path == path
            assert launches["flash_attention"] == layers
            assert launches["head_epilogue"] == \
                (1 if path == "traditional" else 0)
            for t in tasks:
                for g, w in zip(got[t], want[t]):
                    assert g.label == w.label
                    np.testing.assert_allclose(list(g.probs.values()),
                                               list(w.probs.values()),
                                               atol=TOL)
        graphs = [(s["group"], s["graph"]) for s in card.steps()]
        assert graphs == [("trunk0", "captured"), ("stacked", "captured"),
                          ("trunk0", "replayed"), ("stacked", "replayed")]
    finally:
        card.shutdown()
        cpu.shutdown()


@pytest.mark.cuda
def test_switching_the_lora_adapter_adds_no_capture(cuda_device):
    def model(device):
        cfg = ModernBertConfig(**dict(
            TINY, attention_impl="flash" if device == "cuda" else "dense"))
        m = LoRAModernBertForSequenceClassification(
            cfg, LoRAConfig(rank=4, alpha=8.0, num_tasks=4), 3)
        init_weights(m, 9, std=0.05)
        with torch.no_grad():
            for name, p in m.named_parameters():
                if name.endswith("lora_B"):
                    p.normal_(0, 0.05, generator=torch.Generator()
                              .manual_seed(len(name)))
        return m.to(device).eval()

    card, cpu = model(cuda_device), model("cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(1, TINY["vocab_size"], (4, 32)))
    mask = torch.ones(4, 32, dtype=torch.int32)
    mask[1, 20:] = 0
    graphs = StepGraphs(torch.device(cuda_device), CaptureGate(), "lora")
    hows, outs = [], []
    for t in (0, 1, 2, 3, 1):
        _cuda.reset_launch_counts()
        (logits,), how = graphs.run(
            ("lora", 32, 4), lambda i, m, ti: (card(i, m, task_index=ti),),
            [ids, mask, torch.tensor([t])])
        assert _cuda.launch_counts()["flash_attention"] == \
            TINY["num_hidden_layers"]
        hows.append(how)
        with torch.no_grad():
            want = cpu(ids, mask, task_index=t)
        np.testing.assert_allclose(logits.numpy(), want.numpy(), atol=TOL)
        outs.append(logits)
    assert hows == ["captured"] + ["replayed"] * 4
    assert graphs.captured() == 1
    assert not torch.allclose(outs[0], outs[1], atol=1e-3)
    assert torch.equal(outs[1], outs[4])
