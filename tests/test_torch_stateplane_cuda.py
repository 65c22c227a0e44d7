"""The plane-shared semantic cache on the card, cut to a tiny trunk: two
replicas (one engine each, both on the card, the same seed) over one
``MiniRedis``.  A write through one is an exact hit on the other with no
embedding forward, and a paraphrase is a similarity hit whose lookup
embeds once through K1 (one launch a layer); the stored embedding is
little-endian float32 and agrees with the CPU port's within 1e-4; with
the store stopped, lookups fall back to the local cache and still embed
on the card.  ``cuda``-marked: skips without a GPU.  Imports no JAX
(``python -m pytest --noconftest -m cuda
tests/test_torch_stateplane_cuda.py``; chip_smoke.py's phase 15 does)."""

import numpy as np
import pytest
import torch

from semantic_router_tpu_torch.cache.semantic_cache import \
    InMemorySemanticCache
from semantic_router_tpu_torch.config.schema import InferenceEngineConfig
from semantic_router_tpu_torch.engine import InferenceEngine
from semantic_router_tpu_torch.engine.testing import TINY, init_weights
from semantic_router_tpu_torch.models import MmBertEmbeddingModel, \
    ModernBertConfig
from semantic_router_tpu_torch.ops import _cuda
from semantic_router_tpu_torch.state.resp import MiniRedis
from semantic_router_tpu_torch.stateplane import GuardedBackend, \
    RespStateBackend, SharedSemanticCache, StatePlane
from semantic_router_tpu_torch.stateplane.cache import _qhash
from semantic_router_tpu_torch.utils.tokenization import HashTokenizer

EMBED_TOL = 1e-4
QUERY = "how do I rotate the api credentials for the billing service"
PARAPHRASE = QUERY + " please"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


def _embedding_engine(device):
    """A tiny embedding model (flash attention: K1 on the card, its plain
    version on the CPU) with weights from one seed."""
    module = MmBertEmbeddingModel(ModernBertConfig(**TINY,
                                                   attention_impl="flash"))
    init_weights(module, 7)
    engine = InferenceEngine(InferenceEngineConfig(), device=device)
    engine.register_task("embedding", "embedding", module,
                         HashTokenizer(vocab_size=TINY["vocab_size"]), [],
                         max_seq_len=128)
    return engine


def _replica(port, name, device, threshold):
    engine = _embedding_engine(device)
    embed = lambda text: engine.embed("embedding", [text])[0]
    plane = StatePlane(GuardedBackend(RespStateBackend(port=port),
                                      cooldown_s=0.1),
                       replica_id=name, namespace="cuda")
    local = InMemorySemanticCache(embed, similarity_threshold=threshold,
                                  use_hnsw=False)
    cache = SharedSemanticCache(plane, embed, similarity_threshold=threshold,
                                local=local)
    return engine, plane, cache


@pytest.mark.cuda
def test_shared_cache_embeds_through_k1(cuda_device):
    mini = MiniRedis().start()
    cpu = _embedding_engine("cpu")
    reps = []
    try:
        want = cpu.embed("embedding", [QUERY, PARAPHRASE])
        sim = float(want[0] @ want[1])
        threshold = sim - 0.05
        reps = [_replica(mini.port, n, cuda_device, threshold)
                for n in ("a", "b")]
        (_, _, ca), (_, _, cb) = reps
        layers = TINY["num_hidden_layers"]
        _cuda.reset_launch_counts()
        ca.add(QUERY, "answer", model="m")
        assert _cuda.launch_counts()["flash_attention"] == layers
        stored = np.frombuffer(ca.backend.get_hash(
            ca._entry_key(_qhash(QUERY)))["emb"], dtype="<f4")
        np.testing.assert_allclose(stored, want[0], atol=EMBED_TOL)
        _cuda.reset_launch_counts()
        hit = cb.find_similar(QUERY)  # exact: no forward
        assert hit is not None and hit.response == "answer"
        assert _cuda.launch_counts()["flash_attention"] == 0
        hit = cb.find_similar(PARAPHRASE)  # similar: one forward
        assert hit is not None and hit.response == "answer"
        assert _cuda.launch_counts()["flash_attention"] == layers
        # the store stops: writes land in the local cache, embedded on
        # the card, and the local cache answers
        mini.stop()
        _cuda.reset_launch_counts()
        ca.add("asked while the store was down", "offline", model="m")
        assert _cuda.launch_counts()["flash_attention"] >= layers
        assert not ca.backend.available
        hit = ca.find_similar("asked while the store was down")
        assert hit is not None and hit.response == "offline"
    finally:
        for engine, plane, _ in reps:
            plane.close()
            engine.shutdown()
        cpu.shutdown()
        mini.stop()
