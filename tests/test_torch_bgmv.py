"""The port's wide-bank BGMV path against the JAX package on the CPU: the
BGMV op's plain version against the Pallas kernel in interpret mode, the
per-pair head bank, the LoRA-head classifier carried over from its Flax
tree, and the engine with the gather path on, against the JAX engine and
against itself with the path off.  Inputs are numpy arrays from a seed;
tolerance 1e-4 in float32, the reference's own (tests/test_kernels.py)."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_router_tpu.config.schema import \
    InferenceEngineConfig as JaxEngineConfig
from semantic_router_tpu.engine import testing as jtesting
from semantic_router_tpu.models import lora as jlora
from semantic_router_tpu.models import modernbert as jmb
from semantic_router_tpu.ops.bgmv import bgmv_pallas
from semantic_router_tpu.ops.bgmv import bgmv_reference as jbgmv_reference
from semantic_router_tpu_torch.config.schema import InferenceEngineConfig
from semantic_router_tpu_torch.engine import testing as ttesting
from semantic_router_tpu_torch.models import (
    LoRAConfig,
    ModernBertConfig,
    ModernBertLoRAHeadClassifier,
    apply_head_bank,
    apply_head_bank_bgmv,
    params_from_flax,
    stack_head_bank,
)
from semantic_router_tpu_torch.models.lora import (
    bank_to_device,
    merge_lora_into_base,
)
from semantic_router_tpu_torch.ops.bgmv import (
    CHUNK,
    PAIRS_PER_LAUNCH,
    TASKS_PER_LAUNCH,
    bgmv,
    bgmv_reference,
    bgmv_segments,
)

TOL = 1e-4
TASKS = [name for name, _ in jtesting.SHARED_TRUNK_TASKS]
PII = ("pii", ["O", "B-EMAIL_ADDRESS", "I-EMAIL_ADDRESS"])
CORPUS = [
    "the quarterly contract needs legal review",
    "tiny",
    "my throat hurts and i have a fever since tuesday",
    "refactor the parser to use a visitor pattern",
    "the quarterly contract needs legal review",
    "mail jane.doe@example.com the lease terms",
    "train a neural network on tabular data",
    "hello world",
]


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# the op


def _bgmv_case(T, P, D, H, idx=None, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((P, D)).astype(np.float32)
    w = (rng.standard_normal((T, D, H)) * 0.1).astype(np.float32)
    if idx is None:
        idx = rng.integers(0, T, P)
    return x, w, np.asarray(idx, np.int32)


BGMV_CASES = {
    "reference_shape": (5, 9, 32, 40, None),
    "repeated_indices": (5, 9, 32, 40, [3, 3, 3, 0, 0, 4, 3, 3, 1]),
    "one_pair": (5, 1, 32, 40, [2]),
    "one_task": (1, 6, 16, 8, [0] * 6),
    # the engine's pair order: 3 rows x 5 tasks, row-major, one dummy on
    # task 0 pads it to 16
    "router_mix_row_major": (5, 16, 32, 40, [0, 1, 2, 3, 4] * 3 + [0]),
    "many_tasks_one_pair": (8, 8, 32, 40, [5, 2, 7, 0, 3, 6, 1, 4]),
    "one_task_many_pairs": (3, 40, 32, 40, [1] * 40),
}


@pytest.mark.parametrize("case", list(BGMV_CASES))
def test_bgmv_plain_matches_pallas_interpret(case):
    T, P, D, H, idx = BGMV_CASES[case]
    x, w, idx = _bgmv_case(T, P, D, H, idx)
    want = np.asarray(bgmv_pallas(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(idx), interpret=True))
    jref = np.asarray(jbgmv_reference(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(idx)))
    got = bgmv_reference(t(x), t(w), t(idx))
    via_entry = bgmv(t(x), t(w), t(idx))   # a CPU tensor: the plain version
    assert got.shape == (P, H)
    assert np.max(np.abs(got.numpy() - want)) <= TOL
    assert np.max(np.abs(got.numpy() - jref)) <= TOL
    assert torch.equal(via_entry, got)


def router_mix(rows, tasks):
    """The engine's pair order: row-major, padded to a power of two with
    dummy pairs on task 0."""
    n = rows * tasks
    idx = np.zeros(1 << (n - 1).bit_length(), np.int32)
    idx[:n] = np.tile(np.arange(tasks), rows)
    return idx


class TestBgmvSegments:
    """The kernel's grouping rule (ops.bgmv.bgmv_segments)."""

    @staticmethod
    def _visited(seg):
        return [p for _, pairs in seg["units"] for p in pairs]

    @pytest.mark.parametrize("P,T,seed", [(9, 5, 0), (128, 32, 1),
                                          (300, 7, 2), (5000, 3, 3),
                                          (700, 2500, 4)])
    def test_every_pair_once_in_order(self, P, T, seed):
        idx = np.random.default_rng(seed).integers(-2, T + 2, P)
        seg = bgmv_segments(idx, T)
        ok = np.flatnonzero((idx >= 0) & (idx < T))
        visited = self._visited(seg)
        assert sorted(visited) == ok.tolist()      # each in-range pair once
        assert seg["perm"].tolist() == sorted(ok.tolist(),
                                              key=lambda p: (idx[p], p))
        for task, pairs in seg["units"]:
            assert 0 < len(pairs) <= CHUNK
            assert all(idx[p] == task for p in pairs)
            assert list(pairs) == sorted(pairs)
        for task in range(T):   # a segment's chunks are its pairs in order
            got = [p for u, pairs in seg["units"] if u == task for p in pairs]
            lo, hi = seg["offsets"][task], seg["offsets"][task + 1]
            assert got == seg["perm"][lo:hi].tolist()
        # the grid holds every unit of its launch
        launches = -(-P // PAIRS_PER_LAUNCH) * -(-T // TASKS_PER_LAUNCH)
        assert len(seg["grid_units"]) == launches
        assert sum(seg["grid_units"]) >= len(seg["units"]) + \
            len(seg["nan_units"])

    def test_out_of_range_indices_form_no_segment(self):
        idx = np.asarray([0, 4, 5, 2, -1, 3, 1 << 30, 1, 0])
        seg = bgmv_segments(idx, 5)
        assert seg["nan_pairs"].tolist() == [2, 4, 6]
        assert seg["nan_units"] == [(2, 4, 6)]
        assert seg["segments"] == 5
        assert not {2, 4, 6} & set(self._visited(seg))
        assert seg["offsets"].tolist() == [0, 2, 3, 4, 5, 6]

    def test_dummies_join_task_0(self):
        seg = bgmv_segments(router_mix(16, 5), 32, 768)
        # task 0: 16 real pairs + 48 dummies = 64 pairs, four units
        assert [len(p) for t, p in seg["units"] if t == 0] == [16] * 4
        assert seg["units"][0][1] == tuple(range(0, 80, 5))
        assert seg["units"][1][1] == tuple(range(80, 96))
        assert [t for t, _ in seg["units"]] == [0, 0, 0, 0, 1, 2, 3, 4]

    def test_long_segment_splits_into_chunks(self):
        seg = bgmv_segments(np.full(256, 7), 32, 768)
        assert seg["segments"] == 1
        assert [t for t, _ in seg["units"]] == [7] * (256 // CHUNK)
        assert seg["units"][1][1] == tuple(range(CHUNK, 2 * CHUNK))
        # 16 units x 24 column tiles of 32 float32 columns
        assert seg["items"] == 16 * 24

    def test_router_mix_gives_five_segments(self):
        seg = bgmv_segments(router_mix(16, 5), 32, 768)
        assert seg["segments"] == 5 and len(seg["units"]) == 8
        assert seg["column_tiles"] == 24 and seg["items"] == 8 * 24
        assert seg["grid_units"] == [(128 + 15 * 33) // 16]
        assert seg["item_bound"] == seg["grid_units"][0] * 24
        assert bgmv_segments(router_mix(16, 5), 32, 768, 2)[
            "column_tiles"] == 12                      # 64 bfloat16 columns
        fan = bgmv_segments(router_mix(16, 32), 32, 768)
        assert fan["segments"] == 32 and len(fan["units"]) == 32
        cls = bgmv_segments(router_mix(16, 5), 32, 8)
        assert cls["column_tiles"] == 1 and cls["items"] == 8


def test_bgmv_int64_indices_and_bf16_on_cpu():
    x, w, idx = _bgmv_case(5, 9, 32, 40)
    ref = bgmv_reference(t(x), t(w), t(idx))
    assert torch.equal(bgmv(t(x), t(w), t(idx).long()), ref)
    got = bgmv(t(x).bfloat16(), t(w).bfloat16(), t(idx))
    assert got.dtype == torch.bfloat16
    assert float((got.float() - ref).abs().max()) <= 2e-2 * \
        max(1.0, float(ref.abs().max()))


# ---------------------------------------------------------------------------
# the per-pair head bank


def _entries(rng, n, D, L=4, lora=True, bias=True):
    return [{
        "dense_kernel": rng.standard_normal((D, D)) * 0.1,
        "dense_bias": rng.standard_normal(D) * 0.1 if bias else None,
        "lora_A": rng.standard_normal((D, 4)) * 0.1 if lora else None,
        "lora_B": rng.standard_normal((4, D)) * 0.1 if lora else None,
        "scale": 2.0 if lora else 0.0,
        "norm_scale": 1.0 + rng.standard_normal(D) * 0.1,
        "norm_bias": rng.standard_normal(D) * 0.1 if bias else None,
        "cls_kernel": rng.standard_normal((D, L)) * 0.1,
        "cls_bias": rng.standard_normal(L) * 0.1,
        "kind": "sequence",
    } for _ in range(n)]


class TestHeadBankBgmv:
    PR = np.asarray([0, 0, 3, 4, 2, 1, 0], np.int32)
    PT = np.asarray([1, 4, 0, 5, 2, 3, 0], np.int32)

    @pytest.fixture(scope="class")
    def bank(self):
        rng = np.random.default_rng(8)
        entries = _entries(rng, 6, 32)
        # the JAX stacker runs on float64 host arrays: the same float32
        # bank on both sides
        host = {k: np.asarray(v, np.float32)
                for k, v in stack_head_bank(entries).items()}
        pooled = rng.standard_normal((5, 32)).astype(np.float32)
        return host, pooled

    def test_matches_jax(self, bank):
        host, pooled = bank
        jbank = {k: jnp.asarray(v) for k, v in host.items()}
        act = lambda h: jax.nn.gelu(h, approximate=False)  # noqa: E731
        want = np.asarray(jlora.apply_head_bank_bgmv(
            jbank, jnp.asarray(pooled), jnp.asarray(self.PR),
            jnp.asarray(self.PT), act, 1e-5))
        got = apply_head_bank_bgmv(bank_to_device(host, "cpu"), t(pooled),
                                   t(self.PR), t(self.PT), "gelu", 1e-5)
        assert got.shape == (len(self.PR), 4)
        assert np.max(np.abs(got.numpy() - want)) <= TOL

    def test_matches_all_heads_at_the_pairs(self, bank):
        host, pooled = bank
        tbank = bank_to_device(host, "cpu")
        padded = apply_head_bank(tbank, t(pooled), "gelu", 1e-5)
        got = apply_head_bank_bgmv(tbank, t(pooled), t(self.PR),
                                   t(self.PT), "gelu", 1e-5)
        sel = padded[t(self.PR).long(), t(self.PT).long()]
        assert float((got - sel).abs().max()) <= TOL

    def test_plain_members_without_bias(self):
        rng = np.random.default_rng(9)
        host = {k: np.asarray(v, np.float32) for k, v in stack_head_bank(
            _entries(rng, 3, 16, L=3, lora=False, bias=False)).items()}
        assert "lora_A" not in host and "dense_bias" not in host
        pooled = rng.standard_normal((2, 16)).astype(np.float32)
        pr, pt = np.asarray([1, 0, 1], np.int32), np.asarray([2, 2, 0],
                                                             np.int32)
        want = np.asarray(jlora.apply_head_bank_bgmv(
            {k: jnp.asarray(v) for k, v in host.items()},
            jnp.asarray(pooled), jnp.asarray(pr), jnp.asarray(pt),
            lambda h: jax.nn.gelu(h, approximate=False), 1e-5))
        got = apply_head_bank_bgmv(bank_to_device(host, "cpu"), t(pooled),
                                   t(pr), t(pt), "gelu", 1e-5)
        assert np.max(np.abs(got.numpy() - want)) <= TOL


# ---------------------------------------------------------------------------
# the LoRA-head classifier


def _lora_pair(num_labels=3, seed=0, **overrides):
    jcfg = jmb.ModernBertConfig(**{**jtesting.TINY, "num_labels": num_labels,
                                   **overrides})
    jm = jlora.ModernBertLoRAHeadClassifier(
        jcfg, jlora.LoRAConfig(rank=4, alpha=8.0), num_labels)
    init = jm.init(jax.random.PRNGKey(seed), jnp.ones((1, 8), jnp.int32))
    params = flax.core.unfreeze(jax.tree_util.tree_map(np.asarray, init))
    rng = np.random.default_rng(seed + 1)
    inner = params["params"]
    inner["lora_B"] = (rng.standard_normal(inner["lora_B"].shape)
                       * 0.3).astype(np.float32)
    tm = ModernBertLoRAHeadClassifier(
        ModernBertConfig(**{**ttesting.TINY, "num_labels": num_labels,
                            **overrides}),
        LoRAConfig(rank=4, alpha=8.0), num_labels)
    tm.load_state_dict(params_from_flax(params))
    return jm, params, tm.eval()


class TestLoRAHeadClassifier:
    @pytest.mark.parametrize("overrides", [{}, {"classifier_bias": True,
                                                "norm_bias": True,
                                                "classifier_pooling": "mean"}],
                             ids=["base", "bias_norm_bias_mean_pool"])
    def test_logits_match_flax(self, overrides):
        jm, params, tm = _lora_pair(**overrides)
        rng = np.random.default_rng(2)
        ids = rng.integers(3, 1024, (3, 20)).astype(np.int32)
        mask = (np.arange(20)[None] < np.asarray([[20], [11], [4]])
                ).astype(np.int32)
        ids = np.where(mask == 1, ids, 0)
        want = np.asarray(jm.apply(params, jnp.asarray(ids),
                                   jnp.asarray(mask)))
        with torch.no_grad():
            got = tm(t(ids).long(), t(mask)).numpy()
        assert np.abs(params["params"]["lora_B"]).max() > 0
        assert np.max(np.abs(got - want)) <= TOL

    def test_flax_names_and_bank_entry(self):
        from semantic_router_tpu_torch.models import head_bank_entry

        _, params, tm = _lora_pair()
        sd = params_from_flax(params)
        assert {"head_dense.weight", "lora_A", "lora_B", "head_norm.weight",
                "classifier.weight", "classifier.bias"} <= set(sd)
        # bare LoRA leaves keep the Flax layout
        np.testing.assert_array_equal(sd["lora_A"].numpy(),
                                      params["params"]["lora_A"])
        e = head_bank_entry(tm)
        je = jlora.head_bank_entry(jlora.ModernBertLoRAHeadClassifier(
            jmb.ModernBertConfig(**{**jtesting.TINY, "num_labels": 3}),
            jlora.LoRAConfig(rank=4, alpha=8.0), 3), params)
        assert e["kind"] == je["kind"] == "sequence"
        assert e["scale"] == je["scale"] == 2.0
        for k in ("dense_kernel", "lora_A", "lora_B", "norm_scale",
                  "cls_kernel", "cls_bias"):
            np.testing.assert_allclose(e[k], np.asarray(je[k]), atol=0)

    def test_merge_lora_into_base_matches_jax(self):
        rng = np.random.default_rng(4)
        W, A, B = (rng.standard_normal(s).astype(np.float32)
                   for s in ((16, 12), (16, 4), (4, 12)))
        np.testing.assert_allclose(merge_lora_into_base(W, A, B, 2.0),
                                   jlora.merge_lora_into_base(W, A, B, 2.0),
                                   atol=1e-6)
        assert LoRAConfig(rank=8, alpha=16.0).scale == \
            jlora.LoRAConfig(rank=8, alpha=16.0).scale == 2.0


# ---------------------------------------------------------------------------
# the engine


BGMV = {"bgmv": {"enabled": True, "min_tasks": 2}}


def _jax_engine(kernels, seed=5):
    return jtesting.make_shared_trunk_engine(
        lora_tasks=("fact_check",), token_tasks=[PII], seed=seed,
        engine_cfg=JaxEngineConfig(max_batch_size=8, max_wait_ms=1.0,
                                   seq_len_buckets=[32, 128, 512],
                                   kernels=dict(kernels)))


def _port_engine(kernels, flax_params=None, **kw):
    return ttesting.make_shared_trunk_engine(
        lora_tasks=("fact_check",), token_tasks=[PII], device="cpu",
        flax_params=flax_params,
        engine_cfg=InferenceEngineConfig(max_batch_size=8, max_wait_ms=1.0,
                                         seq_len_buckets=[32, 128, 512],
                                         kernels=dict(kernels)), **kw)


def _close(a, b, tol=TOL):
    assert [r.label for r in a] == [r.label for r in b]
    for x, y in zip(a, b):
        assert set(x.probs) == set(y.probs)
        assert max(abs(x.probs[k] - y.probs[k]) for k in x.probs) <= tol


class TestEngineBgmv:
    @pytest.fixture(scope="class")
    def engines(self):
        """(JAX engine with bgmv, port with bgmv, port without) on the
        same weights."""
        jeng = _jax_engine(BGMV)
        params = {n: tk.params for n, tk in jeng._tasks.items()}
        on = _port_engine(BGMV, params)
        off = _port_engine({}, params)
        yield jeng, on, off
        for e in (jeng, on, off):
            e.shutdown()

    def test_groups_report_bgmv(self, engines):
        jeng, on, off = engines
        assert all(m["bgmv"] for m in jeng.kernels_report()["groups"].values())
        assert [m["bgmv"] for m in on.kernels_report()["groups"].values()] \
            == [True]
        assert [m["bgmv"] for m in off.kernels_report()["groups"].values()] \
            == [False]

    def test_multi_task_fanout(self, engines):
        jeng, on, off = engines
        got = on.classify_multi(TASKS, CORPUS)
        want = jeng.classify_multi(TASKS, CORPUS)
        plain = off.classify_multi(TASKS, CORPUS)
        for task in TASKS:
            _close(got[task], want[task])
            _close(got[task], plain[task])
        step = [s for s in on.steps() if s["flavor"] == "seq"][-1]
        assert step["bgmv"] and step["pairs"] >= len(TASKS)
        assert step["padded_pairs"] >= step["pairs"]
        assert step["padded_pairs"] & (step["padded_pairs"] - 1) == 0

    def test_deduped_batch(self, engines):
        jeng, on, off = engines
        texts = ["hot prompt"] * 4 + ["cold", "hot prompt", "distinct"]
        before = on.fused_dedup_rows
        got = on.classify_multi(["intent", "user_feedback"], texts)
        assert on.fused_dedup_rows > before
        want = jeng.classify_multi(["intent", "user_feedback"], texts)
        for task in ("intent", "user_feedback"):
            _close(got[task], want[task])
            assert got[task][0].probs == got[task][5].probs

    def test_lora_member(self, engines):
        jeng, on, off = engines
        got = on.classify_batch("fact_check", CORPUS)
        _close(got, jeng.classify_batch("fact_check", CORPUS))
        _close(got, off.classify_batch("fact_check", CORPUS))

    def test_token_members_keep_all_heads(self, engines):
        jeng, on, _ = engines
        for text in CORPUS[:4]:
            got = on.token_classify("pii", text, threshold=0.0)
            want = jeng.token_classify("pii", text, threshold=0.0)
            assert [(e.type, e.start, e.end) for e in got.entities] == \
                [(e.type, e.start, e.end) for e in want.entities]
            for a, b in zip(got.entities, want.entities):
                assert abs(a.score - b.score) <= TOL
        tok_steps = [s for s in on.steps() if s["flavor"] == "tok"]
        assert tok_steps and not any(s["bgmv"] for s in tok_steps)

    def test_hot_flip_keeps_results(self, engines):
        _, on, off = engines
        want = off.classify_multi(TASKS, CORPUS[:3])
        on.configure_kernels({})
        try:
            assert not on.kernels_report()["groups"]["trunk0"]["bgmv"]
            _close(on.classify_multi(TASKS, CORPUS[:3])["intent"],
                   want["intent"])
            assert on.steps()[-1]["bgmv"] is False
        finally:
            on.configure_kernels(BGMV)
        _close(on.classify_multi(TASKS, CORPUS[:3])["intent"], want["intent"])
        assert on.steps()[-1]["bgmv"] is True

    def test_flips_under_traffic(self, engines):
        """A batch serves under the knobs it read: flipping BGMV on and off
        while 6 threads classify (more workers than this test's cores
        need, a short switch interval) never tears a batch."""
        import sys
        import threading
        import time

        _, on, off = engines
        texts = CORPUS[:4]
        want = off.classify_multi(TASKS, texts)
        errors, stop = [], threading.Event()

        def traffic(k):
            while not stop.is_set():
                try:
                    got = on.classify_multi(TASKS, texts[k % 2:], timeout=30)
                    for task in TASKS:
                        _close(got[task], want[task][k % 2:])
                except Exception as exc:  # reported below
                    errors.append(exc)
                    return

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        threads = [threading.Thread(target=traffic, args=(k,))
                   for k in range(6)]
        steps0 = len(on.steps())
        try:
            for th in threads:
                th.start()
            # at least 40 flips, and on until batches ran under both
            # settings (a loaded machine may run few batches in 40)
            deadline = time.monotonic() + 60.0
            i = 0
            while i < 40 or ({s["bgmv"] for s in on.steps()[steps0:]}
                             != {True, False}
                             and time.monotonic() < deadline
                             and not errors):
                on.configure_kernels(BGMV if i % 2 else {})
                stop.wait(0.005)
                i += 1
        finally:
            stop.set()
            for th in threads:
                th.join(timeout=60)
            sys.setswitchinterval(old)
            on.configure_kernels(BGMV)
        assert not any(th.is_alive() for th in threads)
        assert not errors, errors[:3]
        assert {s["bgmv"] for s in on.steps()[steps0:]} == {True, False}

    def test_warmup_runs_the_one_pair_shape(self, engines):
        _, on, _ = engines
        on.warmup(buckets=[32])  # raises if the 1-pair program misfits

    def test_narrow_bank_keeps_all_heads(self):
        eng = _port_engine({"bgmv": {"enabled": True, "min_tasks": 16}})
        try:
            assert not any(m["bgmv"]
                           for m in eng.kernels_report()["groups"].values())
            eng.classify_multi(TASKS, CORPUS[:2])
            assert eng.steps()[-1]["bgmv"] is False
        finally:
            eng.shutdown()


def test_twelve_head_bank_engages_at_default_min_tasks():
    tasks = [(f"tenant_{i:02d}", [f"l{j}" for j in range(2 + i % 7)])
             for i in range(12)]
    lora = [name for name, _ in tasks[1::2]]
    on = ttesting.make_shared_trunk_engine(
        tasks=tasks, lora_tasks=lora, device="cpu", seed=2,
        engine_cfg=InferenceEngineConfig(
            max_batch_size=8, max_wait_ms=1.0, seq_len_buckets=[32, 128],
            kernels={"bgmv": {"enabled": True}}))
    try:
        assert on.kernels_report()["kernels"]["bgmv"]["min_tasks"] == 8
        assert [m["bgmv"] for m in on.kernels_report()["groups"].values()] \
            == [True]
        names = [name for name, _ in tasks]
        got = on.classify_multi(names[:5], CORPUS[:4])
        step = on.steps()[-1]
        # one pair per (unique text, task): a packed step (the reference
        # packs this dense group) pools one row per segment
        assert step["bgmv"] and step["pairs"] == 5 * step.get(
            "segments", step["rows"])
        on.configure_kernels({})
        want = on.classify_multi(names[:5], CORPUS[:4])
        for name in names[:5]:
            _close(got[name], want[name])
    finally:
        on.shutdown()
