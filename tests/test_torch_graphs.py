"""The port's compiled-step cache (semantic_router_tpu_torch.engine.graphs):
launch accounting, retirement and the capture gate on the CPU; capture,
replay against the eager step, launch counts through replays, retirement
on a rebuild or a flip, and the failures that must raise, on the card
(``cuda``-marked; chip_smoke.py's phase 7 runs them there).  Imports
nothing of the JAX package, so the card's machine can run it."""

import threading
import time

import numpy as np
import pytest
import torch

from semantic_router_tpu_torch.config import InferenceEngineConfig
from semantic_router_tpu_torch.engine.graphs import (
    CaptureGate,
    SnapshotRetired,
    StepGraphs,
)
from semantic_router_tpu_torch.engine.testing import (
    TINY,
    make_embedding_engine,
    make_shared_trunk_engine,
)
from semantic_router_tpu_torch.observability.profiler import (
    TRACE_GATE,
    ProfilerControl,
)
from semantic_router_tpu_torch.ops import _cuda
from semantic_router_tpu_torch.ops.flash_attention import FLASH_ATTENTION

PII = ("pii", ["O", "B-EMAIL_ADDRESS", "I-EMAIL_ADDRESS", "B-PERSON",
               "I-PERSON"])
SEQ_TASKS = ["intent", "fact_check", "user_feedback"]
TEXTS = ["how do I file quarterly taxes", "is this medication safe",
         "write a python function that sorts a list", "hello",
         "contact jane at jane@example.com"]


def _engine(device, fuse=None, kernels=None, quant=None):
    cfg = InferenceEngineConfig(
        max_batch_size=8, max_wait_ms=1.0, seq_len_buckets=[32, 128],
        kernels=kernels or {"epilogue": {"enabled": True}},
        quant=quant or {})
    attention = "flash" if torch.device(device).type == "cuda" else "dense"
    return make_shared_trunk_engine(
        token_tasks=[PII], lora_tasks=("fact_check",), engine_cfg=cfg,
        device=device, model_config=dict(TINY, attention_impl=attention),
        max_seq_len=128, seed=4, fuse=fuse)


def _inputs(B, S, seed=0):
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(3, TINY["vocab_size"], (B, S)))
    mask = torch.ones(B, S, dtype=torch.int32)
    for b in range(1, B):
        mask[b, S - 3 * b:] = 0
    return [ids * mask, mask]


# -- on the CPU ---------------------------------------------------------------


def test_recorded_launches_count_only_when_replayed():
    _cuda.reset_launch_counts()
    with _cuda.recording_launches() as log:
        _cuda.check_launch(FLASH_ATTENTION, 0, torch.float32)
        _cuda.check_launch(FLASH_ATTENTION, 0, torch.bfloat16)
    assert _cuda.launch_counts()["flash_attention"] == 0
    assert log == {"flash_attention": {"float32": 1, "bfloat16": 1}}
    for _ in range(3):
        _cuda.add_launches(log)
    assert _cuda.launch_counts()["flash_attention"] == 6
    assert _cuda.launch_counts_by_dtype()["flash_attention"] == \
        {"float32": 3, "bfloat16": 3}
    with pytest.raises(RuntimeError, match="CUDA error 7"):
        _cuda.check_launch(FLASH_ATTENTION, 7)
    _cuda.reset_launch_counts()


def test_retired_cache_raises():
    cache = StepGraphs("cpu", CaptureGate(), "trunk:x")
    ids, mask = _inputs(2, 8)
    outs, how = cache.run(("k",), lambda i, m: (i.float() * m, None),
                          [ids, mask])
    assert how == "eager" and outs[1] is None
    assert torch.equal(outs[0], ids.float() * mask)
    cache.retire()
    with pytest.raises(SnapshotRetired):
        cache.run(("k",), lambda i, m: (i,), [ids, mask])


def test_capture_gate_holds_replays_while_a_capture_runs():
    gate = CaptureGate()
    order = []
    held = threading.Event()

    def capture():
        with gate.exclusive():
            held.set()
            time.sleep(0.05)
            order.append("capture")

    t = threading.Thread(target=capture)
    t.start()
    held.wait(5)
    with gate.shared():
        order.append("replay")
    t.join()
    assert order == ["capture", "replay"]
    # shared holders overlap
    with gate.shared(), gate.shared():
        pass


def test_every_cpu_step_is_eager_and_flips_retire_the_group_cache():
    eng = _engine("cpu")
    try:
        eng.warmup()
        g = eng.trunk_group("intent")
        first = g.demux["graphs"]
        eng.classify("intent", TEXTS[0])
        assert eng.steps()[-1]["graph"] == "eager"
        # (bucket, rows, padded pairs, epilogue, bgmv)
        shape = (32, 1, 0, True, False)
        assert not eng._step_fresh(f"trunk:{g.gid}", "seq", shape)
        assert eng._step_fresh(f"trunk:{g.gid}", "seq", (32, 2, 0, True,
                                                         False))
        eng.configure_quant({"mode": "bf16"})
        assert first.retired and not g.demux["graphs"].retired
        # the census is the live caches': the retired one's keys left
        assert eng._step_fresh(f"trunk:{g.gid}", "seq", shape)
        second = g.demux["graphs"]
        eng.configure_kernels({"epilogue": {"enabled": False}})
        assert second.retired
        third = g.demux["graphs"]
        eng.register_task("user_feedback", "sequence",
                          eng._tasks["user_feedback"].module,
                          eng._tasks["user_feedback"].tokenizer,
                          eng.task_labels("user_feedback"),
                          max_seq_len=128)
        assert third.retired and not g.demux["graphs"].retired
        # a batch that read a retired snapshot raises there, and the
        # batcher's runner serves it once more on the live snapshot
        old = third
        with pytest.raises(SnapshotRetired):
            old.run(("k",), lambda i, m: (i,), _inputs(1, 8))
        assert eng.classify("intent", TEXTS[1]).label in \
            eng.task_labels("intent")
    finally:
        eng.shutdown()


def test_a_flip_publishes_before_it_retires(monkeypatch):
    """A batch that read the snapshot a quant flip replaces raises on it
    and runs again on the new one, while the old one's retire is still
    held open (as a retire waits for other owners' replays): the flip
    publishes first and retires after releasing the engine lock, so no
    ``SnapshotRetired`` reaches the caller."""
    eng = _engine("cpu")
    retired, served = threading.Event(), threading.Event()
    flips: list = []
    real_retire, real_run = StepGraphs.retire, StepGraphs.run

    def retire_held_open(self):
        real_retire(self)
        retired.set()
        served.wait(timeout=5.0)

    def run_after_a_flip(self, key, fn, inputs):
        if not flips:  # the batch holds its snapshot: flip it now
            flips.append(threading.Thread(
                target=eng.configure_quant, args=({"mode": "bf16"},)))
            flips[0].start()
            assert retired.wait(timeout=5.0)
        return real_run(self, key, fn, inputs)

    monkeypatch.setattr(StepGraphs, "retire", retire_held_open)
    monkeypatch.setattr(StepGraphs, "run", run_after_a_flip)
    try:
        res = eng.classify("intent", TEXTS[0], timeout=10.0)
        assert res.label in eng.task_labels("intent")
        assert eng.steps()[-1]["quant"] == "bf16"
        assert len(eng.steps()) == 1  # the retried batch ran once
    finally:
        served.set()
        for t in flips:
            t.join()
        monkeypatch.undo()
        eng.shutdown()


def test_a_batch_runs_again_past_every_flip_that_lands_while_it_runs(
        monkeypatch):
    """Flips that land one after another, each while the batch's retry is
    on its way to the snapshot it read, retire that snapshot every time:
    the batch runs again on the live one until it serves, and no
    ``SnapshotRetired`` reaches the caller."""
    eng = _engine("cpu")
    modes = ["bf16", "off", "bf16"]
    calls: list = []
    real_run = StepGraphs.run

    def run_after_a_flip(self, key, fn, inputs):
        calls.append(self)
        if len(calls) <= len(modes):
            flip = threading.Thread(target=eng.configure_quant,
                                    args=({"mode": modes[len(calls) - 1]},))
            flip.start()
            flip.join(timeout=10.0)
            assert self.retired
        return real_run(self, key, fn, inputs)

    monkeypatch.setattr(StepGraphs, "run", run_after_a_flip)
    try:
        res = eng.classify("intent", TEXTS[0], timeout=10.0)
        assert res.label in eng.task_labels("intent")
        assert len(calls) == len(modes) + 1
        assert len({id(c) for c in calls}) == len(calls)
        assert eng.steps()[-1]["quant"] == "bf16"
        assert len(eng.steps()) == 1
    finally:
        monkeypatch.undo()
        eng.shutdown()


def test_a_cache_retired_with_no_change_raises_at_once(monkeypatch):
    """A cache retired with no new snapshot behind it (as shutdown retires
    them) has nothing to run again on: the batch raises
    ``SnapshotRetired`` after one attempt."""
    eng = _engine("cpu")
    calls: list = []
    real_run = StepGraphs.run

    def run_retired(self, key, fn, inputs):
        calls.append(self)
        self.retire()
        return real_run(self, key, fn, inputs)

    monkeypatch.setattr(StepGraphs, "run", run_retired)
    try:
        with pytest.raises(SnapshotRetired):
            eng.classify("intent", TEXTS[0], timeout=10.0)
        assert len(calls) == 1
    finally:
        monkeypatch.undo()
        eng.shutdown()


# -- on the card ---------------------------------------------------------------


def test_a_trace_starts_and_stops_only_between_steps(tmp_path):
    """A step on the card holds TRACE_GATE shared: a trace's start and its
    stop wait for it (either synchronizes the device and toggles CUPTI,
    which a capture does not allow and a graph launch can deadlock
    with), and no step enters while one waits."""
    pc = ProfilerControl(base_dir=str(tmp_path))
    res = {}

    def call(what):
        res[what] = getattr(pc, what)()

    for what, key in (("start", "started"), ("stop", "stopped")):
        entered = threading.Event()

        def step():
            with TRACE_GATE.shared():
                entered.set()

        with TRACE_GATE.shared():
            t = threading.Thread(target=call, args=(what,))
            t.start()
            t.join(0.3)
            assert t.is_alive(), f"{what} ran while a step held the gate"
            late = threading.Thread(target=step)
            late.start()
            assert not entered.wait(0.2), f"a step entered while {what} waited"
        t.join(60)
        late.join(60)
        assert entered.is_set()
        assert not t.is_alive() and res[what].get(key), res[what]
    assert "trace.json" in res["stop"]["files"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the kernels have "
                    "no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bgmv", [False, True])
def test_replay_equals_eager_step(cuda_device, bgmv):
    kernels = {"epilogue": {"enabled": True},
               "bgmv": {"enabled": bgmv, "min_tasks": 2}}
    eng = _engine(cuda_device, kernels=kernels)
    try:
        g = eng.trunk_group("intent")
        demux = g.demux
        meta = eng._serving_meta(demux)
        assert meta["bgmv"] == bgmv
        for flavor in ("seq", "tok", "both"):
            use_bgmv = bgmv and flavor != "tok"
            ins = _inputs(4, 32, seed=len(flavor))
            if use_bgmv:
                ins += [torch.tensor([0, 1, 2, 3, 0, 0, 0, 0],
                                     dtype=torch.int32),
                        torch.tensor([0, 1, 2, 0, 1, 0, 0, 0],
                                     dtype=torch.int32)]
            with torch.inference_mode():
                want = g.forward(*[x.to(cuda_device) for x in ins[:2]],
                                 flavor, demux, True,
                                 *[x.to(cuda_device) for x in ins[2:]])
            want = [None if w is None else w.float().cpu() for w in want]
            got1, how1 = eng._fused_step(g, demux, flavor, 32, 4, meta,
                                         use_bgmv, ins)
            got2, how2 = eng._fused_step(g, demux, flavor, 32, 4, meta,
                                         use_bgmv, ins)
            assert (how1, how2) == ("captured", "replayed")
            for w, a, b in zip(want, got1, got2):
                assert (w is None) == (a is None) == (b is None)
                if w is not None:
                    assert float((a - w).abs().max()) <= 1e-5
                    assert float((b - w).abs().max()) <= 1e-5
    finally:
        eng.shutdown()


@pytest.mark.cuda
def test_launch_counts_include_replays(cuda_device):
    eng = _engine(cuda_device)
    try:
        eng.warmup()
        _cuda.reset_launch_counts()
        fwd0, n0 = eng.trunk_forwards, len(eng.steps())
        for text in TEXTS:
            eng.classify_multi(SEQ_TASKS, [text])
        steps = eng.steps()[n0:]
        forwards = eng.trunk_forwards - fwd0
        assert steps and all(s["graph"] == "replayed" for s in steps)
        counts = _cuda.launch_counts()
        assert counts["flash_attention"] == TINY["num_hidden_layers"] \
            * forwards
        assert counts["head_epilogue"] > 0
    finally:
        eng.shutdown()


@pytest.mark.cuda
def test_served_results_match_the_cpu(cuda_device):
    for fuse in (None, False):
        gpu, cpu = _engine(cuda_device, fuse=fuse), _engine("cpu", fuse=fuse)
        try:
            gpu.warmup()
            for task in SEQ_TASKS:
                for text in TEXTS:
                    a, b = gpu.classify(task, text), cpu.classify(task, text)
                    assert max(abs(a.probs[k] - b.probs[k])
                               for k in a.probs) <= 1e-4
            long = " ".join(f"w{i}" for i in range(300))
            a = gpu.classify_windowed("intent", long, stride=16)
            b = cpu.classify_windowed("intent", long, stride=16)
            assert not a.truncated
            assert max(abs(a.probs[k] - b.probs[k]) for k in a.probs) <= 1e-4
            assert all(s["graph"] in ("captured", "replayed")
                       for s in gpu.steps())
        finally:
            gpu.shutdown()
            cpu.shutdown()


@pytest.mark.cuda
def test_embed_steps_replay(cuda_device):
    cfg = InferenceEngineConfig(max_batch_size=8, max_wait_ms=1.0,
                                seq_len_buckets=[32, 128],
                                matryoshka_layers=[1],
                                matryoshka_dims=[16])
    gpu = make_embedding_engine(seed=2, engine_cfg=cfg, device=cuda_device)
    cpu = make_embedding_engine(seed=2, engine_cfg=cfg, device="cpu")
    try:
        gpu.warmup()
        n0 = len(gpu.steps())
        for el, od in ((None, None), (1, 16)):
            a = gpu.embed("embedding", TEXTS[:1], exit_layer=el,
                          output_dim=od)
            b = cpu.embed("embedding", TEXTS[:1], exit_layer=el,
                          output_dim=od)
            assert np.abs(a - b).max() <= 1e-4
        assert [s["graph"] for s in gpu.steps()[n0:]] == ["replayed"] * 2
    finally:
        gpu.shutdown()
        cpu.shutdown()


@pytest.mark.cuda
def test_rebuild_and_flips_retire_graphs(cuda_device):
    eng = _engine(cuda_device)
    try:
        eng.warmup()
        g = eng.trunk_group("intent")
        old = g.demux
        assert old["graphs"].captured() > 0
        eng.configure_quant({"mode": "bf16"})
        assert old["graphs"].retired and old["graphs"].captured() == 0
        assert g.demux["graphs"].captured() == 0
        meta = eng._serving_meta(old)
        with pytest.raises(SnapshotRetired):
            eng._fused_step(g, old, "seq", 32, 1, meta, False,
                            _inputs(1, 32))
        eng.classify("intent", TEXTS[0])
        assert eng.steps()[-1]["graph"] == "captured"
        assert eng.steps()[-1]["quant"] == "bf16"
        eng.configure_kernels({})
        assert eng.classify("intent", TEXTS[0]).label
        assert eng.steps()[-1]["graph"] == "captured"
        assert eng.steps()[-1]["epilogue"] is False
        cache = g.demux["graphs"]
        eng.register_task("user_feedback", "sequence",
                          eng._tasks["user_feedback"].module,
                          eng._tasks["user_feedback"].tokenizer,
                          eng.task_labels("user_feedback"), max_seq_len=128)
        assert cache.retired
    finally:
        eng.shutdown()


@pytest.mark.cuda
def test_a_host_sync_inside_a_captured_step_raises(cuda_device):
    cache = StepGraphs(cuda_device, CaptureGate(), "task:probe")
    ins = _inputs(2, 8)

    def syncs(ids, mask):
        n = int(mask.sum().item())  # a host sync: illegal under capture
        return (ids.float() * n,)

    for _ in range(2):  # no fallback: the second try raises as well
        with pytest.raises(RuntimeError):
            cache.run(("probe",), syncs, ins)
        assert cache.captured() == 0
    # the card is still usable, and a clean step captures
    outs, how = cache.run(("clean",), lambda i, m: (i.float() * m,), ins)
    assert how == "captured"
    assert torch.equal(outs[0], ins[0].float() * ins[1])
    outs, how = cache.run(("clean",), lambda i, m: (i.float() * m,), ins)
    assert how == "replayed"
    assert torch.equal(outs[0], ins[0].float() * ins[1])


@pytest.mark.cuda
def test_a_failed_capture_fails_warmup(cuda_device, monkeypatch):
    eng = _engine(cuda_device)
    try:
        g = eng.trunk_group("intent")
        real = type(g).forward

        def bad(self, ids, mask, *a, **kw):
            mask.sum().item()  # a host sync
            return real(self, ids, mask, *a, **kw)

        monkeypatch.setattr(type(g), "forward", bad)
        with pytest.raises(RuntimeError):
            eng.warmup()
        with pytest.raises(RuntimeError):
            eng.classify("intent", TEXTS[0])
    finally:
        eng.shutdown()


@pytest.mark.cuda
def test_traces_toggle_while_steps_capture(cuda_device, tmp_path):
    """Traces start and stop (as an SLO burn's capture does, under load)
    while serving threads capture steps: kernel flips retire the graphs,
    so every flip is followed by fresh captures.  No trace and no step
    fails."""
    eng = _engine(cuda_device)
    pc = ProfilerControl(base_dir=str(tmp_path))
    stop, errors, traces = threading.Event(), [], []

    def traffic(k):
        i = 0
        while not stop.is_set():
            texts = [TEXTS[(k + j) % len(TEXTS)] * (1 + (i + j) % 6)
                     for j in range(1 + (k + i) % 8)]
            try:
                eng.classify_multi(SEQ_TASKS, texts, timeout=60)
            except Exception as exc:  # reported below
                errors.append(exc)
                return
            i += 1

    threads = [threading.Thread(target=traffic, args=(k,))
               for k in range(6)]
    try:
        for t in threads:
            t.start()
        end = time.monotonic() + 8.0
        n = 0
        while time.monotonic() < end and not errors:
            eng.configure_kernels({} if n % 2 else
                                  {"epilogue": {"enabled": True}})
            traces.append((pc.start(), pc.stop()))
            n += 1
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        captured = sum(1 for s in eng.steps() if s["graph"] == "captured")
        eng.shutdown()
    assert not errors, errors[:3]
    assert all(a.get("started") and b.get("stopped") for a, b in traces), \
        [tr for tr in traces if "error" in tr[0] or "error" in tr[1]][:3]
    assert len(traces) >= 4 and captured >= len(traces)
