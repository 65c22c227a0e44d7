"""Parity of the PyTorch port's ops (semantic_router_tpu_torch.ops) with
the JAX reference on the CPU, the kernels' plain versions against the
Pallas kernels in interpret mode (the BGMV op's in test_torch_bgmv.py), the port's import isolation, and — on a
machine with a CUDA device only — the hand-written kernels themselves.

Inputs are numpy arrays from a seed, handed to both frameworks."""

import ast
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_router_tpu.ops import attention as jattn
from semantic_router_tpu.ops import rope as jrope
from semantic_router_tpu.ops.epilogue import head_epilogue_pallas
from semantic_router_tpu.ops.flash_attention import flash_attention_pallas
from semantic_router_tpu_torch.ops import attention as tattn
from semantic_router_tpu_torch.ops import rope as trope
from semantic_router_tpu_torch.ops.bgmv import bgmv, bgmv_reference
from semantic_router_tpu_torch.ops.epilogue import (
    ACTIVATIONS,
    head_epilogue,
    head_epilogue_reference,
)
from semantic_router_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
)

REPO = pathlib.Path(__file__).resolve().parents[1]


def rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(got, want, atol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


class TestRope:
    @pytest.mark.parametrize("yarn", [None, {"rope_type": "yarn",
                                             "factor": 4.0,
                                             "original_max_position_embeddings":
                                             64}])
    def test_tables_match(self, yarn):
        for base in (10000.0, 160000.0):
            jspec = jrope.RopeSpec(16, base, yarn=yarn)
            tspec = trope.RopeSpec(16, base, yarn=yarn)
            np.testing.assert_array_equal(jspec.inv_freq, tspec.inv_freq)
            assert jspec.attention_scaling == tspec.attention_scaling
            jc, js = jspec.tables(40)
            tc, ts = tspec.tables(40, torch.device("cpu"))
            close(tc, jc, 0.0)
            close(ts, js, 0.0)

    def test_rope_tables_function(self):
        inv = jrope.default_inv_freq(8, 10000.0)
        np.testing.assert_array_equal(inv, trope.default_inv_freq(8, 10000.0))
        jc, js = jrope.rope_tables(inv, 12, attention_scaling=1.3)
        tc, ts = trope.rope_tables(inv, 12, attention_scaling=1.3)
        close(t(tc), jc, 0.0)
        close(t(ts), js, 0.0)

    def test_yarn_inv_freq(self):
        ji, js = jrope.yarn_inv_freq(32, 160000.0, 8.0, 4096)
        ti, ts = trope.yarn_inv_freq(32, 160000.0, 8.0, 4096)
        np.testing.assert_array_equal(ji, ti)
        assert js == ts

    def test_apply_rotary(self):
        q, k = rand(2, 3, 10, 8, seed=1), rand(2, 3, 10, 8, seed=2)
        cos, sin = trope.rope_tables(trope.default_inv_freq(8, 1e4), 10)
        jq, jk = jrope.apply_rotary(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(cos), jnp.asarray(sin))
        tq, tk = trope.apply_rotary(t(q), t(k), t(cos), t(sin))
        close(tq, jq, 1e-5)
        close(tk, jk, 1e-5)


class TestAttention:
    def test_biases(self):
        mask = (np.arange(12)[None] < np.array([[12], [7]])).astype(np.int32)
        close(tattn.padding_bias(t(mask)), jattn.padding_bias(mask), 0.0)
        close(tattn.sliding_window_bias(12, 4),
              jattn.sliding_window_bias(12, 4), 0.0)

    def test_sdpa_with_bias(self):
        q, k, v = (rand(2, 2, 16, 8, seed=s) for s in (3, 4, 5))
        mask = (np.arange(16)[None] < np.array([[16], [9]])).astype(np.int32)
        jb = jattn.padding_bias(mask) + jattn.sliding_window_bias(16, 6)
        tb = tattn.padding_bias(t(mask)) + tattn.sliding_window_bias(16, 6)
        close(tattn.sdpa(t(q), t(k), t(v), bias=tb),
              jattn.sdpa(q, k, v, bias=jb), 1e-5)

    @pytest.mark.parametrize("window,block", [(0, 8), (6, 8), (4, 5)])
    def test_chunked_sdpa(self, window, block):
        q, k, v = (rand(2, 2, 21, 8, seed=s) for s in (6, 7, 8))
        mask = (np.arange(21)[None] < np.array([[21], [13]])).astype(np.int32)
        ref = jattn.chunked_sdpa(q, k, v, key_padding_mask=mask,
                                 window=window, block_size=block)
        got = tattn.chunked_sdpa(t(q), t(k), t(v),
                                 key_padding_mask=t(mask), window=window,
                                 block_size=block)
        close(got, ref, 1e-5)

    def test_pools(self):
        h = rand(3, 7, 5, seed=9)
        mask = (np.arange(7)[None] < np.array([[7], [3], [1]])
                ).astype(np.int32)
        close(tattn.mean_pool(t(h), t(mask)), jattn.mean_pool(h, mask), 1e-5)
        close(tattn.cls_pool(t(h)), jattn.cls_pool(h), 0.0)


def _flash_case(case):
    """(q, k, v, mask or None, kwargs, real query rows per batch row: a
    prefix length or a boolean row mask): the cases of
    tests/test_flash_attention.py, a mask with holes and a batch row that
    is all padding."""
    name = case
    if name == "global":
        q, k, v = (rand(2, 2, 64, 32, seed=s) for s in (1, 2, 3))
        return q, k, v, None, {}, [64, 64]
    if name == "window":
        q, k, v = (rand(1, 2, 64, 16, seed=s) for s in (4, 5, 6))
        return q, k, v, None, {"window": 16}, [64]
    if name == "padding":
        q, k, v = (rand(2, 1, 48, 16, seed=s) for s in (7, 8, 9))
        mask = np.concatenate([np.ones((2, 30)), np.zeros((2, 18))], 1)
        return q, k, v, mask.astype(np.float32), {}, [30, 30]
    if name == "causal":
        q, k, v = (rand(1, 1, 32, 16, seed=s) for s in (10, 11, 12))
        return q, k, v, None, {"causal": True}, [32]
    if name == "non_divisible":
        q, k, v = (rand(1, 2, 50, 16, seed=s) for s in (13, 14, 15))
        return q, k, v, None, {}, [50]
    if name == "window_padding":
        q, k, v = (rand(2, 2, 64, 16, seed=s) for s in (16, 17, 18))
        mask = np.concatenate([np.ones((2, 40)), np.zeros((2, 24))], 1)
        return q, k, v, mask.astype(np.float32), {"window": 16}, [40, 40]
    if name in ("mask_holes", "mask_holes_window"):
        # row 0: keys 64..127 (two whole 32-key tiles of the kernel) and
        # a few scattered keys masked; row 1: every other 16-key block
        # masked, and the ragged tail
        q, k, v = (rand(2, 2, 150, 16, seed=s) for s in (22, 23, 24))
        mask = np.ones((2, 150), np.float32)
        mask[0, 64:128] = 0
        mask[0, [3, 40, 131, 132]] = 0
        for b0 in range(16, 150, 32):
            mask[1, b0:b0 + 16] = 0
        mask[1, 140:] = 0
        kw = {"window": 32} if name == "mask_holes_window" else {}
        return q, k, v, mask, kw, list(mask.astype(bool))
    if name == "all_padding_row":
        q, k, v = (rand(3, 2, 72, 16, seed=s) for s in (25, 26, 27))
        mask = np.zeros((3, 72), np.float32)
        mask[0], mask[2, :30] = 1, 1
        return q, k, v, mask, {}, [72, 0, 30]
    raise KeyError(name)


FLASH_CASES = ["global", "window", "padding", "causal", "non_divisible",
               "window_padding", "mask_holes", "mask_holes_window",
               "all_padding_row"]


def _rows(real):
    """Index of the real query rows: a prefix length or a row mask."""
    if isinstance(real, (int, np.integer)):
        return slice(None, int(real))
    return torch.from_numpy(np.flatnonzero(real))


class TestFlashPlainVersion:
    @pytest.mark.parametrize("case", FLASH_CASES)
    def test_plain_matches_pallas_interpret(self, case):
        q, k, v, mask, kw, real = _flash_case(case)
        ref = flash_attention_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            None if mask is None else jnp.asarray(mask),
            block_q=16, block_k=16, interpret=True, **kw)
        tm = None if mask is None else t(mask)
        got = flash_attention_reference(t(q), t(k), t(v), tm, **kw)
        # the dispatching entry takes the plain version for CPU tensors
        via_entry = flash_attention(t(q), t(k), t(v), tm, **kw)
        ref = torch.from_numpy(np.array(ref))
        for b, L in enumerate(real):
            rows = _rows(L)
            close(got[b, :, rows], ref[b, :, rows].numpy(), 1e-5)
            close(via_entry[b, :, rows], ref[b, :, rows].numpy(), 1e-5)
        assert torch.isfinite(got).all()

    def test_bf16_inputs(self):
        q, k, v = (rand(1, 1, 32, 16, seed=s) for s in (19, 20, 21))
        ref = flash_attention_pallas(
            *(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)),
            block_q=16, block_k=16, interpret=True)
        got = flash_attention(*(t(x).to(torch.bfloat16) for x in (q, k, v)))
        assert got.dtype == torch.bfloat16
        close(got.float(), np.asarray(ref, dtype=np.float32), 2e-2)


class TestEpiloguePlainVersion:
    @pytest.mark.parametrize("with_bias,with_delta", [
        (False, False), (True, False), (True, True)])
    def test_plain_matches_pallas_interpret(self, with_bias, with_delta):
        rng = np.random.default_rng(5)
        T, rows, D, H = 3, 10, 32, 40
        x = rng.standard_normal((rows, D)).astype(np.float32)
        K = (rng.standard_normal((T, D, H)) * 0.1).astype(np.float32)
        b = rng.standard_normal((T, H)).astype(np.float32) \
            if with_bias else None
        d = (rng.standard_normal((rows, T, H)) * 0.1).astype(np.float32) \
            if with_delta else None
        act = lambda h: jax.nn.gelu(h, approximate=False)  # noqa: E731
        ref = head_epilogue_pallas(
            jnp.asarray(x), jnp.asarray(K),
            None if b is None else jnp.asarray(b),
            None if d is None else jnp.asarray(d), act, block_rows=4,
            interpret=True)
        tb = None if b is None else t(b)
        td = None if d is None else t(d)
        got = head_epilogue_reference(t(x), t(K), tb, td, "gelu")
        assert np.max(np.abs(got.numpy() - np.asarray(ref))) <= 1e-4
        via_entry = head_epilogue(t(x), t(K), tb, td, "gelu")
        assert np.max(np.abs(via_entry.numpy() - np.asarray(ref))) <= 1e-4

    @pytest.mark.parametrize("rows", [1, 64, 65])
    def test_plain_matches_pallas_interpret_rows(self, rows):
        """Row counts on both sides of the kernel's path switch (the
        weight-streaming kernel takes rows <= 64, the GEMM the rest)."""
        rng = np.random.default_rng(rows)
        T, D, H = 3, 48, 40
        x = rng.standard_normal((rows, D)).astype(np.float32)
        K = (rng.standard_normal((T, D, H)) * 0.1).astype(np.float32)
        b = rng.standard_normal((T, H)).astype(np.float32)
        d = (rng.standard_normal((rows, T, H)) * 0.1).astype(np.float32)
        ref = head_epilogue_pallas(
            jnp.asarray(x), jnp.asarray(K), jnp.asarray(b), jnp.asarray(d),
            lambda h: jax.nn.gelu(h, approximate=False), block_rows=16,
            interpret=True)
        got = head_epilogue(t(x), t(K), t(b), t(d), "gelu")
        assert got.shape == (rows, T, H)
        assert np.max(np.abs(got.numpy() - np.asarray(ref))) <= 1e-4

    @pytest.mark.parametrize("name,jax_act", [
        ("gelu", lambda h: jax.nn.gelu(h, approximate=False)),
        ("gelu_pytorch_tanh", lambda h: jax.nn.gelu(h, approximate=True)),
        ("relu", jax.nn.relu),
        ("silu", jax.nn.silu),
        ("identity", lambda h: h),
    ])
    def test_activations_match_jax(self, name, jax_act):
        assert name in ACTIVATIONS
        x = rand(6, 8, seed=3)
        K = rand(2, 8, 5, seed=4, scale=0.3)
        ref = jax_act(jnp.einsum("bd,tdh->bth", x, K))
        close(head_epilogue(t(x), t(K), act=name), ref, 1e-5)

    def test_unknown_activation_raises(self):
        with pytest.raises(ValueError):
            head_epilogue(t(rand(2, 4)), t(rand(1, 4, 4)), act="mish")


# ---------------------------------------------------------------------------
# the hand-written kernels (CUDA only)


def _router_mix(rows, tasks):
    n = rows * tasks
    idx = np.zeros(1 << (n - 1).bit_length(), np.int32)
    idx[:n] = np.tile(np.arange(tasks), rows)
    return idx


def _bad_mixed():
    """The router mix with out-of-range indices on either side of [0, 32)
    mixed into its segments."""
    idx = _router_mix(16, 5)
    idx[4::9], idx[6::13], idx[100] = -3, 32, 1 << 30
    return idx


# name -> () -> (T, D, H, idx, dtype, tol)
BGMV_GROUPED = {
    "router_mix": lambda: (32, 768, 768, _router_mix(16, 5), torch.float32,
                           1e-4),
    "full_fanout_P512": lambda: (32, 768, 768, _router_mix(16, 32),
                                 torch.float32, 1e-4),
    "full_fanout_P512_bf16": lambda: (32, 768, 768, _router_mix(16, 32),
                                      torch.bfloat16, 2e-2),
    "many_tasks_one_pair": lambda: (32, 768, 768,
                                    np.random.default_rng(0).permutation(32),
                                    torch.float32, 1e-4),
    "all_dummy": lambda: (32, 768, 768, np.zeros(64, np.int32),
                          torch.float32, 1e-4),
    "one_task_P256": lambda: (32, 768, 768, np.full(256, 7), torch.float32,
                              1e-4),
    "bad_mixed": lambda: (32, 768, 768, _bad_mixed(), torch.float32, 1e-4),
    "P77_D32_H40": lambda: (5, 32, 40, np.random.default_rng(77).integers(
        0, 5, 77), torch.float32, 1e-4),
    "cls_H8": lambda: (32, 768, 8, _router_mix(16, 5), torch.float32, 1e-4),
    "odd_D30_H37": lambda: (4, 30, 37, np.random.default_rng(3).integers(
        0, 4, 50), torch.float32, 1e-4),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
class TestCudaKernels:
    @pytest.mark.parametrize("case", FLASH_CASES)
    def test_flash_kernel_vs_plain(self, cuda_device, case):
        q, k, v, mask, kw, real = _flash_case(case)
        dev = [t(x).to(cuda_device) for x in (q, k, v)]
        tm = None if mask is None else t(mask).to(cuda_device)
        got = flash_attention(*dev, tm, **kw)
        again = flash_attention(*dev, tm, **kw)
        ref = flash_attention_reference(t(q), t(k), t(v),
                                        None if mask is None else t(mask),
                                        **kw)
        assert torch.equal(got, again)  # no atomics: the same bits
        got = got.cpu()
        assert torch.isfinite(got).all()  # all-padding rows included
        for b, L in enumerate(real):
            rows = _rows(L)
            close(got[b, :, rows], ref[b, :, rows].numpy(), 1e-5)

    @pytest.mark.parametrize("with_bias,with_delta", [
        (False, False), (True, True)])
    def test_epilogue_kernel_vs_plain(self, cuda_device, with_bias,
                                      with_delta):
        x, K = rand(37, 64, seed=1), rand(3, 64, 80, seed=2, scale=0.1)
        b = rand(3, 80, seed=3) if with_bias else None
        d = rand(37, 3, 80, seed=4, scale=0.1) if with_delta else None
        on = (lambda a: None if a is None else t(a).to(cuda_device))
        got = head_epilogue(on(x), on(K), on(b), on(d), "gelu").cpu()
        ref = head_epilogue_reference(t(x), t(K),
                                      None if b is None else t(b),
                                      None if d is None else t(d), "gelu")
        close(got, ref.numpy(), 1e-4)

    @pytest.mark.parametrize("rows", [1, 64, 65])
    def test_epilogue_kernel_path_switch(self, cuda_device, rows):
        """768x768 heads at rows on both sides of the launcher's switch
        (weight streaming at <= 64 rows, the 3xTF32 GEMM above)."""
        x, K = rand(rows, 768, seed=5), rand(3, 768, 768, seed=6, scale=0.05)
        b, d = rand(3, 768, seed=7), rand(rows, 3, 768, seed=8, scale=0.1)
        on = (lambda a: t(a).to(cuda_device))
        got = head_epilogue(on(x), on(K), on(b), on(d), "gelu")
        assert torch.equal(got, head_epilogue(on(x), on(K), on(b), on(d),
                                              "gelu"))
        ref = head_epilogue_reference(t(x), t(K), t(b), t(d), "gelu")
        close(got.cpu(), ref.numpy(), 1e-4)

    @pytest.mark.parametrize("T,P,D,H", [(5, 9, 32, 40), (5, 1, 32, 40),
                                         (3, 37, 768, 8), (32, 64, 768, 768)])
    def test_bgmv_kernel_vs_plain(self, cuda_device, T, P, D, H):
        rng = np.random.default_rng(P)
        x, w = rand(P, D, seed=1), rand(T, D, H, seed=2, scale=0.05)
        idx = rng.integers(0, T, P).astype(np.int32)
        got = bgmv(t(x).to(cuda_device), t(w).to(cuda_device),
                   t(idx).to(cuda_device)).cpu()
        close(got, bgmv_reference(t(x), t(w), t(idx)).numpy(), 1e-4)

    @pytest.mark.parametrize("case", list(BGMV_GROUPED))
    def test_bgmv_grouped_kernel_vs_plain(self, cuda_device, case):
        """The task-grouped kernel at the engine's pair orders and edges:
        the plain version's rows, NaN rows for out-of-range indices, and
        the same bits from two launches."""
        T, D, H, idx, dtype, tol = BGMV_GROUPED[case]()
        P = len(idx)
        x = t(rand(P, D, seed=1)).to(cuda_device, dtype)
        w = t(rand(T, D, H, seed=2, scale=0.05)).to(cuda_device, dtype)
        ix = t(np.asarray(idx, np.int32)).to(cuda_device)
        got = bgmv(x, w, ix)
        assert torch.equal(got, bgmv(x, w, ix))
        bad = (ix < 0) | (ix >= T)
        assert torch.isnan(got[bad]).all()
        ref = bgmv_reference(x[~bad].float(), w.float(), ix[~bad])
        close(got[~bad].float().cpu(), ref.cpu().numpy(), tol)

    def test_bgmv_kernel_refusals_and_bad_index(self, cuda_device):
        x = t(rand(4, 16)).to(cuda_device)
        w = t(rand(3, 16, 8)).to(cuda_device)
        idx = torch.tensor([0, 5, 2, -1], dtype=torch.int32,
                           device=cuda_device)
        out = bgmv(x, w, idx).cpu()
        assert torch.isnan(out[[1, 3]]).all()
        assert torch.isfinite(out[[0, 2]]).all()
        with pytest.raises(ValueError, match="int32"):
            bgmv(x, w, idx.long())
        with pytest.raises(ValueError, match="contiguous"):
            bgmv(x.t().contiguous().t(), w, idx)


def test_flash_tile_pairs_rule():
    """The kernel's visit rule: a 64-row Q tile with no real query does no
    work, a 32-key K tile with no real key is skipped, the window clips."""
    from semantic_router_tpu_torch.ops.flash_attention import \
        flash_tile_pairs

    mask = torch.zeros(2, 100, dtype=torch.int32)
    mask[0, :40] = 1  # Q tiles (real, none), K tiles (real, real, -, -)
    assert flash_tile_pairs(mask, 2, 100) == {
        "computed": 2, "clipped": 16, "total": 16}
    assert flash_tile_pairs(None, 2, 100) == {
        "computed": 16, "clipped": 16, "total": 16}
    # window 128: a Q tile sees keys q0 - 64 .. q0 + 127, six K tiles, or
    # four at either end of the sequence
    local = flash_tile_pairs(None, 1, 512, window=128)
    assert local == {"computed": 6 * 6 + 2 * 4, "clipped": 44, "total": 128}
    causal = flash_tile_pairs(None, 1, 128, causal=True)
    assert causal == {"computed": 6, "clipped": 6, "total": 8}


def test_build_key_covers_headers(tmp_path):
    """A kernel library is named by a digest of its source AND the
    csrc/*.cuh headers beside it: editing a shared header must not load a
    stale build."""
    from semantic_router_tpu_torch.ops import _cuda

    for name in ("head_epilogue.cu", "tf32x3.cuh"):
        (tmp_path / name).write_bytes((pathlib.Path(_cuda.CSRC_DIR)
                                       / name).read_bytes())
    k = _cuda.CudaKernel("head_epilogue", "srt_head_epilogue", [],
                         csrc_dir=str(tmp_path))
    before = k.library_path()
    assert before == k.library_path()
    (tmp_path / "notes.txt").write_text("not a source")
    assert k.library_path() == before
    header = tmp_path / "tf32x3.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after_header = k.library_path()
    assert after_header != before
    src = tmp_path / "head_epilogue.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert k.library_path() not in (before, after_header)
    # the shipped kernels' names do not depend on where the tree lies
    assert os.path.basename(_cuda.registry()["head_epilogue"]
                            .library_path()) == os.path.basename(before)


# ---------------------------------------------------------------------------
# isolation: the port never reaches JAX or the JAX package


def _port_sources():
    files = sorted((REPO / "semantic_router_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_port_sources_cover_every_package():
    """The scan below reaches every package of the port, the state
    plane's, the RESP family's, the retrieval plane's, the dual-path
    engine's, the packing scheduler's, config management's (the
    validator, versions, canonical export, the routing DSL, the
    dashboard's session tokens), the ExtProc filter's (its generated
    protobuf module, the streamed handler, the compose renderer) and the
    decision record's and the dashboard's (router replay, OTLP export,
    selector artifact training, the benchmark harness, the jobs, the
    embedding map, NL generation) and the operator plane's (the CRDs, the
    file and Kubernetes operators, checkpoint download, the fleet
    simulator, the Gemma encoder) included."""
    scanned = {p.parent.name for p in _port_sources()}
    for pkg in ("state", "stateplane", "cache", "router", "runtime",
                "resilience", "ops", "ann", "vectorstore", "memory",
                "packing", "config", "dsl", "dashboard", "extproc",
                "replay", "training", "modelselection", "fleetsim"):
        assert pkg in scanned, pkg
    port = REPO / "semantic_router_tpu_torch"
    for rel in ("stateplane/plane.py", "state/resp.py", "state/qdrant.py",
                "state/milvus.py", "cache/ann_cache.py",
                "memory/ann_store.py", "stateplane/vectorstore.py",
                "ann/bank.py", "ann/search.py", "ann/plane.py",
                "vectorstore/store.py", "vectorstore/ann_store.py",
                "engine/pathing.py", "models/lora.py",
                "state/llamastack.py", "state/postgres.py",
                "vectorstore/pg_registry.py", "engine/packing/__init__.py",
                "engine/packing/packer.py", "engine/packing/scheduler.py",
                "engine/packing/autotuner.py", "config/validator.py",
                "config/versions.py", "config/canonical.py",
                "config/loader.py", "dsl/__init__.py", "dsl/parser.py",
                "dsl/compiler.py", "dashboard/__init__.py",
                "dashboard/auth.py", "extproc/__init__.py",
                "extproc/server.py", "extproc/streamed.py",
                "extproc/external_processor_pb2.py", "runtime/compose.py",
                "runtime/events.py", "replay/__init__.py",
                "replay/recorder.py", "replay/sqlite_store.py",
                "replay/postgres_store.py", "observability/otlp.py",
                "training/__init__.py", "training/selection_train.py",
                "modelselection/__init__.py", "modelselection/analyzer.py",
                "modelselection/benchmark.py", "dashboard/jobs.py",
                "dashboard/embedmap.py", "dsl/nlgen.py", "mcp/__init__.py",
                "mcp/client.py", "mcp/classifier.py", "signals/remote.py",
                "observability/fleetobs.py", "observability/grafana.py",
                "observability/metrics_lint.py", "runtime/operator.py",
                "runtime/crds.py", "runtime/kubewatch.py",
                "runtime/modeldownload.py", "fleetsim/__init__.py",
                "fleetsim/sim.py", "fleetsim/__main__.py",
                "models/gemma.py"):
        assert port / rel in _port_sources(), rel


def _forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return root in ("jax", "jaxlib", "flax", "optax", "semantic_router_tpu")


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path}: imports {bad}"


def test_import_and_cpu_engine_leave_jax_unloaded():
    code = (
        "import importlib, pkgutil, sys\n"
        "import semantic_router_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "assert {'semantic_router_tpu_torch.state.resp',\n"
        "        'semantic_router_tpu_torch.state.rediscluster',\n"
        "        'semantic_router_tpu_torch.stateplane.plane',\n"
        "        'semantic_router_tpu_torch.stateplane.harness',\n"
        "        'semantic_router_tpu_torch.stateplane.vectorstore',\n"
        "        'semantic_router_tpu_torch.state.qdrant',\n"
        "        'semantic_router_tpu_torch.state.milvus',\n"
        "        'semantic_router_tpu_torch.cache.ann_cache',\n"
        "        'semantic_router_tpu_torch.memory.ann_store',\n"
        "        'semantic_router_tpu_torch.ann.bank',\n"
        "        'semantic_router_tpu_torch.ann.search',\n"
        "        'semantic_router_tpu_torch.ann.plane',\n"
        "        'semantic_router_tpu_torch.ann.sync',\n"
        "        'semantic_router_tpu_torch.ann.tiering',\n"
        "        'semantic_router_tpu_torch.vectorstore.store',\n"
        "        'semantic_router_tpu_torch.vectorstore.sqlite_store',\n"
        "        'semantic_router_tpu_torch.vectorstore.ann_store',\n"
        "        'semantic_router_tpu_torch.vectorstore.pg_registry',\n"
        "        'semantic_router_tpu_torch.state.llamastack',\n"
        "        'semantic_router_tpu_torch.state.postgres',\n"
        "        'semantic_router_tpu_torch.engine.pathing',\n"
        "        'semantic_router_tpu_torch.engine.packing.packer',\n"
        "        'semantic_router_tpu_torch.engine.packing.scheduler',\n"
        "        'semantic_router_tpu_torch.engine.packing.autotuner',\n"
        "        'semantic_router_tpu_torch.models.lora',\n"
        "        'semantic_router_tpu_torch.config.validator',\n"
        "        'semantic_router_tpu_torch.config.versions',\n"
        "        'semantic_router_tpu_torch.config.canonical',\n"
        "        'semantic_router_tpu_torch.dsl.parser',\n"
        "        'semantic_router_tpu_torch.dsl.compiler',\n"
        "        'semantic_router_tpu_torch.dashboard.auth',\n"
        "        'semantic_router_tpu_torch.extproc.server',\n"
        "        'semantic_router_tpu_torch.extproc.streamed',\n"
        "        'semantic_router_tpu_torch.extproc.external_processor_pb2',\n"
        "        'semantic_router_tpu_torch.runtime.compose',\n"
        "        'semantic_router_tpu_torch.replay.recorder',\n"
        "        'semantic_router_tpu_torch.replay.sqlite_store',\n"
        "        'semantic_router_tpu_torch.replay.postgres_store',\n"
        "        'semantic_router_tpu_torch.observability.otlp',\n"
        "        'semantic_router_tpu_torch.training.selection_train',\n"
        "        'semantic_router_tpu_torch.modelselection.benchmark',\n"
        "        'semantic_router_tpu_torch.modelselection.analyzer',\n"
        "        'semantic_router_tpu_torch.dashboard.jobs',\n"
        "        'semantic_router_tpu_torch.dashboard.embedmap',\n"
        "        'semantic_router_tpu_torch.dsl.nlgen',\n"
        "        'semantic_router_tpu_torch.mcp.client',\n"
        "        'semantic_router_tpu_torch.mcp.classifier',\n"
        "        'semantic_router_tpu_torch.signals.remote',\n"
        "        'semantic_router_tpu_torch.observability.fleetobs',\n"
        "        'semantic_router_tpu_torch.observability.grafana',\n"
        "        'semantic_router_tpu_torch.observability.metrics_lint',\n"
        "        'semantic_router_tpu_torch.runtime.operator',\n"
        "        'semantic_router_tpu_torch.runtime.crds',\n"
        "        'semantic_router_tpu_torch.runtime.kubewatch',\n"
        "        'semantic_router_tpu_torch.runtime.modeldownload',\n"
        "        'semantic_router_tpu_torch.fleetsim.sim',\n"
        "        'semantic_router_tpu_torch.models.gemma'} \\\n"
        "    <= set(sys.modules)\n"
        "from semantic_router_tpu_torch.engine.testing import "
        "make_dual_path_engine, make_shared_trunk_engine\n"
        "e = make_shared_trunk_engine(device='cpu')\n"
        "assert e.classify('intent', 'hello there').label\n"
        "assert len(e.classify_batch('intent', ['a b', 'c', 'd e f'])) == 3\n"
        "assert any(s.get('variant', '').startswith('packed:')\n"
        "           for s in e.steps())\n"
        "e.shutdown()\n"
        "e = make_dual_path_engine(device='cpu', strategy='stacked')\n"
        "out = e.classify_multi(['intent', 'jailbreak'], ['hello there'])\n"
        "assert e.last_path_selection.selected_path == 'stacked', out\n"
        "e.shutdown()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'semantic_router_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def test_operator_plane_imports_load_no_yaml():
    """``yaml`` is imported where a CR or config file is read or written,
    not when the operator plane's modules are imported (the card's machine
    may lack it)."""
    code = ("import sys\n"
            "import semantic_router_tpu_torch.runtime.operator\n"
            "import semantic_router_tpu_torch.runtime.crds\n"
            "import semantic_router_tpu_torch.runtime.kubewatch\n"
            "import semantic_router_tpu_torch.runtime.modeldownload\n"
            "import semantic_router_tpu_torch.fleetsim.__main__\n"
            "import semantic_router_tpu_torch.models.gemma\n"
            "assert 'yaml' not in sys.modules\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"


def test_entry_points_refuse_the_cpu_without_being_asked(monkeypatch,
                                                         tmp_path):
    from semantic_router_tpu_torch.config import load_config
    from semantic_router_tpu_torch.engine import InferenceEngine
    from semantic_router_tpu_torch.runtime import build_engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config({"classifier_models": {
        "intent": {"checkpoint": str(tmp_path), "kind": "sequence"}}})
    with pytest.raises(RuntimeError, match="CUDA"):
        build_engine(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(device="cuda")
