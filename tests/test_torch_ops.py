"""The port's ops (ray_lightning_tpu_torch/ops/) against the JAX package's.

Same numpy inputs through both; the JAX side runs its Pallas kernels in
interpret mode (RMSNorm through its reference, which is what it runs off
TPU), the port its plain versions (CPU tensors). fp32 throughout, so the
tolerances only absorb summation order: 1e-6 for the elementwise ops,
2e-5 for attention (sums over up to 64 keys).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.ops import paged_attention as jpa
from ray_lightning_tpu.ops import rope as jrope
from ray_lightning_tpu.ops.rmsnorm import _rmsnorm_ref
from ray_lightning_tpu_torch.ops import attention as tattn
from ray_lightning_tpu_torch.ops import paged_attention as tpa
from ray_lightning_tpu_torch.ops import rope as trope
from ray_lightning_tpu_torch.ops.rmsnorm import rmsnorm, rmsnorm_plain

# the package's ops/__init__ re-exports a function named `attention`
jattn = importlib.import_module("ray_lightning_tpu.ops.attention")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Small shapes run fastest on two threads; restore the process's count
    for the test files that share this worker."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)

LLAMA3 = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
          "high_freq_factor": 4.0, "original_max_position_embeddings": 64}


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 96)).astype(np.float32)
    w = rng.standard_normal((96,)).astype(np.float32)
    want = np.asarray(_rmsnorm_ref(jnp.asarray(x), jnp.asarray(w), 1e-5))
    got = rmsnorm(_t(x), _t(w), 1e-5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got, rmsnorm_plain(_t(x), _t(w), 1e-5).numpy())


@pytest.mark.parametrize("shape", [(8, 4096), (64, 2048)])
def test_rmsnorm_bf16_matches_jax_within_one_ulp(shape):
    """bf16 at the decode and training widths: both sides round one fp32
    value to bf16, so they may differ by one bf16 ulp and no more."""
    import ml_dtypes

    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
    w = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(ml_dtypes.bfloat16)
    want = np.asarray(_rmsnorm_ref(jnp.asarray(x), jnp.asarray(w), 1e-5)).astype(np.float32)
    got = rmsnorm(_t(x.astype(np.float32)).bfloat16(),
                  _t(w.astype(np.float32)).bfloat16(), 1e-5).float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want))) - 7)
    assert np.all(np.abs(got - want) <= ulp)


@pytest.mark.parametrize("scaling", [None, {"rope_type": "linear", "factor": 4.0},
                                     LLAMA3], ids=["default", "linear", "llama3"])
@pytest.mark.parametrize("head_dim", [32, 128])
def test_rope_matches_jax(scaling, head_dim):
    jc, js = jrope.rope_angles(96, head_dim, 500000.0, offset=3, scaling=scaling)
    tc, ts = trope.rope_angles(96, head_dim, 500000.0, offset=3,
                               scaling=scaling, device="cpu")
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=1e-6)
    x = np.random.default_rng(1).standard_normal(
        (2, 96, 3, head_dim)).astype(np.float32)
    want = np.asarray(jrope.apply_rope(jnp.asarray(x), jc, js))
    got = trope.apply_rope(_t(x), tc, ts).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["yarn", "longrope", "dynamic"])
def test_rope_unported_kinds_raise(kind):
    """A scaling dict the reference refuses, the port refuses with the same
    exception class: yarn and longrope without the pretrain length
    (ValueError), the unmapped dynamic kind (NotImplementedError)."""
    scaling = {"rope_type": kind, "factor": 2.0}
    with pytest.raises((ValueError, NotImplementedError)) as ref:
        jrope.rope_angles(8, 16, scaling=scaling)
    with pytest.raises(ref.type):
        trope.rope_angles(8, 16, scaling=scaling, device="cpu")
    assert ref.type is (NotImplementedError if kind == "dynamic"
                        else ValueError)


FLASH_CASES = {
    "causal": dict(hq=4, hkv=4, d=32, causal=True, window=None),
    "full": dict(hq=4, hkv=4, d=32, causal=False, window=None),
    "gqa": dict(hq=8, hkv=2, d=32, causal=True, window=None),
    "window": dict(hq=4, hkv=2, d=32, causal=True, window=24),
    "hd64": dict(hq=4, hkv=2, d=64, causal=True, window=None),
    "group4": dict(hq=16, hkv=4, d=32, causal=True, window=None),
    # a window's edge inside the 16-row blocks
    "window20": dict(hq=4, hkv=2, d=32, causal=True, window=20),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_forward_matches_jax_interpret(case):
    c = FLASH_CASES[case]
    rng = np.random.default_rng(2)
    S = 64
    q = rng.standard_normal((2, c["hq"], S, c["d"])).astype(np.float32)
    k = rng.standard_normal((2, c["hkv"], S, c["d"])).astype(np.float32)
    v = rng.standard_normal((2, c["hkv"], S, c["d"])).astype(np.float32)
    scale = 1.0 / np.sqrt(c["d"])
    # 16-row blocks: a 4 x 4 grid, so block skipping and the online
    # softmax across blocks are exercised on the JAX side
    want_o = jattn.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=c["causal"],
        impl="flash", interpret=True, block_q=16, block_k=16,
        window=c["window"],
    )
    _, want_lse = jattn._flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), c["causal"], scale,
        True, (16, 16), c["window"],
    )
    o, lse = tattn.flash_attention(_t(q), _t(k), _t(v), causal=c["causal"],
                                   window=c["window"])
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               rtol=2e-5, atol=2e-5)
    ref = tattn.attention(_t(q), _t(k), _t(v), causal=c["causal"],
                          window=c["window"])
    np.testing.assert_allclose(ref.numpy(), o.numpy(), rtol=2e-5, atol=2e-5)


def test_attention_window_rules():
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(NotImplementedError):
        tattn.attention(q, q, q, causal=False, window=4)
    with pytest.raises(ValueError):
        tattn.attention(q, q, q, window=0)
    with pytest.raises(ValueError):
        tattn.flash_attention(q, q[:, :, :4], q[:, :, :4])


def test_paged_decode_matches_jax_interpret():
    """Shapes of the JAX kernel's own test, plus a free slot on an
    all-trash table row (pos 0) and positions on block boundaries."""
    rng = np.random.default_rng(2)
    B, Hkv, G, hd, bs, nblk, maxb = 6, 2, 2, 16, 8, 12, 4
    q = rng.standard_normal((B, Hkv, G, hd)).astype(np.float32)
    kc = rng.standard_normal((nblk, Hkv, bs, hd)).astype(np.float32)
    vc = rng.standard_normal((nblk, Hkv, bs, hd)).astype(np.float32)
    tables = rng.integers(1, nblk, (B, maxb)).astype(np.int32)
    tables[3] = 0  # free slot: trash row
    pos = np.asarray([5, 17, 30, 0, 15, 16], np.int32)
    want = jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(tables), jnp.asarray(pos), interpret=True,
    )
    got = tpa.paged_decode_attention(_t(q), _t(kc), _t(vc), _t(tables), _t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_paged_decode_matches_jax_interpret_at_llama3_8b_layout(dtype):
    """Llama-3-8B's decode layout (hd 128, G 4, bs 16) at 7 rows x 2 KV
    heads and 8 blocks a row, pos on page and 64-position edges."""
    import ml_dtypes

    dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype
    rng = np.random.default_rng(6)
    B, Hkv, G, hd, bs, maxb = 7, 2, 4, 128, 16, 8
    nblk = B * maxb + 1
    q = rng.standard_normal((B, Hkv, G, hd)).astype(np.float32)
    kc = rng.standard_normal((nblk, Hkv, bs, hd)).astype(dt)
    vc = rng.standard_normal((nblk, Hkv, bs, hd)).astype(dt)
    tables = rng.permutation(np.arange(1, nblk)).reshape(B, maxb).astype(np.int32)
    pos = np.asarray([0, 15, 16, 63, 64, 65, 127], np.int32)
    want = jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(tables), jnp.asarray(pos), interpret=True,
    )
    as_t = (lambda a: _t(a.astype(np.float32)).bfloat16()) if dtype == "bfloat16" else _t
    got = tpa.paged_decode_attention(_t(q), as_t(kc), as_t(vc), _t(tables), _t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("group", [3, 5, 6, 7])
def test_paged_decode_matches_jax_interpret_at_odd_groups(group):
    """GQA groups the kernel is not instantiated for (Qwen2.5-7B's 7 among
    them): the JAX kernel pads them to its sublane tile, the port's pads
    them to the next instantiated group (its plain version here)."""
    rng = np.random.default_rng(group)
    B, Hkv, hd, bs, maxb = 4, 2, 128, 16, 4
    nblk = B * maxb + 1
    q = rng.standard_normal((B, Hkv, group, hd)).astype(np.float32)
    kc = rng.standard_normal((nblk, Hkv, bs, hd)).astype(np.float32)
    vc = rng.standard_normal((nblk, Hkv, bs, hd)).astype(np.float32)
    tables = rng.permutation(np.arange(1, nblk)).reshape(B, maxb).astype(np.int32)
    pos = np.asarray([0, 17, 40, 63], np.int32)
    want = jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(tables), jnp.asarray(pos), interpret=True,
    )
    got = tpa.paged_decode_attention(_t(q), _t(kc), _t(vc), _t(tables), _t(pos))
    assert got.shape == (B, Hkv, group, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_paged_group_pads_to_the_next_instantiated_group():
    """Groups 1-8 run at the smallest instantiated group that holds them;
    the plan's scratch counts the padded heads; past 8 is refused."""
    assert [tpa.paged_group(g) for g in range(1, 9)] == [1, 2, 4, 4, 8, 8, 8, 8]
    assert tpa.paged_decode_plan(8, 4, 7, 128, 16, 64)["scratch"] == \
        8 * 4 * 16 * 8 * 130
    assert tpa.paged_decode_plan(8, 4, 3, 128, 16, 64) == \
        tpa.paged_decode_plan(8, 4, 4, 128, 16, 64)
    with pytest.raises(ValueError, match="up to 8"):
        tpa.paged_group(9)
    with pytest.raises(ValueError, match="up to 8"):
        tpa.paged_decode_plan(1, 1, 12, 128, 16, 4)


def test_paged_decode_plan_depends_on_host_sizes_only():
    """The kernel's grid and scratch follow from B, Hkv, G, hd, bs and
    max_blocks (never pos): 64-position chunks over the table's span."""
    plan = tpa.paged_decode_plan(8, 8, 4, 128, 16, 64)
    assert plan == {"split": 64, "chunks": 16, "scratch": 8 * 8 * 16 * 4 * 130}
    assert tpa.paged_decode_plan(5, 2, 1, 64, 8, 6)["chunks"] == 1
    assert tpa.paged_decode_plan(5, 2, 1, 64, 24, 6)["chunks"] == 3
    assert tpa.paged_decode_plan(1, 1, 8, 256, 1, 65)["chunks"] == 2
    with pytest.raises(ValueError, match="arrival counters"):
        tpa.paged_decode_plan(tpa.PAGED_MAX_ROWS + 1, 1, 4, 128, 16, 4)


def test_greedy_argmax_matches_jax_with_ties():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 512)).astype(np.float32)
    want = np.asarray(jpa.fused_greedy_sample(jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(tpa.fused_greedy_sample(_t(x)).numpy(), want)
    assert tpa.fused_greedy_sample(_t(x)).dtype == torch.int32
    # tie-break: the first maximum wins, on both sides
    t = np.zeros((1, 512), np.float32)
    t[0, 7] = t[0, 300] = 3.0
    assert int(jpa.fused_greedy_sample(jnp.asarray(t), interpret=True)[0]) == 7
    assert int(tpa.fused_greedy_sample(_t(t))[0]) == 7


def _nan_rows(case, V, rng):
    """Four seeded rows with NaNs planted at V = 1280 (five of the JAX
    kernel's 256-wide blocks) or 128256 (eight of the CUDA kernel's
    chunks at batch 8). Returns the rows and the first NaN of each."""
    x = rng.standard_normal((4, V)).astype(np.float32)
    far = V // 2 + 7  # another block and another chunk than the starts
    if case == "nan_after_max":
        x[:, 100] = 50.0
        nans = [far, far + 1, V - 1, 300]
        for r, j in enumerate(nans):
            x[r, j] = np.nan
    elif case == "nan_before_larger":
        x[:, far] = 50.0
        nans = [3, 0, 255, 256]
        for r, j in enumerate(nans):
            x[r, j] = np.nan
    elif case == "all_nan":
        x[:] = np.nan
        nans = [0, 0, 0, 0]
    else:  # "nan_beside_max": on either side of the maximum
        nans = [far - 1, far + 1, 256, V - 1]
        for r, (j, m) in enumerate(zip(nans, [far, far, 255, V - 2])):
            x[r, m] = 50.0
            x[r, j] = np.nan
        x[1, far + 2] = np.nan  # a later NaN loses to the first
        x[3, 5] = np.inf        # +inf is a number: the NaN still wins
    return x, np.asarray(nans)


@pytest.mark.parametrize("V", [1280, 128256])
@pytest.mark.parametrize("case", ["nan_after_max", "nan_before_larger",
                                  "all_nan", "nan_beside_max"])
def test_greedy_argmax_returns_the_first_nan_as_jnp_argmax(case, V):
    """The documented contract (jnp.argmax, torch.argmax): a row that holds a
    NaN samples its first NaN, wherever the maximum lies."""
    x, first_nan = _nan_rows(case, V, np.random.default_rng(6))
    want = np.asarray(jnp.argmax(jnp.asarray(x), axis=-1))
    np.testing.assert_array_equal(want, first_nan)
    np.testing.assert_array_equal(tpa.blockwise_argmax_plain(_t(x)).numpy(), want)
    np.testing.assert_array_equal(tpa.fused_greedy_sample(_t(x)).numpy(), want)


def test_argmax_plan_depends_on_host_sizes_only():
    """One cluster of chunks per row: at most two blocks per SM over the
    batch, at least 2048 elements a block, 1-8 chunks of a multiple of 4
    elements that cover the row."""
    plans = {(B, V): tpa.argmax_plan(B, V) for B in (1, 3, 8, 64, 1000)
             for V in (1, 3, 1000, 32000, 50257, 128256)}
    assert plans[8, 128256] == {"chunks": 8, "chunk": 16032}
    assert plans[1, 128256]["chunks"] == 8
    assert plans[64, 128256]["chunks"] == 4
    assert plans[1000, 128256]["chunks"] == 1
    assert plans[8, 1000]["chunks"] == plans[8, 1]["chunks"] == 1
    for (B, V), p in plans.items():
        assert 1 <= p["chunks"] <= tpa.ARGMAX_MAX_CHUNKS
        assert p["chunk"] % 4 == 0 and p["chunks"] * p["chunk"] >= V
        assert B * p["chunks"] <= max(B, 2 * 132)
    assert tpa.argmax_plan(8, 128256, sms=16)["chunks"] == 4


def test_argmax_plan_at_the_moe_serving_vocabulary():
    """Mixtral's vocabulary (32000) at the MoE serving batch: a full
    cluster of 8 chunks of 4000 elements, each a whole number of 16-byte
    vectors, with no chunk left empty; greedy and noisy rows match
    jnp.argmax through the plain version."""
    p = tpa.argmax_plan(8, 32000)
    assert p == {"chunks": 8, "chunk": 4000}
    assert (p["chunks"] - 1) * p["chunk"] < 32000
    rng = np.random.default_rng(11)
    x = rng.standard_normal((8, 32000)).astype(np.float32)
    x[0, [3999, 4000]] = x.max() + 1.0  # a tie across a chunk edge
    noise = rng.gumbel(size=(8, 32000)).astype(np.float32)
    for nz in (None, noise):
        want = np.asarray(jnp.argmax(jnp.asarray(x if nz is None else x + nz),
                                     axis=-1))
        got = tpa.blockwise_argmax(_t(x), None if nz is None else _t(nz))
        np.testing.assert_array_equal(got.numpy(), want)
    assert int(tpa.blockwise_argmax(_t(x))[0]) == 3999


def test_noisy_argmax_matches_jax_on_same_noise():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((4, 1024)) / 0.8).astype(np.float32)
    noise = rng.gumbel(size=(4, 1024)).astype(np.float32)
    want = np.asarray(jpa._blockwise_argmax(jnp.asarray(x), jnp.asarray(noise),
                                            interpret=True))
    got = tpa.blockwise_argmax(_t(x), _t(noise)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("top_k,top_p,expect", [
    (None, None, True), (0, 1.0, True), (5, None, False), (None, 0.9, False),
])
def test_fused_sample_supported_matches_jax(top_k, top_p, expect):
    assert tpa.fused_sample_supported(0.7, top_k, top_p) is expect
    assert jpa.fused_sample_supported(0.7, top_k, top_p) is expect
    if not expect:
        with pytest.raises(ValueError):
            tpa.fused_sample(torch.zeros(1, 8), torch.Generator(), 0.7,
                             top_k, top_p)


def test_fused_temperature_sample_is_gumbel_argmax():
    x = torch.randn(3, 257, generator=torch.Generator().manual_seed(1))
    got = tpa.fused_sample(x, torch.Generator().manual_seed(9), 0.8)
    noise = tpa.gumbel_noise(x.shape, torch.Generator().manual_seed(9), "cpu")
    want = torch.argmax(x / 0.8 + noise, dim=-1).to(torch.int32)
    torch.testing.assert_close(got, want)


@pytest.mark.parametrize("op", ["rmsnorm", "flash", "paged", "argmax"])
def test_wrappers_refuse_non_cpu_non_cuda_tensors(op):
    """Only a CPU tensor takes the plain version. A meta tensor, which the
    profiler counts programs on, takes the kernel's route without computing
    anything: it records the kernel's cost once, launches nothing and
    returns meta outputs of the kernel's shapes. The kernel's own guard
    still refuses every tensor that is not a CUDA tensor."""
    from ray_lightning_tpu_torch import kernels
    from ray_lightning_tpu_torch.observability.profiler import CostCounter

    m = torch.empty((2, 4, 8, 16), device="meta")
    kernel = {"rmsnorm": "rmsnorm", "flash": "flash_fwd",
              "paged": "paged_decode", "argmax": "argmax"}[op]
    before = kernels.launch_counts()
    with CostCounter() as counter:
        if op == "rmsnorm":
            out = (rmsnorm(m, torch.empty((16,), device="meta")),)
        elif op == "flash":
            out = tattn.flash_attention(m, m, m)
        elif op == "paged":
            out = (tpa.paged_decode_attention(
                m, m, m, torch.empty((2, 3), dtype=torch.int32, device="meta"),
                torch.empty((2,), dtype=torch.int32, device="meta"),
            ),)
        else:
            out = (tpa.blockwise_argmax(m[0, 0]),)
    assert all(t.is_meta for t in out)
    assert set(counter.kernels) == {kernel}
    assert counter.kernels[kernel]["launches"] == 1
    assert kernels.launch_counts() == before
    for t in (m, torch.zeros(2)):
        with pytest.raises(ValueError, match="CUDA"):
            kernels.require_cuda(kernel, t)
