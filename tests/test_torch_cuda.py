"""The port's CUDA kernels against their plain versions, on the card.

These need a CUDA device (and nvcc) and skip without one. The machine with
the card has no JAX, and tests/conftest.py imports it, so run them there
without the conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

Shapes are small and deliberately odd (ragged tiles, head dim 64, groups
of 1 and 8, block sizes 8 and 32, a vocabulary that is no power of two),
beside the main-path shapes chip_smoke.py checks.
"""
import dataclasses

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(a, b, tol):
    torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 64), (3, 5, 96), (17, 4096)])
def test_rmsnorm_kernel(cuda, dtype, shape):
    from ray_lightning_tpu_torch.ops.rmsnorm import RMSNORM_KERNEL, rmsnorm, rmsnorm_plain

    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    w = torch.randn(shape[-1], generator=g, device=cuda).to(dtype)
    before = RMSNORM_KERNEL.launches
    got = rmsnorm(x, w, 1e-5)
    assert RMSNORM_KERNEL.launches == before + 1
    _close(got, rmsnorm_plain(x, w, 1e-5), 1e-5 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("S,hq,hkv,d,causal,window", [
    (1, 4, 4, 64, True, None), (65, 8, 2, 64, True, None),
    (130, 4, 1, 128, False, None), (200, 8, 8, 32, True, 17),
    (64, 32, 8, 128, True, 64),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel(cuda, S, hq, hkv, d, causal, window, dtype):
    from ray_lightning_tpu_torch.ops.attention import flash_attention, flash_attention_plain

    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(2, hq, S, d, generator=g, device=cuda).to(dtype)
    k = torch.randn(2, hkv, S, d, generator=g, device=cuda).to(dtype)
    v = torch.randn(2, hkv, S, d, generator=g, device=cuda).to(dtype)
    o, lse = flash_attention(q, k, v, causal=causal, window=window)
    po, plse = flash_attention_plain(q, k, v, causal, None,
                                     window if window and window < S else None)
    _close(o, po, 1e-4 if dtype == torch.float32 else 2e-2)
    _close(lse, plse, 1e-4)


@pytest.mark.parametrize("group,bs", [(1, 8), (4, 16), (8, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_kernel(cuda, group, bs, dtype):
    from ray_lightning_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
        paged_decode_attention_plain,
    )

    B, hkv, hd, maxb = 5, 2, 64, 6
    n = B * maxb + 1
    g = torch.Generator(device=cuda).manual_seed(2)
    kc = torch.randn(n, hkv, bs, hd, generator=g, device=cuda).to(dtype)
    vc = torch.randn(n, hkv, bs, hd, generator=g, device=cuda).to(dtype)
    q = torch.randn(B, hkv, group, hd, generator=g, device=cuda)
    rng = np.random.default_rng(2)
    tables = rng.permutation(np.arange(1, n))[: B * maxb].reshape(B, maxb)
    tables = tables.astype(np.int32)
    tables[4] = 0  # free slot on a trash row
    pos = np.asarray([0, bs - 1, bs, maxb * bs - 1, 0], np.int32)
    t_tab, t_pos = torch.from_numpy(tables).to(cuda), torch.from_numpy(pos).to(cuda)
    got = paged_decode_attention(q, kc, vc, t_tab, t_pos)
    _close(got, paged_decode_attention_plain(q, kc, vc, t_tab, t_pos), 1e-4)


@pytest.mark.parametrize("V", [1, 1000, 32000, 128256])
def test_argmax_kernel(cuda, V):
    from ray_lightning_tpu_torch.ops.paged_attention import (
        blockwise_argmax,
        blockwise_argmax_plain,
        gumbel_noise,
    )

    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(6, V, generator=g, device=cuda)
    x[1] = float("-inf")  # all -inf: index 0, as torch.argmax
    if V > 10:
        x[2, [3, V - 2]] = 100.0  # tie: the first wins
    noise = gumbel_noise(x.shape, g, cuda)
    for nz in (None, noise):
        assert torch.equal(blockwise_argmax(x, nz), blockwise_argmax_plain(x, nz))


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    from ray_lightning_tpu_torch.ops.attention import flash_attention
    from ray_lightning_tpu_torch.ops.rmsnorm import rmsnorm

    x = torch.zeros(4, 8, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        rmsnorm(x, torch.zeros(8, device=cuda, dtype=torch.float16))
    q = torch.zeros(1, 2, 16, 256, device=cuda)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
    with pytest.raises(ValueError):
        rmsnorm(torch.zeros(8, 4, device=cuda).t(), torch.zeros(8, device=cuda))


def test_engine_on_card_matches_engine_on_cpu(cuda):
    from ray_lightning_tpu_torch import kernels
    from ray_lightning_tpu_torch.models.llama import LlamaConfig, init_params
    from ray_lightning_tpu_torch.serving import EngineConfig, InferenceEngine

    cfg = dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32)
    cpu_params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ecfg = EngineConfig(num_slots=2, max_prompt_len=12, max_len=32, block_size=4)
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6, 7], [3, 1, 4, 1, 5, 9, 2, 6, 8, 8], [11, 12]]
    streams = []
    for device, params in (("cpu", cpu_params),
                           (cuda, {k: (v.to(cuda) if torch.is_tensor(v) else
                                       {n: t.to(cuda) for n, t in v.items()})
                                   for k, v in cpu_params.items()})):
        kernels.reset_launch_counts()
        engine = InferenceEngine(params, cfg, ecfg, device=device)
        comps = [engine.submit(p, max_new_tokens=6) for p in prompts]
        engine.run_until_idle()
        streams.append([c.tokens for c in comps])
        counts = kernels.launch_counts().values()
        if device == "cpu":
            assert set(counts) == {0}  # CPU tensors take the plain versions
        else:
            assert 0 not in counts  # every kernel ran on the card
    assert streams[0] == streams[1]
