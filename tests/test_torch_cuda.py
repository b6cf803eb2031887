"""The port's CUDA kernels against their plain versions, on the card.

These need a CUDA device (and nvcc) and skip without one. The machine with
the card has no JAX, and tests/conftest.py imports it, so run them there
without the conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

Shapes are small and deliberately odd (ragged tiles and lengths one off a
tile edge, head dims from 8 to 256, groups of 1 to 16, windows across a
tile edge, block sizes 8 and 32, positions on page and chunk edges,
unaligned inputs, a vocabulary that is no power of two),
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
@pytest.mark.parametrize("shape", [
    (1, 64), (3, 5, 96), (17, 4096),
    # dims that are no multiple of 8 (the scalar path), the vector path's
    # one-warp, two-warp and four-warp rows, and the training shape
    (9, 1000), (9, 2050), (9, 2048), (9, 5120), (9, 8192), (16384, 2048),
])
def test_rmsnorm_kernel(cuda, dtype, shape):
    from ray_lightning_tpu_torch.ops.rmsnorm import RMSNORM_KERNEL, rmsnorm, rmsnorm_plain

    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    w = torch.randn(shape[-1], generator=g, device=cuda).to(dtype)
    before = RMSNORM_KERNEL.launches
    got = rmsnorm(x, w, 1e-5)
    assert RMSNORM_KERNEL.launches == before + 1
    _close(got, rmsnorm_plain(x, w, 1e-5), 1e-5 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_on_unaligned_input(cuda, dtype):
    """x sliced from a larger buffer one element in: its data pointer is no
    longer 16-byte aligned, so the launch takes the scalar path."""
    from ray_lightning_tpu_torch.ops.rmsnorm import rmsnorm, rmsnorm_plain

    rows, dim = 33, 2048
    g = torch.Generator(device=cuda).manual_seed(4)
    buf = torch.randn(rows * dim + 1, generator=g, device=cuda).to(dtype)
    x = buf[1:].view(rows, dim)
    assert x.data_ptr() % 16 != 0
    w = torch.randn(dim, generator=g, device=cuda).to(dtype)
    _close(rmsnorm(x, w, 1e-5), rmsnorm_plain(x, w, 1e-5),
           1e-5 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 4096), (16384, 2048), (9, 1000), (9, 8192)])
def test_rmsnorm_kernel_is_deterministic(cuda, dtype, shape):
    """The reduction order is fixed, so two launches agree bitwise."""
    from ray_lightning_tpu_torch.ops.rmsnorm import rmsnorm

    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    w = torch.randn(shape[-1], generator=g, device=cuda).to(dtype)
    assert torch.equal(rmsnorm(x, w, 1e-5), rmsnorm(x, w, 1e-5))


def _flash_inputs(cuda, B, hq, hkv, S, d, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(B, hq, S, d, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, hkv, S, d, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, hkv, S, d, generator=g, device=cuda).to(dtype)
    return q, k, v


@pytest.mark.parametrize("S,hq,hkv,d,causal,window", [
    (1, 4, 4, 64, True, None), (65, 8, 2, 64, True, None),
    (130, 4, 1, 128, False, None), (200, 8, 8, 32, True, 17),
    (64, 32, 8, 128, True, 64),
    # the bf16 kernel's 64-key tiles and 128-row blocks: one short of an
    # edge, exact, one over
    (63, 4, 2, 128, True, None), (64, 4, 2, 128, True, None),
    (65, 4, 2, 128, True, None), (127, 4, 2, 128, True, None),
    (128, 4, 2, 128, True, None), (129, 4, 2, 128, True, None),
    (255, 4, 2, 128, True, None), (256, 4, 2, 128, True, None),
    (257, 4, 2, 128, True, None),
    # head dims zero-padded to the 64- or 128-column panels; 36 and 17 are
    # no multiple of 8, so they load and store element by element
    (150, 4, 2, 17, True, None), (150, 4, 2, 36, True, None),
    (200, 4, 2, 80, True, None), (200, 4, 4, 96, False, None),
    # group 4 at Llama-3-8B's 32 / 8 heads
    (256, 32, 8, 128, True, None),
    # windows whose edges fall inside a tile
    (300, 4, 2, 128, True, 70), (129, 8, 2, 96, True, 65),
    # non-causal, ragged
    (65, 4, 2, 128, False, None), (257, 8, 2, 64, False, None),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel(cuda, S, hq, hkv, d, causal, window, dtype):
    """The forward kernel against flash_attention_plain: 1e-4 on O in fp32
    (sums in another order), 2e-2 in bf16 (P and O rounded to bf16), 1e-4
    on lse (fp32 on both sides). One launch per call."""
    from ray_lightning_tpu_torch.ops.attention import (
        FLASH_FWD_KERNEL,
        flash_attention,
        flash_attention_plain,
    )

    q, k, v = _flash_inputs(cuda, 2, hq, hkv, S, d, dtype, 1)
    before = FLASH_FWD_KERNEL.launches
    o, lse = flash_attention(q, k, v, causal=causal, window=window)
    assert FLASH_FWD_KERNEL.launches == before + 1
    po, plse = flash_attention_plain(q, k, v, causal, None,
                                     window if window and window < S else None)
    assert o.dtype == dtype and lse.shape == (2, hq, S, 1)
    _close(o, po, 1e-4 if dtype == torch.float32 else 2e-2)
    _close(lse, plse, 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_is_deterministic(cuda, dtype):
    """Every output element of the forward kernel has one writer, so two
    launches on the same inputs give bitwise-equal O and lse."""
    from ray_lightning_tpu_torch.ops.attention import flash_attention

    q, k, v = _flash_inputs(cuda, 2, 8, 2, 300, 128, dtype, 7)
    first = flash_attention(q, k, v, causal=True)
    second = flash_attention(q, k, v, causal=True)
    for name, a, b in zip(("o", "lse"), first, second):
        assert torch.equal(a, b), name


def _paged_inputs(cuda, B, hkv, group, hd, bs, maxb, dtype, pos, seed,
                  offset=0):
    """Caches of B * maxb + 1 blocks (block 0 is trash), tables drawn from
    a permutation of the rest, trash-padded past each row's pos // bs; a row
    whose pos is None is a free slot: an all-trash table row at pos 0.
    ``offset`` elements shift the caches' data pointers."""
    n = B * maxb + 1
    g = torch.Generator(device=cuda).manual_seed(seed)
    numel = n * hkv * bs * hd
    kc, vc = (torch.randn(numel + offset, generator=g, device=cuda).to(dtype)
              [offset:].view(n, hkv, bs, hd) for _ in range(2))
    q = torch.randn(B, hkv, group, hd, generator=g, device=cuda)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(np.arange(1, n))
    tables = np.zeros((B, maxb), np.int32)
    p = np.zeros(B, np.int32)
    for b, pb in enumerate(pos):
        if pb is not None:
            need = pb // bs + 1
            tables[b, :need] = perm[b * maxb:b * maxb + need]
            p[b] = pb
    return q, kc, vc, torch.from_numpy(tables).to(cuda), torch.from_numpy(p).to(cuda)


def _edge_positions(bs, maxb):
    """pos at 0, a page's edges, the 64-position chunk's edges and the last
    position of the table, and a free slot on a trash row."""
    from ray_lightning_tpu_torch.ops.paged_attention import PAGED_SPLIT

    c = PAGED_SPLIT
    return [0, bs - 1, bs, c - 1, c, c + 1, maxb * bs - 1, None]


@pytest.mark.parametrize("group,hd,bs", [
    *((gr, hd, 16) for gr in (1, 2, 4, 8) for hd in (32, 64, 128, 256)),
    *((gr, hd, bs) for bs in (8, 32) for gr, hd in ((1, 64), (4, 128), (8, 32))),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_kernel(cuda, group, hd, bs, dtype):
    """The kernel against paged_decode_attention_plain at 1e-4 (fp32 sums
    in another order), at every group and head dim it takes, block sizes 8
    to 32, and pos on page, chunk and table edges. One launch per call."""
    from ray_lightning_tpu_torch.ops.paged_attention import (
        PAGED_DECODE_KERNEL,
        paged_decode_attention,
        paged_decode_attention_plain,
    )

    maxb = max(6, 160 // bs)
    q, kc, vc, tab, pos = _paged_inputs(cuda, 8, 2, group, hd, bs, maxb, dtype,
                                        _edge_positions(bs, maxb), 2)
    before = PAGED_DECODE_KERNEL.launches
    got = paged_decode_attention(q, kc, vc, tab, pos)
    assert PAGED_DECODE_KERNEL.launches == before + 1
    _close(got, paged_decode_attention_plain(q, kc, vc, tab, pos), 1e-4)


@pytest.mark.parametrize("group,hd", [(3, 128), (5, 128), (6, 128), (7, 128),
                                      (7, 64), (3, 32), (5, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_kernel_at_odd_groups(cuda, group, hd, dtype):
    """GQA groups the kernel is not instantiated for run padded to the
    next one (Qwen2.5-7B's 7 at hd 128 among them): against the plain
    version at 1e-4, one launch per call, the output at the caller's
    group."""
    from ray_lightning_tpu_torch.ops.paged_attention import (
        PAGED_DECODE_KERNEL,
        paged_decode_attention,
        paged_decode_attention_plain,
    )

    q, kc, vc, tab, pos = _paged_inputs(cuda, 8, 4, group, hd, 16, 10, dtype,
                                        _edge_positions(16, 10), group)
    before = PAGED_DECODE_KERNEL.launches
    got = paged_decode_attention(q, kc, vc, tab, pos)
    assert PAGED_DECODE_KERNEL.launches == before + 1
    assert got.shape == q.shape
    _close(got, paged_decode_attention_plain(q, kc, vc, tab, pos), 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_kernel_at_llama3_8b_decode_layout(cuda, dtype):
    """8 rows x 8 KV heads x G 4, hd 128, bs 16, 64 blocks a row (the
    serving path's max_len 1024), ragged positions and a free slot."""
    from ray_lightning_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
        paged_decode_attention_plain,
    )

    pos = [1000, 777, 512, 300, 128, 63, 16, None]
    q, kc, vc, tab, t_pos = _paged_inputs(cuda, 8, 8, 4, 128, 16, 64, dtype, pos, 3)
    _close(paged_decode_attention(q, kc, vc, tab, t_pos),
           paged_decode_attention_plain(q, kc, vc, tab, t_pos), 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_kernel_on_unaligned_caches(cuda, dtype):
    """Caches whose data pointers are one element off 16-byte alignment
    take the element-by-element loads."""
    from ray_lightning_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
        paged_decode_attention_plain,
    )

    q, kc, vc, tab, pos = _paged_inputs(cuda, 8, 2, 4, 128, 16, 10, dtype,
                                        _edge_positions(16, 10), 4, offset=1)
    assert kc.data_ptr() % 16 != 0
    _close(paged_decode_attention(q, kc, vc, tab, pos),
           paged_decode_attention_plain(q, kc, vc, tab, pos), 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_kernel_is_deterministic(cuda, dtype):
    """The chunks merge in chunk order, whichever block arrives last, so
    two launches agree bitwise."""
    from ray_lightning_tpu_torch.ops.paged_attention import paged_decode_attention

    pos = [1023, 1000, 777, 512, 300, 128, 65, None]
    q, kc, vc, tab, t_pos = _paged_inputs(cuda, 8, 8, 4, 128, 16, 64, dtype, pos, 5)
    first = paged_decode_attention(q, kc, vc, tab, t_pos)
    for _ in range(3):
        assert torch.equal(paged_decode_attention(q, kc, vc, tab, t_pos), first)


def test_paged_decode_kernel_replays_in_a_cuda_graph(cuda):
    """One call captured in a CUDA graph, replayed with new positions
    written in place into its pos tensor, equals eager calls: the grid
    depends on host-known sizes only and the arrival counters reset
    themselves, so nothing needs a memset between replays."""
    from ray_lightning_tpu_torch.ops.paged_attention import paged_decode_attention

    full = [1023] * 8
    q, kc, vc, tab, t_pos = _paged_inputs(cuda, 8, 8, 4, 128, 16, 64,
                                          torch.bfloat16, full, 6)
    paged_decode_attention(q, kc, vc, tab, t_pos)  # loads the library
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_out = paged_decode_attention(q, kc, vc, tab, t_pos)
    for new in ([5, 64, 1023, 0, 300, 777, 63, 1000], [1023, 0, 65, 16, 15, 128, 512, 999]):
        t_pos.copy_(torch.tensor(new, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(static_out, paged_decode_attention(q, kc, vc, tab, t_pos))


@pytest.mark.parametrize("group", [12, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_kernel_above_group_8(cuda, group, dtype):
    """Groups above the largest instantiated one (Llama-3.1-405B's and
    Falcon-40B's 16) run as launches of at most 8 query heads over the same
    caches: against the plain version at 1e-4, one launch per slice."""
    from ray_lightning_tpu_torch.ops.paged_attention import (
        PAGED_DECODE_KERNEL,
        paged_decode_attention,
        paged_decode_attention_plain,
        paged_group_chunks,
    )

    q, kc, vc, tab, pos = _paged_inputs(cuda, 8, 2, group, 128, 16, 10, dtype,
                                        _edge_positions(16, 10), group)
    before = PAGED_DECODE_KERNEL.launches
    got = paged_decode_attention(q, kc, vc, tab, pos)
    assert PAGED_DECODE_KERNEL.launches == before + len(paged_group_chunks(group))
    assert got.shape == q.shape
    _close(got, paged_decode_attention_plain(q, kc, vc, tab, pos), 1e-4)


@pytest.mark.parametrize("group,hd", [(4, 80), (4, 96), (1, 40), (7, 48),
                                      (8, 8), (2, 200), (16, 96)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
def test_paged_decode_kernel_at_other_head_dims(cuda, group, hd, dtype, offset):
    """Head dims between the instantiated ones (Phi-2's 80, Phi-3's 96)
    run on the next instantiated width, the cache read at its own stride:
    against the plain version at 1e-4, on aligned caches (16-byte copies,
    the chunks past hd zero-filled) and caches one element off (element
    loads); one launch per call up to G 8. A width that is no multiple of
    8 refuses naming it."""
    from ray_lightning_tpu_torch.ops.paged_attention import (
        PAGED_DECODE_KERNEL,
        paged_decode_attention,
        paged_decode_attention_plain,
        paged_group_chunks,
    )

    q, kc, vc, tab, pos = _paged_inputs(cuda, 8, 2, group, hd, 16, 10, dtype,
                                        _edge_positions(16, 10), hd,
                                        offset=offset)
    before = PAGED_DECODE_KERNEL.launches
    got = paged_decode_attention(q, kc, vc, tab, pos)
    assert PAGED_DECODE_KERNEL.launches == before + len(paged_group_chunks(group))
    assert got.shape == q.shape
    _close(got, paged_decode_attention_plain(q, kc, vc, tab, pos), 1e-4)
    if offset == 0 and hd == 80:
        bad = _paged_inputs(cuda, 2, 2, group, 36, 16, 4, dtype, [5, 20], 1)
        with pytest.raises(ValueError, match="hd=36"):
            paged_decode_attention(*bad)


def test_paged_decode_kernel_on_two_streams_at_once(cuda):
    """Calls interleaved on two streams, with nothing ordering them, equal
    serial calls bitwise: each stream has its own arrival counters, so the
    chunks of two calls in flight never merge into each other."""
    from ray_lightning_tpu_torch.ops.paged_attention import paged_decode_attention

    pos = [1023, 1000, 777, 512, 300, 128, 65, None]
    inputs = [_paged_inputs(cuda, 8, 8, 4, 128, 16, 64, torch.bfloat16, pos, s)
              for s in (11, 12)]
    want = [paged_decode_attention(*x) for x in inputs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(50):
        for k in (0, 1):
            with torch.cuda.stream(streams[k]):
                outs[k].append(paged_decode_attention(*inputs[k]))
    torch.cuda.synchronize()
    assert not torch.equal(want[0], want[1])
    for k in (0, 1):
        for got in outs[k]:
            assert torch.equal(got, want[k])


def test_paged_decode_kernel_in_cuda_graphs(cuda):
    """Two graphs captured on torch.cuda.graph's default capture stream (one
    stream for every graph), the second replayed first, then both replayed
    many times at once on two streams, equal eager calls bitwise: each
    capture zeroes counters of its own inside its graph, so no replay reads
    counters that another graph left, or shares them with a replay in
    flight. The second graph's group of 12 is two launches on one buffer."""
    from ray_lightning_tpu_torch.ops.paged_attention import paged_decode_attention

    pos = [1023, 1000, 777, 512, 300, 128, 65, None]
    inputs = [_paged_inputs(cuda, 8, 8, g, 128, 16, 64, torch.bfloat16, pos, s)
              for g, s in ((4, 21), (12, 22))]
    want = [paged_decode_attention(*x) for x in inputs]  # loads the kernel
    torch.cuda.synchronize()
    graphs, outs = [], []
    for x in inputs:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs.append(paged_decode_attention(*x))
        graphs.append(graph)
    for out in outs:
        out.zero_()
    graphs[1].replay()
    graphs[0].replay()
    torch.cuda.synchronize()
    for got, w in zip(outs, want):
        assert torch.equal(got, w)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    for _ in range(50):
        for k in (0, 1):
            with torch.cuda.stream(streams[k]):
                graphs[k].replay()
    torch.cuda.synchronize()
    for got, w in zip(outs, want):
        assert torch.equal(got, w)


def _argmax_rows(cuda, B, V, pattern, seed):
    """[B, V] fp32 logits on the card with a planted pattern:
    ``ties``: the row's maximum on both sides of every chunk boundary of the
    kernel's plan (row r keeps the boundaries from its r-th on, so every
    boundary leads some row); ``signed_zeros``: negative logits with -0.0
    before +0.0 (a tie); ``neg_inf``: every row all -inf; ``all_nan``: every
    row all NaN; ``nans``: a NaN at the start of every later chunk, and one
    in the middle of a row, after a larger number; ``unaligned``: the
    ``ties`` rows in a contiguous view 4 bytes past a 16-byte boundary."""
    from ray_lightning_tpu_torch.ops.paged_attention import argmax_plan

    g = torch.Generator(device=cuda).manual_seed(seed)
    if pattern == "unaligned":
        x = torch.randn(B * V + 1, generator=g, device=cuda)[1:].view(B, V)
        assert x.data_ptr() % 16 == 4 and x.is_contiguous()
    else:
        x = torch.randn(B, V, generator=g, device=cuda)
    plan = argmax_plan(B, V, torch.cuda.get_device_properties(cuda).multi_processor_count)
    edges = list(range(plan["chunk"], V, plan["chunk"]))
    top = 100.0
    for r in range(B):
        if pattern in ("ties", "unaligned"):
            cols = [c for e in edges[r % max(len(edges), 1):] for c in (e - 1, e)]
            x[r, cols or [V - 1]] = top
            if V > 2:
                x[r, V - 1] = top  # a tie at the row's end too
        elif pattern == "signed_zeros":
            x[r] = -x[r].abs() - 1.0
            if V > 1:
                first = (r * 7919) % (V - 1)
                x[r, first] = -0.0
                x[r, V - 1 - (r % max(V - 1 - first, 1))] = 0.0
        elif pattern == "nans":
            x[r, V // 3] = top
            for e in edges[r % max(len(edges), 1):]:
                x[r, e] = float("nan")
            x[r, min(V // 2 + r, V - 1)] = float("nan")
    if pattern == "neg_inf":
        x.fill_(float("-inf"))
    elif pattern == "all_nan":
        x.fill_(float("nan"))
    return x


@pytest.mark.parametrize("pattern", ["ties", "signed_zeros", "neg_inf",
                                     "all_nan", "nans", "unaligned"])
@pytest.mark.parametrize("noisy", [False, True], ids=["greedy", "noisy"])
@pytest.mark.parametrize("V", [1, 3, 1000, 32000, 50257, 128256])
@pytest.mark.parametrize("B", [1, 3, 8, 64])
def test_argmax_kernel(cuda, B, V, noisy, pattern):
    """Bitwise against the plain version (torch.argmax): first maximum on
    ties across chunk boundaries, +0.0 and -0.0 tied, 0 for all -inf, the
    first NaN, at the batch sizes where the plan splits a row 8, 8, 8 and
    4 ways, on the vector and the element paths."""
    from ray_lightning_tpu_torch import kernels
    from ray_lightning_tpu_torch.ops.paged_attention import (
        blockwise_argmax,
        blockwise_argmax_plain,
        gumbel_noise,
    )

    x = _argmax_rows(cuda, B, V, pattern, seed=B * 1000 + V)
    noise = None
    if noisy:
        noise = gumbel_noise(x.shape, torch.Generator(device=cuda).manual_seed(V), cuda)
        if pattern == "signed_zeros":
            noise[x == 0] = 0.0  # keep the tie: -0.0 + 0.0 and 0.0 + 0.0
    before = kernels.launch_counts()["argmax"]
    got = blockwise_argmax(x, noise)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["argmax"] == before + 1
    want = blockwise_argmax_plain(x, noise)
    assert got.dtype == torch.int32 and got.shape == (B,)
    assert torch.equal(got, want), (got.tolist(), want.tolist())
    if pattern in ("neg_inf", "all_nan"):
        assert not got.any()


@pytest.mark.parametrize("pattern", ["ties", "nans", "unaligned"])
@pytest.mark.parametrize("B,V", [(32, 128256), (8, 152064)],
                         ids=["verify_llama3", "qwen2.5"])
def test_argmax_kernel_at_the_speculative_and_qwen_shapes(cuda, B, V, pattern):
    """A verify step's [S * K, V] = [32, 128256] and Qwen2.5's vocabulary
    152064 (no multiple of the plan's chunk): bitwise torch.argmax."""
    from ray_lightning_tpu_torch.ops.paged_attention import blockwise_argmax

    x = _argmax_rows(cuda, B, V, pattern, seed=B + V)
    assert torch.equal(blockwise_argmax(x), torch.argmax(x, dim=-1).to(torch.int32))


def test_argmax_kernel_replays_in_a_cuda_graph(cuda):
    """A captured call, replayed on new logits written in place, equals
    eager calls: the cluster merge keeps no state between calls."""
    from ray_lightning_tpu_torch.ops.paged_attention import (
        blockwise_argmax,
        gumbel_noise,
    )

    x = _argmax_rows(cuda, 8, 128256, "ties", seed=1)
    noise = gumbel_noise(x.shape, torch.Generator(device=cuda).manual_seed(2), cuda)
    blockwise_argmax(x, noise)  # loads the library
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        greedy = blockwise_argmax(x)
        noisy = blockwise_argmax(x, noise)
    for seed, pattern in ((3, "nans"), (4, "ties"), (5, "all_nan")):
        x.copy_(_argmax_rows(cuda, 8, 128256, pattern, seed=seed))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(greedy, blockwise_argmax(x))
        assert torch.equal(noisy, blockwise_argmax(x, noise))


def test_argmax_kernel_is_deterministic(cuda):
    from ray_lightning_tpu_torch.ops.paged_attention import blockwise_argmax

    x = _argmax_rows(cuda, 8, 128256, "ties", seed=7)
    x[2, 9] = float("nan")
    first = blockwise_argmax(x)
    for _ in range(10):
        assert torch.equal(blockwise_argmax(x), first)


def test_argmax_kernel_on_two_streams_at_once(cuda):
    """Calls interleaved on two streams, with nothing ordering them, equal
    serial calls: nothing is shared between calls."""
    from ray_lightning_tpu_torch.ops.paged_attention import blockwise_argmax

    xs = [_argmax_rows(cuda, 8, 128256, p, seed=s)
          for p, s in (("ties", 8), ("nans", 9))]
    xs[0][:, 5000] = 1e3  # the two inputs answer differently
    want = [blockwise_argmax(x) for x in xs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(50):
        for k in (0, 1):
            with torch.cuda.stream(streams[k]):
                outs[k].append(blockwise_argmax(xs[k]))
    torch.cuda.synchronize()
    assert not torch.equal(want[0], want[1])
    for k in (0, 1):
        for got in outs[k]:
            assert torch.equal(got, want[k])


def test_argmax_kernel_takes_more_rows_than_a_grid_column(cuda):
    """Rows and chunks share the grid's x dimension, so a batch past 65535
    rows launches (one chunk a row there)."""
    from ray_lightning_tpu_torch.ops.paged_attention import (
        blockwise_argmax,
        blockwise_argmax_plain,
    )

    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn(70000, 37, generator=g, device=cuda)
    x[::7, 5] = float("nan")
    assert torch.equal(blockwise_argmax(x), blockwise_argmax_plain(x))


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
    from ray_lightning_tpu_torch.ops.paged_attention import blockwise_argmax

    with pytest.raises(ValueError):  # an empty vocabulary has no argmax
        blockwise_argmax(torch.zeros(2, 0, device=cuda))


def _rel(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / (want.abs().max() + 1e-12))


def _bwd_inputs(cuda, B, hq, hkv, S, d, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(B, hq, S, d, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, hkv, S, d, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, hkv, S, d, generator=g, device=cuda).to(dtype)
    do = torch.randn(B, hq, S, d, generator=g, device=cuda).to(dtype)
    return q, k, v, do


@pytest.mark.parametrize("B,hq,hkv,S,d,causal,window", [
    (1, 4, 4, 77, 64, True, None), (2, 8, 1, 77, 64, True, None),
    (1, 8, 8, 300, 128, True, None), (2, 8, 1, 300, 64, False, None),
    (1, 8, 2, 300, 128, True, 100), (1, 4, 4, 300, 64, True, 17),
    (1, 2, 2, 17, 32, True, None),
    # the 64-row tiles' edges: one row short of a tile, exact, one over
    (1, 4, 2, 63, 128, True, None), (1, 4, 2, 64, 128, True, None),
    (1, 4, 2, 65, 128, True, None), (1, 4, 2, 127, 128, False, None),
    (1, 4, 2, 128, 128, True, None), (1, 4, 2, 129, 128, True, None),
    # head dims zero-padded to the 128-column panels; 36 and 17 are no
    # multiple of 8, so their tiles load element by element (17: odd stores)
    (1, 4, 2, 200, 80, True, None), (2, 4, 4, 150, 96, False, None),
    (1, 4, 2, 100, 36, True, None), (1, 2, 1, 70, 17, True, None),
    # group 4 at Llama-3-8B's 32 / 8 heads
    (1, 32, 8, 256, 128, True, None),
    # windows whose edges fall inside a tile
    (1, 4, 2, 300, 128, True, 70), (1, 8, 2, 129, 96, True, 65),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_kernels(cuda, B, hq, hkv, S, d, causal, window, dtype):
    """dQ and dK/dV kernels against flash_attention_bwd_plain on the same
    O and lse. fp32: 1e-4 relative to each gradient's max (sums in another
    order). bf16: both sides round P and dS to bf16 before the products,
    but from fp32 scores summed in another order, so a rounding can fall
    the other way; 2^-7 of the max (two bf16 ulps) bounds that."""
    from ray_lightning_tpu_torch.ops.attention import (
        FLASH_BWD_DKV_KERNEL,
        FLASH_BWD_DQ_KERNEL,
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_plain,
    )

    q, k, v, do = _bwd_inputs(cuda, B, hq, hkv, S, d, dtype, 4)
    o, lse = flash_attention(q, k, v, causal=causal, window=window)
    before = (FLASH_BWD_DQ_KERNEL.launches, FLASH_BWD_DKV_KERNEL.launches)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal, None, window)
    assert (FLASH_BWD_DQ_KERNEL.launches, FLASH_BWD_DKV_KERNEL.launches) == (
        before[0] + 1, before[1] + 1)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal, None,
                                     window if window and window < S else None)
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == dtype
        assert b.float().abs().max() > 0, name
        assert _rel(a, b) <= tol, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_kernels_are_deterministic(cuda, dtype):
    """Every output element of the backward kernels has one writer (no
    atomics), so two launches on the same inputs give bitwise-equal dQ, dK
    and dV."""
    from ray_lightning_tpu_torch.ops.attention import (
        flash_attention,
        flash_attention_bwd,
    )

    q, k, v, do = _bwd_inputs(cuda, 2, 8, 2, 300, 128, dtype, 6)
    o, lse = flash_attention(q, k, v, causal=True)
    first = flash_attention_bwd(q, k, v, o, lse, do, True)
    second = flash_attention_bwd(q, k, v, o, lse, do, True)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


def test_raw_kernel_wrappers_refuse_inputs_that_require_grad(cuda):
    """The kernels write through raw pointers, invisible to autograd: with
    grad mode on, the raw wrappers refuse inputs that require grad, while
    the differentiable entries (attention, rmsnorm) go through their
    autograd Functions and the raw wrappers work under no_grad."""
    from ray_lightning_tpu_torch.ops.attention import (
        flash_attention,
        flash_attention_bwd,
    )
    from ray_lightning_tpu_torch.ops.rmsnorm import rmsnorm, rmsnorm_fwd

    q = torch.randn(1, 2, 16, 32, device=cuda, requires_grad=True)
    x = torch.randn(4, 32, device=cuda, requires_grad=True)
    w = torch.ones(32, device=cuda)
    with pytest.raises(RuntimeError, match="autograd"):
        flash_attention(q, q, q)
    with pytest.raises(RuntimeError, match="autograd"):
        rmsnorm_fwd(x, w)
    with torch.no_grad():
        o, lse = flash_attention(q, q, q)
        rmsnorm_fwd(x, w)
    with pytest.raises(RuntimeError, match="autograd"):
        flash_attention_bwd(q, q, q, o, lse, torch.ones_like(o))
    assert rmsnorm(x, w).requires_grad
    from ray_lightning_tpu_torch.ops.attention import attention
    assert attention(q, q, q).requires_grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_differentiable_ops_on_card_match_plain_autograd(cuda, dtype):
    """attention() and rmsnorm() on the card (kernel forward, kernel or
    reference-formula backward) give the gradients of autograd over their
    plain versions: 1e-4 relative in fp32, 2^-7 in bf16 (roundings of P,
    dS and the bf16 outputs)."""
    from ray_lightning_tpu_torch.ops.attention import attention, reference_attention
    from ray_lightning_tpu_torch.ops.rmsnorm import rmsnorm, rmsnorm_plain

    g = torch.Generator(device=cuda).manual_seed(5)
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    base = [torch.randn(2, h, 100, 64, generator=g, device=cuda).to(dtype)
            for h in (8, 2, 2)]
    do = torch.randn(2, 8, 100, 64, generator=g, device=cuda).to(dtype)
    grads = []
    for fn in (attention, reference_attention):
        leaves = [t.clone().requires_grad_() for t in base]
        torch.autograd.backward(fn(*leaves, causal=True), do)
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert _rel(a, b) <= tol
    x = torch.randn(3, 50, 256, generator=g, device=cuda).to(dtype)
    w = (1 + 0.1 * torch.randn(256, generator=g, device=cuda)).to(dtype)
    dy = torch.randn(3, 50, 256, generator=g, device=cuda).to(dtype)
    grads = []
    for fn in (rmsnorm, rmsnorm_plain):
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        torch.autograd.backward(fn(xr, wr, 1e-5), dy)
        grads.append((xr.grad, wr.grad))
    for a, b in zip(*grads):
        assert _rel(a, b) <= tol


def test_training_on_card_matches_plain(cuda):
    """lm_loss and every gradient of a 2-layer fp32 model with remat and the
    chunked loss: the kernel path against plain=True on the card, 1e-4
    relative to each leaf's max; then a Trainer fit on the card launches
    every training kernel."""
    from ray_lightning_tpu_torch import kernels
    from ray_lightning_tpu_torch.core import Trainer
    from ray_lightning_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaModule,
        SyntheticLMDataModule,
        init_params,
        lm_loss,
    )
    from ray_lightning_tpu_torch.utils.tree import tree_leaves

    cfg = dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32,
                              remat=True, loss_chunks=4)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 128), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    results = []
    for plain in (False, True):
        leaves = list(tree_leaves(params))
        for t in leaves:
            t.grad = None
            t.requires_grad_(True)
        loss, _ = lm_loss(params, tokens, cfg, plain=plain)
        loss.backward()
        results.append((loss.detach(), [t.grad.clone() for t in leaves]))
    assert abs(float(results[0][0]) - float(results[1][0])) <= 1e-4 * float(
        results[1][0])
    for a, b in zip(results[0][1], results[1][1]):
        assert _rel(a, b) <= 1e-4

    kernels.reset_launch_counts()
    module = LlamaModule(cfg, lr=1e-3, warmup_steps=1, total_steps=4)
    trainer = Trainer(device=cuda, max_steps=3, logger=False,
                      enable_checkpointing=False, seed=0)
    trainer.fit(module, datamodule=SyntheticLMDataModule(cfg, batch_size=2,
                                                         n_train=8, n_val=2))
    counts = kernels.launch_counts()
    for name in ("rmsnorm", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert counts[name] > 0, name
    assert np.isfinite(float(trainer.callback_metrics["val_loss"]))


def test_engine_on_card_matches_engine_on_cpu(cuda):
    from ray_lightning_tpu_torch import kernels
    from ray_lightning_tpu_torch.models.llama import LlamaConfig, init_params
    from ray_lightning_tpu_torch.serving import EngineConfig, InferenceEngine

    cfg = dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32)
    cpu_params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ecfg = EngineConfig(num_slots=2, max_prompt_len=12, max_len=32, block_size=4,
                        kv_layout="paged")
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
        counts = kernels.launch_counts()
        if device == "cpu":
            # CPU tensors take the plain versions
            assert set(counts.values()) == {0}
        else:
            # every serving kernel ran on the card; the backward kernels
            # belong to training
            assert all(counts[n] > 0 for n in
                       ("rmsnorm", "flash_fwd", "paged_decode", "argmax"))
            assert counts["flash_bwd_dq"] == counts["flash_bwd_dkv"] == 0
    assert streams[0] == streams[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_ffn_lossless_on_card_matches_cpu(cuda, dtype):
    """The lossless MoE (cuBLAS expert products, fp32 sum in expert order)
    on the card against the same call on the CPU, at ragged token counts."""
    from ray_lightning_tpu_torch.parallel.moe import init_moe_params, moe_ffn_lossless

    params = init_moe_params(torch.Generator().manual_seed(0), 64, 96, 4,
                             dtype=dtype, device="cpu")
    x = torch.randn((3, 5, 64), generator=torch.Generator().manual_seed(1)).to(dtype)
    want = moe_ffn_lossless(params, x, top_k=2)
    got = moe_ffn_lossless({k: v.to(cuda) for k, v in params.items()},
                           x.to(cuda), top_k=2)
    assert got.dtype == dtype and got.device.type == "cuda"
    _close(got.cpu(), want, 1e-5 if dtype == torch.float32 else 2e-2)


def test_moe_engine_on_card_matches_engine_on_cpu(cuda):
    """tiny_moe (fp32) served on the card and on the CPU: the same greedy
    tokens, and on the card the serving kernels launch as the layer count
    says."""
    from ray_lightning_tpu_torch import kernels
    from ray_lightning_tpu_torch.models.llama import LlamaConfig, init_params
    from ray_lightning_tpu_torch.serving import EngineConfig, InferenceEngine
    from ray_lightning_tpu_torch.utils.tree import tree_map

    cfg = dataclasses.replace(LlamaConfig.tiny_moe(), dtype=torch.float32)
    cpu_params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ecfg = EngineConfig(num_slots=2, max_prompt_len=12, max_len=32, block_size=4,
                        kv_layout="paged")
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6, 7], [3, 1, 4, 1, 5, 9, 2, 6, 8, 8], [11, 12]]
    streams = []
    for device, params in (("cpu", cpu_params),
                           (cuda, tree_map(lambda t: t.to(cuda), cpu_params))):
        kernels.reset_launch_counts()
        engine = InferenceEngine(params, cfg, ecfg, device=device)
        comps = [engine.submit(p, max_new_tokens=6) for p in prompts]
        engine.run_until_idle()
        streams.append([c.tokens for c in comps])
        counts = kernels.launch_counts()
        if device == "cpu":
            assert set(counts.values()) == {0}
        else:
            L, steps = cfg.n_layers, engine.stats["decode_steps"]
            assert counts["flash_fwd"] == L * engine.stats["prefills"]
            assert counts["paged_decode"] == L * steps
            assert counts["argmax"] == steps
    assert streams[0] == streams[1]


def test_slot_engine_and_generate_on_card_match_cpu(cuda):
    """The slot engine (dense rows, plain-torch attention, the argmax
    kernel) and ``generate`` on a windowed config past its window (a
    rolling cache), fp32, on the card and on the CPU: the same greedy
    tokens; on the card no paged decode launches."""
    from ray_lightning_tpu_torch import kernels
    from ray_lightning_tpu_torch.models.generation import generate
    from ray_lightning_tpu_torch.models.llama import LlamaConfig, init_params
    from ray_lightning_tpu_torch.serving import EngineConfig, InferenceEngine
    from ray_lightning_tpu_torch.utils.tree import tree_map

    cfg = dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32)
    windowed = dataclasses.replace(cfg, sliding_window=8)
    cpu_params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ecfg = EngineConfig(num_slots=2, max_prompt_len=12, max_len=32)
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6, 7], [3, 1, 4, 1, 5, 9, 2, 6, 8, 8], [11, 12]]
    window_prompt = torch.tensor([[5, 3, 9, 1, 4, 4, 7, 2, 8, 6, 1, 3]])
    streams = []
    for device, params in (("cpu", cpu_params),
                           (cuda, tree_map(lambda t: t.to(cuda), cpu_params))):
        kernels.reset_launch_counts()
        engine = InferenceEngine(params, cfg, ecfg, device=device)
        comps = [engine.submit(p, max_new_tokens=6) for p in prompts]
        engine.run_until_idle()
        out = generate(params, window_prompt, windowed, 10, device=device)
        streams.append(([c.tokens for c in comps], out.tolist()))
        counts = kernels.launch_counts()
        if device == "cpu":
            assert set(counts.values()) == {0}
        else:
            steps = engine.stats["decode_steps"]
            assert counts["paged_decode"] == 0
            assert counts["argmax"] == steps
            # the engine's prefills and the one of generate
            assert counts["flash_fwd"] == cfg.n_layers * (
                engine.stats["prefills"] + 1)
    assert streams[0] == streams[1]


def _tiny_remat_cfg(**over):
    from ray_lightning_tpu_torch.models.llama import LlamaConfig

    return dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32,
                               remat=True, loss_chunks=4, **over)


def _loss_and_grads(params, tokens, cfg, mixed=False, plain=False):
    from ray_lightning_tpu_torch.models.llama import lm_loss
    from ray_lightning_tpu_torch.utils.precision import cast_floats
    from ray_lightning_tpu_torch.utils.tree import tree_leaves

    leaves = list(tree_leaves(params))
    for t in leaves:
        t.grad = None
        t.requires_grad_(True)
    view = cast_floats(params, torch.bfloat16) if mixed else params
    loss, _ = lm_loss(view, tokens, cfg, plain=plain)
    loss.backward()
    return loss.detach(), [t.grad.clone() for t in leaves]


def test_remat_dots_on_card_equals_nothing(cuda):
    """remat "dots" and "nothing" run the same kernels on the same inputs
    (dots keeps the cuBLAS projections, nothing reruns them): the loss and
    every gradient are bitwise equal, fp32 and bf16, with the same launch
    counts."""
    from ray_lightning_tpu_torch import kernels
    from ray_lightning_tpu_torch.models.llama import init_params
    from ray_lightning_tpu_torch.utils.tree import tree_map

    for dtype in (torch.float32, torch.bfloat16):
        params = tree_map(lambda t: t.to(dtype), init_params(
            _tiny_remat_cfg(), torch.Generator(device=cuda).manual_seed(0)))
        tokens = torch.randint(0, 512, (2, 128), device=cuda,
                               generator=torch.Generator(device=cuda).manual_seed(1))
        out, counts = {}, {}
        for policy in ("nothing", "dots"):
            kernels.reset_launch_counts()
            out[policy] = _loss_and_grads(params, tokens,
                                          _tiny_remat_cfg(remat_policy=policy))
            counts[policy] = kernels.launch_counts()
        assert counts["dots"] == counts["nothing"]
        assert counts["dots"]["flash_fwd"] == 2 * 2  # forward + recompute
        assert torch.equal(out["dots"][0], out["nothing"][0])
        for a, b in zip(out["dots"][1], out["nothing"][1]):
            assert torch.equal(a, b)


def test_bf16_mixed_kernels_match_plain_on_card(cuda):
    """A bf16 view of fp32 masters through the kernels and through the
    plain versions, the gradients on the masters: both in fp32, the loss
    within 2^-7 relative, and each gradient leaf's error against an fp32
    run of the plain versions no more than twice the plain bf16 path's
    own (the kernels round no worse than the reference does)."""
    from ray_lightning_tpu_torch.models.llama import init_params

    cfg = _tiny_remat_cfg(remat_policy="dots")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(2))
    tokens = torch.randint(0, 512, (2, 128), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(3))
    lk, gk = _loss_and_grads(params, tokens, cfg, mixed=True)
    lp, gp = _loss_and_grads(params, tokens, cfg, mixed=True, plain=True)
    _, g32 = _loss_and_grads(params, tokens, cfg, plain=True)
    assert all(g.dtype == torch.float32 for g in gk)
    assert abs(float(lk) - float(lp)) <= 2.0 ** -7 * abs(float(lp))
    for a, b, ref in zip(gk, gp, g32):
        assert _rel(a, ref) <= 2 * _rel(b, ref) + 1e-6


def test_side_stream_prefetcher_gives_the_synchronous_batches(cuda):
    """The side-stream lookahead (pinned memory, an event per batch,
    record_stream) yields the batches the synchronous copy gives, and a
    Trainer fit through it gives the synchronous fit's losses bitwise."""
    from ray_lightning_tpu_torch.callbacks import Callback
    from ray_lightning_tpu_torch.core import Trainer
    from ray_lightning_tpu_torch.core.prefetch import DevicePrefetcher
    from ray_lightning_tpu_torch.models.llama import (
        LlamaModule,
        SyntheticLMDataModule,
    )
    from ray_lightning_tpu_torch.strategies import SingleDeviceStrategy

    trainer = Trainer(device=cuda, logger=False, enable_checkpointing=False)
    rng = np.random.default_rng(4)
    src = [{"x": rng.standard_normal((64, 256)).astype(np.float32),
            "ids": rng.integers(0, 9, (64,))} for _ in range(12)]
    side = torch.cuda.Stream()
    got = [(i, d) for i, _, d in DevicePrefetcher(
        trainer._to_device, depth=3, stream=side).iterate(src)]
    for (i, d), host in zip(got, src):
        assert torch.equal(d["x"].cpu(), torch.from_numpy(host["x"]))
        assert torch.equal(d["ids"].cpu(), torch.from_numpy(host["ids"]))
    assert [i for i, _ in got] == list(range(12))

    cfg = _tiny_remat_cfg()
    losses = {}
    for key, strategy in (("sync", SingleDeviceStrategy(0, 0)),
                          ("side", SingleDeviceStrategy(3, 2))):
        rows = []

        class Keep(Callback):
            def on_train_batch_end(self, trainer, module, outputs, batch, i):
                rows.append(outputs["loss"])

        Trainer(device=cuda, strategy=strategy, max_steps=6, logger=False,
                enable_checkpointing=False, seed=0, callbacks=[Keep()]).fit(
            LlamaModule(cfg, lr=1e-3, warmup_steps=1, total_steps=6),
            datamodule=SyntheticLMDataModule(cfg, batch_size=2, n_train=16))
        losses[key] = torch.stack(rows).cpu()
    assert torch.equal(losses["side"], losses["sync"])


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_verify_step_on_card_matches_cpu(cuda, layout):
    """One ``decode_step_verify`` of a tiny fp32 config on the card against
    the same step on the CPU (1e-4: fp32 products summed in another
    order), then the speculative engine's greedy streams on both: equal,
    with RMSNorm 2L + 1 and argmax once a verify step on the card, and no
    paged decode (verify attends in plain torch)."""
    from ray_lightning_tpu_torch import kernels
    from ray_lightning_tpu_torch.models.generation import decode_step_verify
    from ray_lightning_tpu_torch.models.llama import LlamaConfig, init_params
    from ray_lightning_tpu_torch.serving import EngineConfig, InferenceEngine
    from ray_lightning_tpu_torch.utils.tree import tree_map

    cfg = dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32)
    cpu_params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card_params = tree_map(lambda t: t.to(cuda), cpu_params)
    rng = np.random.default_rng(1)
    B, K, bs, maxb = 3, 4, 4, 8
    C = bs * maxb
    hkv, hd, L = cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    if layout == "slot":
        shape, tables = (L, B, hkv, C, hd), None
    else:
        shape = (L, B * maxb + 1, hkv, bs, hd)
        tables = torch.from_numpy((1 + rng.permutation(B * maxb)).reshape(
            B, maxb).astype(np.int32))
    cache = {n: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
             for n in ("k", "v")}
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, K)))
    pos = torch.tensor([C - K - 1, 9, 3], dtype=torch.int32)
    want, _ = decode_step_verify(cpu_params, {n: t.clone() for n, t in cache.items()},
                                 tokens, pos, cfg, block_tables=tables)
    got, _ = decode_step_verify(
        card_params, {n: t.to(cuda) for n, t in cache.items()}, tokens.to(cuda),
        pos.to(cuda), cfg, block_tables=None if tables is None else tables.to(cuda))
    _close(got.cpu(), want, 1e-4)

    prompts = [[5, 9, 5, 9, 5, 9, 5], [3, 3, 3, 3], [7, 1, 2, 7, 1, 2]]
    ecfg = EngineConfig(num_slots=2, max_prompt_len=8, max_len=32, block_size=4,
                        kv_layout=layout, speculate_k=4)
    streams = []
    for device, params in (("cpu", cpu_params), (cuda, card_params)):
        kernels.reset_launch_counts()
        engine = InferenceEngine(params, cfg, ecfg, device=device)
        comps = [engine.submit(p, max_new_tokens=10) for p in prompts]
        engine.run_until_idle()
        streams.append([c.tokens for c in comps])
        if device != "cpu":
            counts = kernels.launch_counts()
            steps, prefills = engine.stats["decode_steps"], engine.stats["prefills"]
            assert counts["paged_decode"] == 0
            assert counts["argmax"] == steps
            assert counts["rmsnorm"] == 2 * L * prefills + (2 * L + 1) * steps
            assert engine.stats["accepted_tokens"] > engine.stats["spec_row_ticks"]
    assert streams[0] == streams[1]


def test_moe_training_step_on_card_matches_cpu(cuda):
    """One MoE training step of tiny_moe in fp32 with remat, capacity factor
    1.5 (tokens are dropped) and the auxiliary loss: the loss, the aux loss
    and every gradient (the router's and the experts' included) on the card
    (kernels) equal the CPU's (plain versions), 1e-5 relative on the
    losses and 1e-4 of each leaf's max on the gradients (fp32 sums in other
    orders); the card's step launched the training kernels."""
    from ray_lightning_tpu_torch import kernels
    from ray_lightning_tpu_torch.models.llama import (
        LlamaConfig,
        init_params,
        lm_loss,
    )
    from ray_lightning_tpu_torch.utils.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(LlamaConfig.tiny_moe(), dtype=torch.float32,
                              remat=True, capacity_factor=1.5)
    host = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 64),
                           generator=torch.Generator().manual_seed(4))
    out = {}
    for dev in ("cuda", "cpu"):
        kernels.reset_launch_counts()
        params = tree_map(lambda t: t.detach().to(dev).clone().requires_grad_(),
                          host)
        loss, logs = lm_loss(params, tokens.to(dev), cfg)
        loss.backward()
        out[dev] = (loss.item(), logs["moe_aux"].item(),
                    [t.grad.cpu() for t in tree_leaves(params)],
                    kernels.launch_counts())
    (lk, ak, gk, ck), (lc, ac, gc, cc) = out["cuda"], out["cpu"]
    assert abs(lk - lc) <= 1e-5 * abs(lc)
    assert abs(ak - ac) <= 1e-5 * abs(ac) and ac > 0
    for a, b in zip(gk, gc):
        assert float(b.abs().max()) > 0
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    L = cfg.n_layers
    assert ck["flash_fwd"] == 2 * L and ck["flash_bwd_dq"] == L
    assert ck["rmsnorm"] == 4 * L + 1 and set(cc.values()) == {0}


def test_ray_strategy_on_card_matches_single_device(cuda):
    """RayStrategy(num_workers=1, use_gpu=True): one worker process owns the
    card in an NCCL group of world size 1 and trains a tiny fp32 model for
    3 steps; the weights it sends back equal a SingleDeviceStrategy run of
    the same seed bitwise (the same kernels, deterministic, on the same
    card), and the worker's launch counts equal the single-device run's."""
    from ray_lightning_tpu_torch import kernels
    from ray_lightning_tpu_torch import runtime as rt
    from ray_lightning_tpu_torch.core import Trainer
    from ray_lightning_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaModule,
        SyntheticLMDataModule,
    )
    from ray_lightning_tpu_torch.strategies import RayStrategy
    from ray_lightning_tpu_torch.utils.tree import tree_leaves

    cfg = dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32,
                              max_seq=64)
    runs = {}
    try:
        for name, strategy in (("single", None),
                               ("ray", RayStrategy(num_workers=1, use_gpu=True,
                                                   timeout_s=120))):
            kernels.reset_launch_counts()
            module = LlamaModule(cfg, lr=3e-3, warmup_steps=1, total_steps=3)
            trainer = Trainer(device="cuda", strategy=strategy, max_steps=3,
                              seed=0, logger=False, enable_checkpointing=False)
            trainer.fit(module, datamodule=SyntheticLMDataModule(
                cfg, batch_size=4, n_train=12, n_val=4))
            counts = (trainer.worker_launch_counts if strategy is not None
                      else kernels.launch_counts())
            runs[name] = (list(tree_leaves(module.params)), counts, trainer)
    finally:
        rt.shutdown()
    (single, single_counts, _), (ray, ray_counts, trainer) = (runs["single"],
                                                              runs["ray"])
    assert trainer.strategy.launcher.backend == "nccl"
    assert trainer.global_step == 3 and "val_loss" in trainer.callback_metrics
    assert ray_counts == single_counts and ray_counts["flash_bwd_dkv"] > 0
    for a, b in zip(ray, single):
        assert a.device.type == "cuda" and torch.equal(a, b.detach())


def test_tune_sweep_of_two_trials_sharing_the_card(cuda, tmp_path):
    """``tune.run`` of two trials at once, each claiming half the card
    (``resources_per_trial={"CPU": 1, "GPU": 0.5}``) and training a narrow
    bf16 model for 2 steps through one worker: both terminate with finite
    rows, and afterwards none of their processes (trials and workers) runs
    or holds the card."""
    import math
    import os
    import subprocess

    from ray_lightning_tpu_torch import runtime as rt
    from ray_lightning_tpu_torch import tune

    import torch_tune_helpers as helpers

    def apps():
        out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
        return {int(x) for x in out.stdout.split() if x.strip().isdigit()}

    before = apps()
    try:
        analysis = tune.run(
            helpers.cuda_sweep_trainable,
            config={"lr": tune.grid_search([1e-3, 3e-3])}, metric="val_loss",
            local_dir=str(tmp_path), resources_per_trial={"CPU": 1, "GPU": 0.5},
            max_concurrent_trials=2, verbose=0)
    finally:
        rt.shutdown()
    assert [t.status for t in analysis.trials] == ["TERMINATED"] * 2, [
        t.error for t in analysis.trials]
    for t in analysis.trials:
        assert len(t.results) == 2
        assert all(math.isfinite(r["val_loss"]) for r in t.results)
    pids = [int(name.split("-")[1]) for t in analysis.trials
            for name in os.listdir(t.logdir)
            if name.startswith(("trial-", "worker-"))]
    assert len(pids) == 4
    assert helpers.wait_gone(pids, timeout=30) == []
    assert apps() <= before


def _card_apps_and_used():
    import subprocess

    def query(*fields):
        return subprocess.run(["nvidia-smi", *fields], capture_output=True,
                              text=True, timeout=60, check=True).stdout
    apps = {int(x) for x in query("--query-compute-apps=pid",
                                  "--format=csv,noheader").split()
            if x.strip().isdigit()}
    used = int(query("--query-gpu=memory.used",
                     "--format=csv,noheader,nounits").split()[0])
    return apps, used


def _fault_fit(tmp_path, strategy, epochs=3):
    """A tiny fp32 model on the card through ``strategy``: two steps an
    epoch, a validation batch and a checkpoint at each epoch's end."""
    from ray_lightning_tpu_torch.callbacks import ModelCheckpoint
    from ray_lightning_tpu_torch.core import Trainer
    from ray_lightning_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaModule,
        SyntheticLMDataModule,
    )

    import torch_fault_helpers as helpers

    cfg = dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32,
                              max_seq=64)
    module = LlamaModule(cfg, lr=3e-3, warmup_steps=1, total_steps=2 * epochs)
    trainer = Trainer(device="cuda", strategy=strategy, max_epochs=epochs,
                      seed=0, logger=False, limit_train_batches=2,
                      limit_val_batches=1,
                      callbacks=[ModelCheckpoint(dirpath=str(tmp_path / "ckpts")),
                                 helpers.WorkerPids(str(tmp_path / "pids"))])
    trainer.fit(module, datamodule=SyntheticLMDataModule(
        cfg, batch_size=4, n_train=8, n_val=4))
    return trainer, module


def test_crash_and_resume_on_card_is_bitwise(cuda, tmp_path, monkeypatch):
    """RayStrategy(num_workers=1, use_gpu=True, max_failures=1) under a fused
    rank0:crash@step3: the worker dies holding its CUDA context, the group
    is relaunched (after the dead worker's pid has exited) from the epoch-0
    checkpoint, and the weights equal the uninterrupted fit's bitwise."""
    from ray_lightning_tpu_torch import runtime as rt
    from ray_lightning_tpu_torch.runtime import faults
    from ray_lightning_tpu_torch.strategies import RayStrategy
    from ray_lightning_tpu_torch.utils.tree import tree_leaves

    try:
        _, want = _fault_fit(tmp_path / "ref", RayStrategy(
            num_workers=1, use_gpu=True, timeout_s=120))
        monkeypatch.setenv(faults.FAULT_ENV, "rank0:crash@step3")
        monkeypatch.setenv(faults.FUSE_ENV, str(tmp_path / "fuses"))
        strategy = RayStrategy(num_workers=1, use_gpu=True, max_failures=1,
                               timeout_s=120)
        trainer, got = _fault_fit(tmp_path / "faulted", strategy)
    finally:
        rt.shutdown()
    assert [f["error"] for f in strategy.launcher.failures] == ["ActorError"]
    assert trainer.global_step == 6 and strategy.launcher.backend == "nccl"
    for a, b in zip(tree_leaves(got.params), tree_leaves(want.params)):
        assert a.device.type == "cuda" and torch.equal(a, b)


def test_supervisor_kills_a_hung_worker_holding_the_card(cuda, tmp_path,
                                                         monkeypatch):
    """A worker that hangs at step 1 while holding a CUDA context and its
    model: with hang_timeout 3 s and max_failures 0 the supervisor kills it
    and the fit raises WorkerHangError; the worker's process is gone, no
    process of it holds the card, and the card's used memory is back within
    1 GiB."""
    import torch_fault_helpers as helpers
    from ray_lightning_tpu_torch import runtime as rt
    from ray_lightning_tpu_torch.launchers.ray_launcher import _exited
    from ray_lightning_tpu_torch.runtime import faults
    from ray_lightning_tpu_torch.runtime.supervisor import WorkerHangError
    from ray_lightning_tpu_torch.strategies import RayStrategy

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    apps, used = _card_apps_and_used()
    monkeypatch.setenv(faults.FAULT_ENV, "rank0:hang@step1")
    strategy = RayStrategy(num_workers=1, use_gpu=True, max_failures=0,
                           hang_timeout=3.0, heartbeat_interval=0.5,
                           timeout_s=120)
    try:
        with pytest.raises(WorkerHangError, match="hang detected"):
            _fault_fit(tmp_path, strategy, epochs=1)
    finally:
        rt.shutdown()
    (pid,) = helpers.pids_in(str(tmp_path / "pids"))
    assert _exited(pid)
    after_apps, after_used = _card_apps_and_used()
    assert pid not in after_apps and after_apps <= apps
    assert after_used <= used + 1024


def test_zygote_child_launches_the_kernels_on_the_card(cuda):
    """An actor forked from the zygote opens its own CUDA context (the
    zygote never initialized one) and launches a kernel there; the zygote
    still has none."""
    from ray_lightning_tpu_torch import runtime as rt

    from torch_ray_helpers import KernelProbe

    try:
        rt.init(num_cpus=2)
        status = rt.warm_zygote().status()
        (probe,) = rt.create_actors([(KernelProbe, (), {})], zygote=True,
                                    timeout=300)
        got = probe.rmsnorm_on_card.remote().result(timeout=600)
        after = rt.api._state.zygote.status()
    finally:
        rt.shutdown()
    assert not status["cuda_initialized"] and not after["cuda_initialized"]
    assert got["launches"]["rmsnorm"] == 1
    assert got["max_abs_err"] <= 2e-2


def test_elastic_hang_is_absorbed_on_the_card(cuda, tmp_path, monkeypatch):
    """Two workers sharing the card over gloo, a narrow fp32 model, rank 1
    hung at step 3 with elastic=True and max_failures=0: the supervisor's
    verdict shrinks the group around it, a spare forked from the zygote
    joins at the next epoch boundary, and the members end bitwise equal,
    with no process of the fit left on the card."""
    import time

    import torch_elastic_helpers as eh
    from ray_lightning_tpu_torch import runtime as rt
    from ray_lightning_tpu_torch.core import Trainer
    from ray_lightning_tpu_torch.launchers.ray_launcher import _exited
    from ray_lightning_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaModule,
        SyntheticLMDataModule,
    )
    from ray_lightning_tpu_torch.runtime import faults
    from ray_lightning_tpu_torch.strategies import RayStrategy

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    apps, used = _card_apps_and_used()
    probe = tmp_path / "probes"
    probe.mkdir()
    monkeypatch.setenv(faults.FAULT_ENV, "rank1:hang@step3")
    monkeypatch.setenv(faults.FUSE_ENV, str(tmp_path / "fuses"))
    cfg = dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32,
                              max_seq=64)
    strategy = RayStrategy(num_workers=2, use_gpu=True, elastic=True,
                           min_workers=1, max_failures=0, hang_timeout=5.0,
                           heartbeat_interval=0.5, timeout_s=300,
                           resources_per_worker={"GPU": 0.5})
    try:
        trainer = Trainer(device="cuda", strategy=strategy, max_epochs=3,
                          seed=0, logger=False, limit_train_batches=2,
                          enable_checkpointing=False,
                          callbacks=[eh.WorldProbe(str(probe))])
        trainer.fit(LlamaModule(cfg, lr=3e-3, warmup_steps=0, total_steps=12),
                    datamodule=SyntheticLMDataModule(cfg, batch_size=4,
                                                     n_train=16, n_val=4))
        zygote_pid = rt.api._state.zygote.pid
    finally:
        rt.shutdown()
    launcher = strategy.launcher
    assert launcher.backend == "gloo" and launcher.failures == []
    assert launcher.elastic["resizes"] == {"shrink": 1, "grow": 1}
    assert launcher.elastic["events"][0]["reason"] == "hang verdict"
    assert launcher.transport["heartbeat_queue"] == "shm"
    records = eh.read_probes(str(probe))
    assert {r["world"] for r in records} == {1, 2}
    assert len({r["pid"] for r in records}) == 3
    hashes = eh.read_hashes(str(probe))
    assert len(hashes) == 2 and len(set(hashes.values())) == 1
    pids = {r["pid"] for r in records} | {zygote_pid}
    deadline = time.monotonic() + 60
    while not all(_exited(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert all(_exited(p) for p in pids)
    after_apps, after_used = _card_apps_and_used()
    assert not (pids & after_apps) and after_apps <= apps
    assert after_used <= used + 1024


def _params_to(params, device):
    return {k: (v.to(device) if torch.is_tensor(v) else
                {n: t.to(device) for n, t in v.items()})
            for k, v in params.items()}


def _pump(src, dst, n_new, timeout=120):
    """Move every ready export of ``src`` into ``dst`` (a few lines of the
    fleet's pump): returns the decode engine's completions by request."""
    import time

    from ray_lightning_tpu_torch.serving import MigrationRejected

    out, pending = {}, []
    deadline = time.time() + timeout
    while len(out) < len(n_new) and time.time() < deadline:
        pending += [(rid, src.export_shipment(rid))
                    for rid in src.drain_ready_exports()]
        waiting = []
        for rid, ship in pending:
            try:
                out[rid] = dst.import_shipment(
                    ship, max_new_tokens=n_new[rid], request_id=rid)
            except MigrationRejected:  # the receiver is full: offer later
                waiting.append((rid, ship))
                continue
            src.finish_export(rid)
        pending = waiting
        time.sleep(0.002)
    return out


def test_two_engines_on_two_threads_migrate_on_card(cuda):
    """A prefill and a decode engine share the card and one params dict,
    each on its own loop thread: every migrated stream equals the
    colocated engine's on the card and on the CPU (fp32), the prefills
    launch flash on the prefill engine only, and both pools end empty."""
    from ray_lightning_tpu_torch import kernels
    from ray_lightning_tpu_torch.models.llama import LlamaConfig, init_params
    from ray_lightning_tpu_torch.serving import EngineConfig, InferenceEngine

    cfg = dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32)
    cpu_params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    params = _params_to(cpu_params, cuda)
    kw = dict(num_slots=3, max_prompt_len=12, max_len=32, block_size=4,
              kv_layout="paged")
    rng = np.random.default_rng(2)
    shared = [3, 1, 4, 1, 5, 9, 2, 6]
    prompts = [(shared if i % 3 == 0 else []) +
               rng.integers(1, cfg.vocab_size, int(rng.integers(2, 5))).tolist()
               for i in range(7)]
    n_new = {f"r{i}": 4 + i % 3 for i in range(len(prompts))}
    colocated = {}
    for device, p in (("cpu", cpu_params), (cuda, params)):
        eng = InferenceEngine(p, cfg, EngineConfig(**kw), device=device)
        comps = [eng.submit(pr, max_new_tokens=n_new[f"r{i}"])
                 for i, pr in enumerate(prompts)]
        eng.run_until_idle()
        colocated[str(device)] = [c.tokens for c in comps]
    assert colocated["cpu"] == colocated["cuda"]

    src = InferenceEngine(params, cfg, EngineConfig(role="prefill", **kw),
                          device=cuda, replica_index=0)
    dst = InferenceEngine(params, cfg, EngineConfig(role="decode", **kw),
                          device=cuda, replica_index=1)
    src.start()
    dst.start()
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        src_comps = [src.submit(pr, max_new_tokens=n_new[f"r{i}"],
                                request_id=f"r{i}")
                     for i, pr in enumerate(prompts)]
        got = _pump(src, dst, n_new)
        streams = [got[f"r{i}"].result(timeout=120)
                   for i in range(len(prompts))]
        for c in src_comps:
            c.result(timeout=60)
            assert c.finish_reason == "migrated"
    finally:
        src.drain(timeout=60)
        dst.drain(timeout=60)
    assert streams == colocated["cuda"]
    counts = kernels.launch_counts()
    assert counts["flash_fwd"] == cfg.n_layers * len(prompts)
    assert counts["paged_decode"] == cfg.n_layers * dst.stats["decode_steps"]
    assert src.stats["decode_steps"] == 0
    for eng in (src, dst):
        assert eng.pool.occupancy == 0
        assert eng.pool.allocator.stats()["chains_pinned"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shipment_payload_is_the_cache_blocks_on_card(cuda, dtype):
    from ray_lightning_tpu_torch.models.llama import LlamaConfig, init_params
    from ray_lightning_tpu_torch.serving import EngineConfig, InferenceEngine

    cfg = dataclasses.replace(LlamaConfig.tiny(), dtype=dtype)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(1))
    src = InferenceEngine(params, cfg, EngineConfig(
        role="prefill", num_slots=2, max_prompt_len=12, max_len=32,
        block_size=4, kv_layout="paged"))
    src.submit(list(range(5, 16)), max_new_tokens=3, request_id="a")
    src.step()
    [rid] = src.drain_ready_exports()
    ship = src.export_shipment(rid)
    blocks = src.pool._alloc_of[src._exports[rid]["slot"]].blocks
    assert ship.num_blocks == 3
    for j in range(ship.num_blocks):
        for name, payload in (("k", ship.block_k), ("v", ship.block_v)):
            want = src.pool.cache[name][:, blocks[j]].cpu()
            if dtype == torch.bfloat16:
                assert payload[j].dtype == np.uint16
                want = want.view(torch.int16).numpy().view(np.uint16)
            else:
                want = want.numpy()
            np.testing.assert_array_equal(payload[j], want)


def test_refused_shipment_leaves_receiver_cache_bitwise_on_card(cuda):
    from ray_lightning_tpu_torch.models.llama import LlamaConfig, init_params
    from ray_lightning_tpu_torch.serving import (
        EngineConfig,
        InferenceEngine,
        ShipmentCorrupt,
    )
    from ray_lightning_tpu_torch.serving.migration import corrupt_copy

    cfg = dataclasses.replace(LlamaConfig.tiny(), dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(2))
    kw = dict(num_slots=2, max_prompt_len=12, max_len=32, block_size=4,
              kv_layout="paged")
    src = InferenceEngine(params, cfg, EngineConfig(role="prefill", **kw))
    dst = InferenceEngine(params, cfg, EngineConfig(role="decode", **kw))
    src.submit([7, 1, 8, 2, 8, 1], max_new_tokens=4, request_id="a")
    src.step()
    ship = src.export_shipment("a")
    dst.submit([2, 2, 3], max_new_tokens=2)
    dst.run_until_idle()  # the receiver's cache holds something
    before = {k: v.clone() for k, v in dst.pool.cache.items()}
    free = dst.pool.allocator.free_blocks
    dst.start()
    try:
        with pytest.raises(ShipmentCorrupt):
            dst.import_shipment(corrupt_copy(ship), max_new_tokens=4)
        torch.cuda.synchronize()
        assert dst.pool.occupancy == 0
        assert dst.pool.allocator.free_blocks == free
        assert all(torch.equal(before[k], dst.pool.cache[k]) for k in before)
        comp = dst.import_shipment(ship, max_new_tokens=4, request_id="a")
        assert len(comp.result(timeout=60)) == 4
    finally:
        dst.drain(timeout=60)


# --------------------------------------------------------------------- #
# the fleet on the card
# --------------------------------------------------------------------- #
def _fleet_model(cuda):
    from ray_lightning_tpu_torch.models.llama import LlamaConfig, init_params

    cfg = dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         device=cuda)
    return params, cfg


def test_engine_warmup_loads_the_kernels_and_launches_nothing(cuda):
    from ray_lightning_tpu_torch import kernels
    from ray_lightning_tpu_torch.serving import EngineConfig, InferenceEngine

    params, cfg = _fleet_model(cuda)
    engine = InferenceEngine(params, cfg, EngineConfig(
        num_slots=2, max_prompt_len=8, max_len=32, kv_layout="paged",
        block_size=4), device=cuda)
    kernels.reset_launch_counts()
    stats = dict(engine.stats)
    assert engine.warmup() == ["rmsnorm", "flash_fwd", "paged_decode",
                               "argmax"]
    assert set(kernels.launch_counts().values()) == {0}
    assert dict(engine.stats) == stats
    for k in engine._kernels():
        assert k._fn is not None
    slot = InferenceEngine(params, cfg, EngineConfig(
        num_slots=2, max_prompt_len=8, max_len=32), device=cuda)
    assert slot.warmup() == ["rmsnorm", "flash_fwd", "argmax"]


def test_fleet_kill_loop_gives_the_card_memory_back(cuda, monkeypatch):
    """``replica0:crash@every:6`` on a fleet of two engines on the card:
    every request completes with the colocated engine's stream (fp32), and
    after the shutdown no engine the fleet started (the crashed and the
    relaunched included) is alive, and the allocated memory is back to its
    level before the fleet but for the cuBLAS workspaces of the new loop
    threads' handles (32 MiB a handle, cached by torch for the process)."""
    import gc
    import weakref

    from ray_lightning_tpu_torch.serving import (
        EngineConfig,
        InferenceEngine,
        LocalReplicaFleet,
    )

    started = []
    start = InferenceEngine.start

    def tracked_start(engine):
        started.append(weakref.ref(engine))
        start(engine)

    monkeypatch.setattr(InferenceEngine, "start", tracked_start)

    params, cfg = _fleet_model(cuda)
    kw = dict(num_slots=4, max_prompt_len=16, max_len=64, kv_layout="paged",
              block_size=4)
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(1, cfg.vocab_size, 5).tolist(), 8 + i % 4)
            for i in range(12)]
    eng = InferenceEngine(params, cfg, EngineConfig(**kw), device=cuda)
    comps = [eng.submit(p, max_new_tokens=n) for p, n in reqs]
    eng.run_until_idle()
    want = [c.tokens for c in comps]
    del eng, comps
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    monkeypatch.setenv("TORCHRT_FAULT", "replica0:crash@every:6")
    monkeypatch.delenv("TORCHRT_FAULT_FUSE", raising=False)
    fleet = LocalReplicaFleet(lambda: (params, cfg), engine_kwargs=kw,
                              initial_replicas=2, max_retries=8,
                              breaker_threshold=2, breaker_cooldown_s=0.2,
                              device=cuda)
    try:
        entries = [fleet.submit(p, max_new_tokens=n) for p, n in reqs]
        assert [e.result(timeout=120) for e in entries] == want
        stats = fleet.stats()
        assert stats["completed"] == 12 and stats["failed"] == 0
        assert fleet.relaunches_total >= 1 and stats["retries"] >= 1
    finally:
        fleet.shutdown()
    assert len(started) == 2 + fleet.relaunches_total
    del fleet, entries
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert all(ref() is None for ref in started)
    assert torch.cuda.memory_allocated() <= before + 3 * 32 * 2**20


def test_replica_group_of_two_actors_on_the_card(cuda):
    """Two ServeReplicaActor processes on the card, each building the same
    seeded weights: the streams equal one engine's in this process (fp32),
    both replicas serve, and after the shutdown no actor is left."""
    import functools
    import time

    from ray_lightning_tpu_torch import runtime as rt
    from ray_lightning_tpu_torch.runtime.api import pid_exited
    from ray_lightning_tpu_torch.serving import (
        EngineConfig,
        InferenceEngine,
        ReplicaGroup,
    )

    import torch_fleet_helpers

    params, cfg = _fleet_model(cuda)
    kw = dict(num_slots=2, max_prompt_len=8, max_len=32, kv_layout="paged",
              block_size=4)
    reqs = [([3 + i, 1, 4], 6) for i in range(6)]
    eng = InferenceEngine(params, cfg, EngineConfig(**kw), device=cuda)
    comps = [eng.submit(p, max_new_tokens=n) for p, n in reqs]
    eng.run_until_idle()
    want = [c.tokens for c in comps]
    builder = functools.partial(torch_fleet_helpers.seeded_builder,
                                cfg.to_dict(), 0, "cuda")
    group = ReplicaGroup(builder, engine_kwargs=kw, num_replicas=2,
                         device="cuda", heartbeat_interval=0.2).start()
    pids = [h._pid for h in group.handles.values()]
    try:
        futures = [group.submit(p, max_new_tokens=n) for p, n in reqs]
        assert [f.result(timeout=120) for f in futures] == want
        assert {f.replica for f in futures} == {0, 1}
        assert group.check() == {0: "ok", 1: "ok"}
    finally:
        group.shutdown()
        rt.shutdown()
    deadline = time.monotonic() + 30
    while not all(pid_exited(p) for p in pids):
        assert time.monotonic() < deadline, pids
        time.sleep(0.1)
