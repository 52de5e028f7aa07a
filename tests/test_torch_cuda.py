"""Each CUDA kernel of the port against its plain version on the card.

These tests import neither JAX nor ``repro``, so they run where the card
is (the machine with the GPU has no JAX): from the repository root,

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

``--noconftest`` skips ``tests/conftest.py``, which imports JAX.  Without
a GPU every test skips.  Tolerance: bf16, rtol = atol = 2e-2 as
tests/test_fused_swiglu.py:50; the kernels sum in another order than the
plain float32 einsums and round the output to bf16.
"""

import pytest
import torch

from _torch_port import pin_threads

pin_threads()

from repro_torch.kernels import ops, ref  # noqa: E402

BF = torch.bfloat16
TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rnd(g, shape, dev, scale=1.0):
    return (torch.randn(shape, generator=g, device=dev) * scale).to(BF)


def _close(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.isfinite(got.float()).all()
    assert torch.allclose(got.float(), want.float(), **TOL), float((got.float() - want.float()).abs().max())


def _three_launches(call, want, zero_rows):
    """Three launches on the same buffers, each against the plain version
    with exact zeros on ``zero_rows`` (a counter that a launch left
    non-zero breaks the next one), and bitwise equal to each other."""
    outs = [call() for _ in range(3)]
    for got in outs:
        _close(got, want)
        assert (got[zero_rows] == 0).all()
    assert all(torch.equal(outs[0], o) for o in outs[1:])


def _head_case(dev, seed, G, E, C, K, F, N, sizes, rog=None):
    """Inputs of one fused-head case and the plain version's output.  The
    weights of every expert no live group uses are 1e4, so a read of the
    wrong expert shows."""
    g = torch.Generator(device=dev).manual_seed(seed)
    buf = _rnd(g, (G, C, K), dev)
    wg, wu = (_rnd(g, (E, K, F), dev, K**-0.5) for _ in range(2))
    wd = _rnd(g, (E, F, N), dev, F**-0.5)
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    rog = None if rog is None else torch.tensor(rog, dtype=torch.int32, device=dev)
    used = (rog.long() if rog is not None else torch.arange(G, device=dev))[gs > 0]
    unused = torch.ones((E,), dtype=torch.bool, device=dev)
    unused[used] = False
    wg[unused], wu[unused], wd[unused] = 1e4, 1e4, 1e4
    want = ref.fused_swiglu_gmm_ref(buf, wg, wu, wd, gs, rog)
    dead = torch.arange(C, device=dev)[None, :] >= gs[:, None]
    return (buf, wg, wu, wd, gs, rog), want, dead


def _sizes(seed, G, C, live, hi=None):
    """Group sizes: ``live`` random groups with 1..hi rows (hi = C), the
    others dead."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sizes = np.zeros(G, np.int64)
    groups = rng.permutation(G)[:live]
    sizes[groups] = rng.integers(1, (hi or C) + 1, live)
    return sizes.tolist()


# (G, E, C, K, F, N, sizes, rhs_of_group) of the fused head's card cases
_HEAD_CASES = {
    # the full-width decode shape: 13 live groups of 2-8 rows
    "decode": (128, 128, 8, 2048, 768, 2048, _sizes(0, 128, 8, 13, 8), None),
    # a 512-token prefill chunk: C = 40, ragged sizes 0-40
    "prefill_C40": (128, 128, 40, 2048, 768, 2048,
                    [int(v) for v in torch.randint(0, 41, (128,), generator=torch.Generator().manual_seed(1))],
                    None),
    "all_dead": (128, 128, 8, 2048, 768, 2048, [0] * 128, None),
    # sizes past the capacity clamp to C
    "sizes_above_C": (16, 16, 8, 256, 128, 256, [9, 0, 8, 30, 1, 0, 0, 12, 0, 3, 0, 0, 7, 0, 100, 0], None),
    # groups sharing experts, some experts unrouted
    "rhs_of_group": (12, 6, 8, 256, 192, 320, [8, 3, 0, 5, 8, 1, 2, 0, 8, 4, 6, 7],
                     [2, 0, 2, 5, 0, 2, 3, 1, 5, 5, 0, 3]),
    "C1": (128, 128, 1, 2048, 768, 2048, _sizes(2, 128, 1, 40), None),
    "C20": (32, 32, 20, 512, 256, 384, _sizes(3, 32, 20, 20), None),
    # the smallest legal widths (K, F, N multiples of 64)
    "smallest": (8, 8, 8, 64, 64, 64, [8, 0, 1, 5, 0, 8, 3, 2], None),
    # two items per group (C > 64)
    "C100": (16, 16, 100, 256, 128, 192, _sizes(4, 16, 100, 9), None),
}


@pytest.mark.cuda
class TestFusedKernels:
    def test_swiglu_gmm_capacity(self, cuda):
        g = torch.Generator(device=cuda).manual_seed(0)
        E, C, K, F, N = 8, 20, 128, 64, 128
        buf = _rnd(g, (E, C, K), cuda)
        wg, wu = (_rnd(g, (E, K, F), cuda, K**-0.5) for _ in range(2))
        wd = _rnd(g, (E, F, N), cuda, F**-0.5)
        gs = torch.tensor([20, 0, 1, 16, 17, 0, 5, 20], dtype=torch.int32, device=cuda)
        _close(ops.swiglu_gmm_capacity(buf, wg, wu, wd, gs), ref.fused_swiglu_gmm_ref(buf, wg, wu, wd, gs))

    @pytest.mark.parametrize("case", list(_HEAD_CASES))
    def test_swiglu_gmm_capacity_persistent(self, cuda, case):
        """The persistent one-launch head against its plain version, three
        times on the same buffers (readiness counters back at zero after
        each), bitwise equal from call to call, one launch per call."""
        G, E, C, K, F, N, sizes, rog = _HEAD_CASES[case]
        args, want, dead = _head_case(cuda, len(case), G, E, C, K, F, N, sizes, rog)
        ops.reset_launches()
        _three_launches(lambda: ops.swiglu_gmm_capacity(*args), want, dead)
        assert ops.LAUNCHES["swiglu_gmm_capacity"] == 3

    def test_swiglu_gemv(self, cuda):
        g = torch.Generator(device=cuda).manual_seed(1)
        E, K, F, N = 8, 128, 64, 128
        toks = _rnd(g, (E, K), cuda)
        wg, wu = (_rnd(g, (E, K, F), cuda, K**-0.5) for _ in range(2))
        wd = _rnd(g, (E, F, N), cuda, F**-0.5)
        eids = torch.arange(E, dtype=torch.int32, device=cuda)
        valid = torch.tensor([1, 0, 1, 1, 0, 0, 1, 1], dtype=torch.int32, device=cuda)
        _close(ops.swiglu_gemv(toks, wg, wu, wd, eids, valid),
               ref.fused_swiglu_gemv_ref(toks, wg, wu, wd, eids, valid))


@pytest.mark.cuda
class TestGmmCapacity:
    @pytest.mark.parametrize(
        "G,C,K,N", [(8, 20, 128, 64), (8, 20, 64, 128), (128, 8, 2048, 768), (128, 40, 768, 2048)],
        ids=["proxy_gate", "proxy_down", "decode_gate", "prefill_down"],
    )
    def test_against_plain(self, cuda, G, C, K, N):
        g = torch.Generator(device=cuda).manual_seed(G + C)
        buf = _rnd(g, (G, C, K), cuda)
        rhs = _rnd(g, (G, K, N), cuda, K**-0.5)
        sizes = torch.randint(0, C + 1, (G,), generator=g, device=cuda)
        sizes[: G // 4] = 0  # dead groups
        sizes[-1] = C  # a full group, ragged last tile when C % 16
        gs = sizes.to(torch.int32)
        got = ops.gmm_capacity(buf, rhs, gs)
        _close(got, ref.gmm_ref(buf, rhs, gs))
        dead = torch.arange(C, device=cuda)[None, :] >= gs[:, None]
        assert (got[dead] == 0).all()

    def test_rhs_of_group(self, cuda):
        g = torch.Generator(device=cuda).manual_seed(3)
        G, E, C, K, N = 6, 3, 24, 128, 64
        buf = _rnd(g, (G, C, K), cuda)
        rhs = _rnd(g, (E, K, N), cuda, K**-0.5)
        gs = torch.tensor([24, 3, 0, 17, 16, 1], dtype=torch.int32, device=cuda)
        rog = torch.tensor([2, 0, 1, 2, 1, 0], dtype=torch.int32, device=cuda)
        _close(ops.gmm_capacity(buf, rhs, gs, rog), ref.gmm_ref(buf, rhs, gs, rog))

    @pytest.mark.parametrize(
        "live,C,K,N,shared",
        [
            (1, 8, 2048, 768, False),  # one live group: its tiles shared by every SM
            (13, 8, 2048, 768, False),  # the decode gate call
            (13, 8, 768, 2048, False),  # the decode down call
            (128, 8, 2048, 768, False),  # every group live: whole tiles round-robin
            (128, 40, 768, 2048, False),  # prefill down call, C % 16 != 0, ragged sizes
            (20, 100, 256, 192, False),  # two row blocks, a 64-column last tile
            (13, 8, 2048, 768, True),  # groups sharing weights (rhs_of_group)
        ],
        ids=["one_live", "decode_gate", "decode_down", "all_live", "prefill_down_C40",
             "two_row_blocks", "rhs_of_group"],
    )
    def test_persistent_stream_k(self, cuda, live, C, K, N, shared):
        """The persistent kernel on live-group counts from one to all (tiles
        shared between blocks, and whole tiles), against the plain version,
        three times on the same buffers (each launch must leave its tickets
        at zero for the next), and bitwise equal from call to call (shared
        tiles summed in K order)."""
        G = 128
        g = torch.Generator(device=cuda).manual_seed(live + C)
        buf = _rnd(g, (G, C, K), cuda)
        rhs = _rnd(g, (G, K, N), cuda, K**-0.5)
        sizes = torch.zeros((G,), dtype=torch.int32, device=cuda)
        groups = torch.randperm(G, generator=g, device=cuda)[:live]
        sizes[groups] = torch.randint(1, C + 1, (live,), generator=g, device=cuda).to(torch.int32)
        sizes[groups[0]] = C + 5  # past the capacity: clamped to C
        rog = torch.randint(0, G, (G,), generator=g, device=cuda).to(torch.int32) if shared else None
        want = ref.gmm_ref(buf, rhs, sizes, rog)
        dead = torch.arange(C, device=cuda)[None, :] >= sizes[:, None]
        outs = [ops.gmm_capacity(buf, rhs, sizes, rog) for _ in range(3)]
        for got in outs:
            _close(got, want)
            assert (got[dead] == 0).all()
        assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.cuda
class TestExpertGemv:
    @pytest.mark.parametrize("E,K,N", [(8, 128, 64), (8, 64, 128), (128, 2048, 768), (128, 768, 2048)])
    def test_against_plain(self, cuda, E, K, N):
        g = torch.Generator(device=cuda).manual_seed(E + K)
        toks = _rnd(g, (E, K), cuda)
        w = _rnd(g, (E, K, N), cuda, K**-0.5)
        eids = torch.randperm(E, generator=g, device=cuda).to(torch.int32)
        valid = (torch.rand((E,), generator=g, device=cuda) < 0.4).to(torch.int32)
        got = ops.expert_gemv(toks, w, eids, valid)
        _close(got, ref.expert_gemv_ref(toks, w, eids, valid))
        assert (got[valid == 0] == 0).all()

    def test_strided_rows(self, cuda):
        """The tail passes ``buf[:, :1]`` rows of the capacity slab."""
        g = torch.Generator(device=cuda).manual_seed(4)
        E, C, K, N = 8, 4, 128, 64
        slab = _rnd(g, (E, C, K), cuda)
        w = _rnd(g, (E, K, N), cuda, K**-0.5)
        eids = torch.arange(E, dtype=torch.int32, device=cuda)
        valid = torch.tensor([1, 0, 1, 1, 0, 1, 1, 0], dtype=torch.int32, device=cuda)
        got = ops.expert_gemv(slab[:, :1].reshape(E, K), w, eids, valid)
        _close(got, ref.expert_gemv_ref(slab[:, 0].contiguous(), w, eids, valid))


@pytest.mark.cuda
class TestDecodeAttention:
    def test_dense(self, cuda):
        g = torch.Generator(device=cuda).manual_seed(2)
        B, T, Kv, G, dh = 4, 100, 2, 8, 128
        q = _rnd(g, (B, Kv * G, dh), cuda)
        ck, cv = (_rnd(g, (B, T, Kv, dh), cuda) for _ in range(2))
        L = torch.tensor([100, 0, 65, 1], dtype=torch.int32, device=cuda)
        got = ops.decode_attention(q, ck, cv, L)
        _close(got, ref.decode_attention_ref(q, ck, cv, L))
        assert (got[1] == 0).all()

    @pytest.mark.parametrize(
        "T,lens",
        [
            (1000, [0, 1, 63, 64, 65, 1000, 999, 500]),  # ragged tails, length 0, length T
            (1000, [64, 1, 33, 32, 0, 17, 64, 2]),  # every length <= 64: one split each
            (1024, [1024, 1, 1, 1, 1, 1, 1, 1]),  # one long sequence, seven idle slots
            (1024, [145, 387, 201, 330, 260, 178, 299, 356]),  # serving lengths
            (4100, [4100, 1025, 1500, 33, 0, 2049, 4099, 3000]),  # several chunks per split
        ],
        ids=["edges", "short", "one_long_seven_idle", "serving", "long_cache"],
    )
    def test_dense_split_over_live_length(self, cuda, T, lens):
        """The dense kernel splits each sequence over its own live length
        and combines the splits in the last block to finish: against the
        plain version, three times on the same buffers (each launch must
        leave its tickets at zero for the next), and bitwise equal from call
        to call (splits summed in split order)."""
        g = torch.Generator(device=cuda).manual_seed(T + lens[0])
        B, Kv, G, dh = 8, 4, 8, 128
        q = _rnd(g, (B, Kv * G, dh), cuda)
        ck, cv = (_rnd(g, (B, T, Kv, dh), cuda) for _ in range(2))
        L = torch.tensor(lens, dtype=torch.int32, device=cuda)
        want = ref.decode_attention_ref(q, ck, cv, L)
        ops.reset_launches()
        outs = [ops.decode_attention(q, ck, cv, L) for _ in range(3)]
        assert ops.LAUNCHES["decode_attention"] == 3 and ops.LAUNCHES["decode_attention_split"] == 0
        for got in outs:
            _close(got, want)
            assert (got[L == 0] == 0).all()
        assert all(torch.equal(outs[0], o) for o in outs[1:])

    @pytest.mark.parametrize("n_splits", [2, 3, 8])
    def test_split(self, cuda, n_splits):
        """Mixed lengths: a length-0 row, and rows whose later splits hold
        no live position (empty splits)."""
        g = torch.Generator(device=cuda).manual_seed(5 + n_splits)
        B, T, Kv, G, dh = 8, 1000, 4, 8, 128
        q = _rnd(g, (B, Kv * G, dh), cuda)
        ck, cv = (_rnd(g, (B, T, Kv, dh), cuda) for _ in range(2))
        L = torch.tensor([0, 1000, 999, 63, 64, 65, 1, 500], dtype=torch.int32, device=cuda)
        ops.reset_launches()
        got = ops.decode_attention(q, ck, cv, L, n_splits=n_splits)
        assert ops.LAUNCHES["decode_attention_split"] == 1 and ops.LAUNCHES["decode_attention"] == 0
        _close(got, ref.decode_attention_split_ref(q, ck, cv, L, n_splits))
        _close(got, ref.decode_attention_ref(q, ck, cv, L))
        assert (got[0] == 0).all()

    @pytest.mark.parametrize("n_splits", [2, 3, 4, 8])
    def test_split_over_live_length(self, cuda, n_splits):
        """The split-KV kernel splits each sequence over its own live length
        whatever ``n_splits``: against the plain version, which keeps the
        TPU's partition over T (whole splits of it empty here), three times
        on the same buffers, bitwise equal from call to call, and the
        ticket counters back at zero."""
        g = torch.Generator(device=cuda).manual_seed(40 + n_splits)
        B, T, Kv, G, dh = 8, 4100, 4, 8, 128
        q = _rnd(g, (B, Kv * G, dh), cuda)
        ck, cv = (_rnd(g, (B, T, Kv, dh), cuda) for _ in range(2))
        L = torch.tensor([0, 1, 32, 64, 65, T - 1, 1000, 2049], dtype=torch.int32, device=cuda)
        want = ref.decode_attention_split_ref(q, ck, cv, L, n_splits)
        ops.reset_launches()
        _three_launches(lambda: ops.decode_attention(q, ck, cv, L, n_splits=n_splits), want, L == 0)
        assert ops.LAUNCHES["decode_attention_split"] == 3 and ops.LAUNCHES["decode_attention"] == 0
        _close(ops.decode_attention(q, ck, cv, L, n_splits=n_splits), ref.decode_attention_ref(q, ck, cv, L))
        torch.cuda.synchronize()
        assert not ops._TICKETS[("decode_attention_split", q.device.index, B * Kv)].any()

    @pytest.mark.parametrize("page", [8, 16, 32, 64])
    def test_paged(self, cuda, page):
        """Shuffled pool blocks, trash cells past each length, an idle slot
        of length 1 on the trash block, a length-0 slot, and poisoned free
        blocks that no slot may read; three launches on the same buffers
        (tickets back at zero), bitwise equal."""
        lens = [1024, 0, 1, 17, 300, page, page + 1, 640]
        args, want = _paged_case(cuda, page, page, lens, idle=(2,))
        _three_launches(lambda: ops.decode_attention_paged(*args), want, args[4] == 0)

    @pytest.mark.parametrize(
        "page,lens,idle,bad",
        [
            (16, [145, 387, 201, 330, 260, 178, 299, 356], (), ()),  # serving lengths
            (16, [1024, 1, 1, 1, 1, 1, 1, 1], tuple(range(1, 8)), ()),  # one long slot, seven idle
            (16, [1500, 387, 201, 330, 0, 178, 299, 356], (), ()),  # a length past max_blocks x page
            (16, [300, 200, 1, 330, 260, 178, 299, 356], (), ((0, 2, "past"), (1, 0, "negative"))),
            (64, [145, 387, 201, 330, 260, 178, 299, 356], (), ()),
        ],
        ids=["serving", "one_long_seven_idle", "length_past_table", "cells_outside_pool", "serving_page64"],
    )
    def test_paged_split_over_live_length(self, cuda, page, lens, idle, bad):
        """The paged kernel splits each slot over its own live length through
        the block table and combines in the last block to finish: three
        launches on the same buffers, bitwise equal.  A table cell outside
        the pool reads as zeros."""
        args, want = _paged_case(cuda, page + len(lens) + sum(lens) % 97, page, lens, idle, bad)
        ops.reset_launches()
        _three_launches(lambda: ops.decode_attention_paged(*args), want, args[4] == 0)
        assert ops.LAUNCHES["decode_attention_paged"] == 3


def _paged_case(dev, seed, page, lens, idle=(), bad=(), Kv=4, G=8, dh=128):
    """Inputs of one paged case and the plain version's output: each live
    slot's blocks drawn from a shuffled pool, cells past its length on the
    trash block 0, ``idle`` slots' rows all trash, the free blocks poisoned
    (a read of one shows); ``bad`` (slot, cell, "past" or "negative") cells
    point outside the pool, and the plain version reads a zero block there."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B, max_blocks = 8, 1024 // page
    n_pool = B * max_blocks + 1
    q = _rnd(g, (B, Kv * G, dh), dev)
    pk, pv = (_rnd(g, (n_pool, page, Kv, dh), dev) for _ in range(2))
    order = torch.randperm(n_pool - 1, generator=g, device=dev).add(1).tolist()
    tab = torch.zeros((B, max_blocks), dtype=torch.int32)
    nxt = 0
    for b, n in enumerate(lens):
        if b in idle:
            continue  # idle slot: every cell is the trash block
        for j in range(min(max_blocks, -(-n // page))):
            tab[b, j] = order[nxt]
            nxt += 1
    used = set(tab.flatten().tolist())
    free = [b for b in range(1, n_pool) if b not in used]
    pk[free], pv[free] = 1e4, -1e4
    tab_ref = tab.clone()
    for b, c, kind in bad:
        tab[b, c] = n_pool + 7 if kind == "past" else -3
        tab_ref[b, c] = n_pool  # the plain version's zero block
    L = torch.tensor(lens, dtype=torch.int32, device=dev)
    tab = tab.to(dev)
    if bad:
        zero = torch.zeros((1, page, Kv, dh), dtype=BF, device=dev)
        want = ref.decode_attention_paged_ref(q, torch.cat([pk, zero]), torch.cat([pv, zero]),
                                              tab_ref.to(dev), L)
    else:
        want = ref.decode_attention_paged_ref(q, pk, pv, tab, L)
    return (q, pk, pv, tab, L), want


# (dh, Kv, G) of the head-dim instances and head groups beyond the
# qwen3-moe shape (dh 128, G 8): granite-3-2b, zamba2-7b's shared
# attention, qwen1.5-0.5b, qwen2-vl-7b, an MQA group of 32 heads (two head
# groups) and one of 20 (a partial second group)
_INSTANCES = {
    "dh64_g4": (64, 8, 4),
    "dh112_g1": (112, 32, 1),
    "dh64_g1": (64, 16, 1),
    "dh128_g7": (128, 4, 7),
    "dh128_g32": (128, 1, 32),
    "dh64_g20": (64, 2, 20),
}


@pytest.mark.cuda
class TestAttentionInstances:
    """Each head-dim instance and the head-group axis against the plain
    versions: three launches on the same buffers (tickets back at zero),
    bitwise equal, exact zeros on length-0 rows."""

    @pytest.mark.parametrize("case", list(_INSTANCES))
    @pytest.mark.parametrize("T,lens", [
        (1024, [145, 387, 201, 330, 260, 178, 299, 356]),  # serving lengths
        (1000, [0, 1, 63, 64, 65, 1000, 999, 500]),  # ragged tails, length 0, length T
    ], ids=["serving", "edges"])
    def test_dense(self, cuda, case, T, lens):
        dh, Kv, G = _INSTANCES[case]
        g = torch.Generator(device=cuda).manual_seed(dh + G + T)
        B = len(lens)
        q = _rnd(g, (B, Kv * G, dh), cuda)
        ck, cv = (_rnd(g, (B, T, Kv, dh), cuda) for _ in range(2))
        L = torch.tensor(lens, dtype=torch.int32, device=cuda)
        ops.reset_launches()
        _three_launches(lambda: ops.decode_attention(q, ck, cv, L), ref.decode_attention_ref(q, ck, cv, L),
                        L == 0)
        assert ops.LAUNCHES["decode_attention"] == 3

    @pytest.mark.parametrize("case", list(_INSTANCES))
    def test_split(self, cuda, case):
        dh, Kv, G = _INSTANCES[case]
        g = torch.Generator(device=cuda).manual_seed(7 * dh + G)
        B, T = 8, 4100
        q = _rnd(g, (B, Kv * G, dh), cuda)
        ck, cv = (_rnd(g, (B, T, Kv, dh), cuda) for _ in range(2))
        L = torch.tensor([0, 1, 32, 64, 65, T - 1, 1000, 2049], dtype=torch.int32, device=cuda)
        ops.reset_launches()
        _three_launches(lambda: ops.decode_attention(q, ck, cv, L, n_splits=4),
                        ref.decode_attention_split_ref(q, ck, cv, L, 4), L == 0)
        assert ops.LAUNCHES["decode_attention_split"] == 3
        torch.cuda.synchronize()
        rows = B * Kv * -(-G // 16)
        assert not ops._TICKETS[("decode_attention_split", q.device.index, rows)].any()

    @pytest.mark.parametrize("case", list(_INSTANCES))
    def test_paged(self, cuda, case):
        dh, Kv, G = _INSTANCES[case]
        lens = [1024, 0, 1, 17, 300, 16, 17, 640]
        args, want = _paged_case(cuda, dh + G, 16, lens, idle=(2,), Kv=Kv, G=G, dh=dh)
        ops.reset_launches()
        _three_launches(lambda: ops.decode_attention_paged(*args), want, args[4] == 0)
        assert ops.LAUNCHES["decode_attention_paged"] == 3

    @pytest.mark.parametrize("dh", [32, 96, 256])
    def test_other_head_dims_raise(self, cuda, dh):
        q = torch.zeros((1, 4, dh), dtype=BF, device=cuda)
        ck = torch.zeros((1, 16, 2, dh), dtype=BF, device=cuda)
        L = torch.ones((1,), dtype=torch.int32, device=cuda)
        with pytest.raises(ValueError, match=r"\(64, 112, 128\)"):
            ops.decode_attention(q, ck, ck, L)
        with pytest.raises(ValueError, match=r"\(64, 112, 128\)"):
            ops.decode_attention_paged(q, ck, ck, torch.zeros((1, 1), dtype=torch.int32, device=cuda), L)


def _ragged_case(dev, seed, sizes, bm, K, N, extra_tiles=0):
    """Inputs of one gmm_ragged case and the plain version's output, with
    the rows no live output reads (padding, and ``extra_tiles`` bm tiles
    past the spans) and the weights of groups with no live row at 1e4, so
    that a read of either shows."""
    g = torch.Generator(device=dev).manual_seed(seed)
    E = len(sizes)
    spans = [-(-n // bm) * bm for n in sizes]
    M = sum(spans) + extra_tiles * bm
    lhs = _rnd(g, (M, K), dev)
    rhs = _rnd(g, (E, K, N), dev, K**-0.5)
    start = 0
    live = torch.zeros((M,), dtype=torch.bool, device=dev)
    for n, span in zip(sizes, spans):
        live[start:start + n] = True
        start += span
    lhs[~live] = 1e4
    rhs[torch.tensor([n == 0 for n in sizes], device=dev)] = 1e4
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    return (lhs, rhs, gs, bm), ref.gmm_ragged_ref(lhs, rhs, gs, bm), ~live


@pytest.mark.cuda
class TestGmmRagged:
    @pytest.mark.parametrize("case", [
        # (sizes, bm, K, N, extra bm tiles past the spans)
        ([2, 0, 3, 1, 0, 0, 2, 1] * 16, 8, 2048, 768, 0),  # a decode step's routing, 128 groups
        ([40, 0, 129, 7, 0, 300, 1, 64], 128, 256, 192, 0),  # prefill-like, N % 128 != 0
        ([5, 0, 30, 24, 1], 24, 128, 128, 2),  # a bm that is no power of two; rows past the spans
        ([0, 0, 0, 0], 8, 64, 64, 3),  # every group empty
        ([70], 64, 192, 256, 1),  # one group over two bm tiles
    ], ids=["decode", "prefill", "bm24_past_spans", "all_empty", "one_group"])
    def test_against_plain(self, cuda, case):
        sizes, bm, K, N, extra = case
        args, want, dead = _ragged_case(cuda, sum(sizes) + bm, sizes, bm, K, N, extra)
        ops.reset_launches()
        _three_launches(lambda: ops.gmm_ragged(*args), want, dead)
        assert ops.LAUNCHES["gmm_ragged"] == 3

    def test_checks(self, cuda):
        lhs = torch.zeros((16, 64), dtype=BF, device=cuda)
        rhs = torch.zeros((2, 64, 64), dtype=BF, device=cuda)
        gs = torch.tensor([3, 5], dtype=torch.int32, device=cuda)
        with pytest.raises(ValueError, match="multiple of 8"):
            ops.gmm_ragged(lhs, rhs, gs, bm=12)
        with pytest.raises(ValueError, match="K % 64"):
            ops.gmm_ragged(lhs[:, :32].contiguous(), rhs[:, :32].contiguous(), gs, bm=8)


@pytest.mark.cuda
class TestRouterTies:
    def test_route_puts_the_lower_index_first(self, cuda):
        """Tied router probabilities on the card: the lower expert index
        comes first, as jax.lax.top_k orders them."""
        from repro_torch.configs import get_arch
        from repro_torch.models import moe

        cfg = get_arch("qwen3-moe-30b-a3b").moe  # 128 experts, top-8
        d, E = 16, cfg.n_experts
        g = torch.Generator(device=cuda).manual_seed(0)
        w = torch.randn((d, E), generator=g, device=cuda) * 0.1
        w[:, 5] = w[:, 77] = 3.0  # a two-way tie above every other expert
        x = torch.zeros((2, d), device=cuda)
        x[1] = 1.0  # row 0: all 128 probabilities equal
        r = moe.route(x, w, cfg)
        assert r.expert_idx[0].tolist() == list(range(8))
        assert r.expert_idx[1, :2].tolist() == [5, 77]


def _card_proxy():
    """The qwen3-moe proxy of the CPU tests with the head dim the attention
    kernels take (128; the proxy's 32 is refused on the card)."""
    import dataclasses

    from _torch_port import proxy_arch
    from repro_torch.configs import get_arch

    arch = proxy_arch(get_arch)
    return dataclasses.replace(arch, attn=dataclasses.replace(arch.attn, d_head=128))


def _full_width_slice():
    """qwen3-moe-30b-a3b at full width, cut to two layers."""
    import dataclasses

    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch("qwen3-moe-30b-a3b"), n_layers=2)


# (arch, prompt lengths, new tokens per request) of the compiled-step cases:
# three requests on two slots, so a slot retires and is re-admitted while
# the graph replays; the paged runs cross a page boundary mid-decode
_STEP_CASES = {
    "proxy": (_card_proxy, (14, 9, 21), (4, 12, 9)),
    "full_width_2_layers": (_full_width_slice, (30, 17, 45), (4, 12, 9)),
}


@pytest.mark.cuda
class TestCompiledDecodeStep:
    @pytest.mark.parametrize("model", list(_STEP_CASES))
    @pytest.mark.parametrize("path", ["dense_fused", "paged_three_call"])
    def test_replay_matches_eager(self, cuda, monkeypatch, model, path):
        """Two engines on the same weights and requests, one replaying the
        captured decode step and one eager (``_replay`` off), stepped side
        by side: the same greedy tokens, per-layer counts, drops and head and
        tail rows at every decode step; logits and KV caches within the bf16
        tolerance (and whether also bitwise equal, printed).  Midway both
        cost tables are pushed to a slow PIM, and the next ``SieveState``
        refresh between two replays must move every tail row to the head,
        as it does eagerly."""
        from repro_torch.models import LM, moe
        from repro_torch.serving import BatchingConfig, Request, ServingEngine

        monkeypatch.setenv("REPRO_FUSED_SWIGLU", "1" if path == "dense_fused" else "0")
        make_arch, prompt_lens, new_tokens = _STEP_CASES[model]
        arch = make_arch()
        batching = BatchingConfig(n_slots=2, max_seq=128, paged=path == "paged_three_call",
                                  page_size=16 if model == "full_width_2_layers" else 8)
        lm = LM(arch, dtype=BF, device="cuda")
        params = lm.init(seed=0)
        engines = [ServingEngine(lm, params, batching, sieve_refresh_every=2) for _ in range(2)]
        engines[0]._replay = False

        # head and tail rows per engine, summed on the card: the adds of the
        # replaying engine are captured into its graph and run on replay
        rows = torch.zeros((2, 2), dtype=torch.int64, device=cuda)
        cur = [0]
        head, tail = moe.head_stage, moe.tail_stage

        def head_stage(slab, wg, wu, wd, sizes):
            rows[cur[0], 0] += sizes.sum()
            return head(slab, wg, wu, wd, sizes)

        def tail_stage(toks, wg, wu, wd, eids, valid):
            rows[cur[0], 1] += valid.sum()
            return tail(toks, wg, wu, wd, eids, valid)

        monkeypatch.setattr(moe, "head_stage", head_stage)
        monkeypatch.setattr(moe, "tail_stage", tail_stage)
        steps = [[], []]  # per decode call: logits, counts, dropped, head/tail rows

        def recorded(i, fn):
            def run(batch):
                before = rows[i].clone()
                logits, aux = fn(batch)
                steps[i].append((logits.float().cpu(), aux.counts.cpu(), int(aux.dropped),
                                 (rows[i] - before).tolist()))
                return logits, aux
            return run

        for i, eng in enumerate(engines):
            eng._decode = recorded(i, eng._decode)
            for n, m in zip(prompt_lens, new_tokens):
                prompt = torch.randint(0, arch.vocab_size, (n,), generator=torch.Generator().manual_seed(n))
                eng.submit(Request(prompt=prompt.tolist(), max_new_tokens=m))
        forced_at = None
        caches_bitwise = logits_bitwise = True
        while not all(e.sched.idle for e in engines):
            n_decoded = len(steps[1])
            if forced_at is None and n_decoded >= 4:  # the graph has replayed
                forced_at = n_decoded
                for eng in engines:
                    for c in range(1, eng._sieve_max_count + 1):
                        eng.cost_table.update(c, 1.0)  # a PIM slower than any head
            for i, eng in enumerate(engines):
                cur[0] = i
                eng.step()
            for a, b in zip(engines[0].cache["blocks"], engines[1].cache["blocks"]):
                _close(b, a)
                caches_bitwise &= torch.equal(a, b)
        assert forced_at is not None and engines[1]._graph is not None
        assert len(steps[0]) == len(steps[1]) >= forced_at + 4
        for (le, ce, de, re), (lr, cr, dr, rr) in zip(*steps):
            assert torch.allclose(lr, le, **TOL), float((lr - le).abs().max())
            logits_bitwise &= torch.equal(lr, le)
            assert torch.equal(cr, ce) and dr == de and rr == re
        # the forced refresh lands at the next boundary, between replays
        assert engines[0].sieve_refreshes == engines[1].sieve_refreshes
        assert any(r[1] > 0 for *_, r in steps[1][:forced_at]), "no tail rows before the refresh"
        assert all(r[1] == 0 for *_, r in steps[1][forced_at + 2:]), "tail rows after the refresh"
        tokens = [[r.generated for r in sorted(e.sched.finished, key=lambda r: r.req_id)] for e in engines]
        assert tokens[0] == tokens[1] and [len(g) for g in tokens[1]] == list(new_tokens)
        if batching.paged:
            assert all(e.paged.n_free == e.paged.n_pool - 1 for e in engines)
        kernels = {"dense_fused": ("swiglu_gmm_capacity", "swiglu_gemv", "decode_attention"),
                   "paged_three_call": ("gmm_capacity", "expert_gemv", "decode_attention_paged")}[path]
        captured = engines[1]._graph_launches
        assert all(captured[k] > 0 for k in kernels)
        assert all(n == 0 for k, n in captured.items() if k not in kernels)
        print(f"\n{model} {path}: replayed against eager over {len(steps[1])} decode steps: "
              f"logits bitwise equal {logits_bitwise}, KV caches bitwise equal {caches_bitwise}")

    def test_replays_count_captured_launches(self, cuda):
        """A replay adds the captured launches to ``ops.LAUNCHES``; the
        capture itself adds none."""
        from repro_torch.models import LM
        from repro_torch.serving import BatchingConfig, Request, ServingEngine

        arch = _card_proxy()
        lm = LM(arch, dtype=BF, device="cuda")
        eng = ServingEngine(lm, lm.init(seed=0), BatchingConfig(n_slots=2, max_seq=64))
        eng.submit(Request(prompt=list(range(1, 11)), max_new_tokens=5))
        ops.reset_launches()
        eng.step()  # prefill, then the eager decode step and the capture
        after_first = dict(ops.LAUNCHES)
        assert eng._graph is not None
        for k, n in eng._graph_launches.items():
            assert 0 <= n <= after_first[k]
        eng.step()
        eng.step()
        for k, n in eng._graph_launches.items():
            assert ops.LAUNCHES[k] == after_first[k] + 2 * n
        assert eng._graph_launches["decode_attention"] == arch.n_layers


# (config, paged) of the dense and VLM decode-step cases: two full-width
# layers each; granite-3-2b runs the dh-64 instance, qwen2-vl-7b (dh 128,
# 7 query heads per kv head, QKV bias, untied head) M-RoPE positions as a
# decode input
_FAMILY_CASES = {
    "granite_3_2b_dense": ("granite-3-2b", False),
    "granite_3_2b_paged": ("granite-3-2b", True),
    "qwen2_vl_7b_dense": ("qwen2-vl-7b", False),
}


@pytest.mark.cuda
class TestFamilyDecodeStep:
    @pytest.mark.parametrize("case", list(_FAMILY_CASES))
    def test_replay_bitwise_equal_to_eager(self, cuda, case):
        """Two engines on the same weights and requests, one replaying its
        captured decode step and one eager, stepped side by side: the same
        tokens, and logits and KV caches bitwise equal at every step; one
        capture, holding one attention launch per layer and no MoE kernel."""
        import dataclasses

        from repro_torch.configs import get_arch
        from repro_torch.models import LM
        from repro_torch.serving import BatchingConfig, Request, ServingEngine

        name, paged = _FAMILY_CASES[case]
        arch = dataclasses.replace(get_arch(name), n_layers=2)
        lm = LM(arch, dtype=BF, device="cuda")
        params = lm.init(seed=0)
        batching = BatchingConfig(n_slots=2, max_seq=128, paged=paged, page_size=16)
        engines = [ServingEngine(lm, params, batching) for _ in range(2)]
        engines[0]._replay = False
        logits = [[], []]

        def recorded(i, fn):
            def run(batch):
                out = fn(batch)
                logits[i].append(out[0].float().cpu())
                return out
            return run

        new_tokens = (4, 12, 9)
        for i, eng in enumerate(engines):
            eng._decode = recorded(i, eng._decode)
            for n, m in zip((30, 17, 45), new_tokens):
                prompt = torch.randint(0, arch.vocab_size, (n,), generator=torch.Generator().manual_seed(n))
                eng.submit(Request(prompt=prompt.tolist(), max_new_tokens=m))
        while not all(e.sched.idle for e in engines):
            for eng in engines:
                eng.step()
            for a, b in zip(engines[0].cache["blocks"], engines[1].cache["blocks"]):
                assert torch.equal(a, b)
        assert len(logits[0]) == len(logits[1]) > 2
        assert all(torch.equal(a, b) for a, b in zip(*logits))
        tokens = [[r.generated for r in sorted(e.sched.finished, key=lambda r: r.req_id)] for e in engines]
        assert tokens[0] == tokens[1] and [len(g) for g in tokens[1]] == list(new_tokens)
        assert (engines[0].n_captures, engines[1].n_captures) == (0, 1)
        attn = "decode_attention_paged" if paged else "decode_attention"
        captured = engines[1]._graph_launches
        assert captured[attn] == arch.n_layers
        assert all(n == 0 for k, n in captured.items() if k != attn)


def _card_probe_time(slow: bool):
    """A deterministic probe "measurement" (pure in span name and value), so
    two engines on the card feed the same cost tables; ``slow``: every tail
    probe 16x slower (a PIM brownout)."""

    def hook(name, value, dt):
        if name == "stage/tail_gemv":
            return 1e-4 * (1 + 0.1 * (value - 1)) * (16 if slow else 1)
        return 1e-4

    return hook


_FAULT_STEPS = range(4, 10)  # the tail brownout
_BROWNOUT = {12: 2, 15: 0}  # step -> stage
_SNAP_AT, _RESTORE_AT = 8, 11
_RUNTIME_NEW_TOKENS = (6, 20, 12)  # three requests on two slots: about 20 steps


@pytest.mark.cuda
class TestRuntimeLoop:
    @pytest.mark.parametrize("path", ["dense_fused", "paged_three_call"])
    def test_fault_brownout_and_restore_keep_one_capture(self, cuda, monkeypatch, tmp_path, path):
        """Two measured engines on the 2-layer full-width slice run the same
        script: a tail brownout over steps 4-9 (quarantine, a GPU-only
        split, recovery), brownout stage 2 at step 12 and back at 15.  The
        second one snapshots at step 8, runs on to step 11 and restores the
        snapshot into its captured graph, then finishes: from step 8 on its
        logits equal the uninterrupted twin's bit for bit, and so do the
        final KV caches and tokens.  Each engine captured one graph, and the
        probes launched the path's head, tail and attention kernels."""
        from repro_torch.models import LM
        from repro_torch.serving import BatchingConfig, Request, ServingEngine
        from repro_torch.telemetry import Telemetry

        monkeypatch.setenv("REPRO_FUSED_SWIGLU", "1" if path == "dense_fused" else "0")
        kernels = {"dense_fused": ("swiglu_gmm_capacity", "swiglu_gemv", "decode_attention"),
                   "paged_three_call": ("gmm_capacity", "expert_gemv", "decode_attention_paged")}[path]
        arch = _full_width_slice()
        lm = LM(arch, dtype=BF, device="cuda")
        params = lm.init(seed=0)
        batching = BatchingConfig(n_slots=2, max_seq=128, paged=path == "paged_three_call", page_size=16)
        engines = [ServingEngine(lm, params, batching, sieve_refresh_every=2, cost_source="measured",
                                 telemetry=Telemetry(clock=lambda: 0)) for _ in range(2)]
        logits = [[], []]  # (step, logits) per decode call
        probe_launches = {k: 0 for k in ops.LAUNCHES}
        for i, eng in enumerate(engines):
            decode, run_probes = eng._decode, eng._run_probes

            def recorded(batch, i=i, eng=eng, decode=decode):
                out = decode(batch)
                logits[i].append((eng.stats.steps, out[0].float().cpu()))
                return out

            def counted(run_probes=run_probes):
                before = dict(ops.LAUNCHES)
                run_probes()
                for k in probe_launches:
                    probe_launches[k] += ops.LAUNCHES[k] - before[k]

            eng._decode, eng._run_probes = recorded, counted
            for n, m in zip((30, 17, 45), _RUNTIME_NEW_TOKENS):
                prompt = torch.randint(0, arch.vocab_size, (n,), generator=torch.Generator().manual_seed(n))
                eng.submit(Request(prompt=prompt.tolist(), max_new_tokens=m))
        trajectory = [[], []]

        def scripted_step(i):
            eng = engines[i]
            k = eng.stats.steps
            eng._probes.corrupt = _card_probe_time(k in _FAULT_STEPS)
            if k in _BROWNOUT:
                eng.set_brownout_stage(_BROWNOUT[k])
            eng.step()
            trajectory[i].append((k, eng.pim_healthy, eng._sieve_gpu_only))

        while not engines[0].sched.idle:
            scripted_step(0)
        twin, eng = engines
        while eng.stats.steps < _RESTORE_AT:
            scripted_step(1)
            if eng.stats.steps == _SNAP_AT:
                eng.snapshot(str(tmp_path))
        assert eng._graph is not None and eng.restore(str(tmp_path)) == _SNAP_AT
        restored_at = len(logits[1])
        while not eng.sched.idle:
            scripted_step(1)

        healthy = {k: h for k, h, _ in trajectory[0]}
        gpu_only = {k for k, _, g in trajectory[0] if g}
        last = max(healthy)
        assert not all(healthy[k] for k in _FAULT_STEPS) and healthy[last]
        assert set(range(12, 15)) <= gpu_only and last >= 16 and last not in gpu_only
        assert trajectory[1][_RESTORE_AT:] == trajectory[0][_SNAP_AT:]
        want = [(k, x) for k, x in logits[0] if k >= _SNAP_AT]
        got = logits[1][restored_at:]
        assert [k for k, _ in got] == [k for k, _ in want]
        assert all(torch.equal(x, y) for (_, x), (_, y) in zip(got, want))
        for a, b in zip(twin.cache["blocks"], eng.cache["blocks"]):
            assert torch.equal(a, b)

        def tokens(e):
            return [r.generated for r in sorted(e.sched.finished, key=lambda r: r.req_id)]

        assert tokens(eng) == tokens(twin) and [len(g) for g in tokens(twin)] == list(_RUNTIME_NEW_TOKENS)
        assert twin.n_captures == eng.n_captures == 1
        assert all(probe_launches[k] > 0 for k in kernels), probe_launches
        assert all(n == 0 for k, n in probe_launches.items() if k not in kernels), probe_launches
        print(f"\n{path}: fault at steps 4-9 GPU-only at {sorted(gpu_only)}; restored at step "
              f"{_RESTORE_AT} to {_SNAP_AT}, {len(got)} decode steps bitwise equal to the twin; "
              f"probe launches {probe_launches}")


# deepseek-v2-236b's MoE widths: 160 experts, top-6 of 8 decode tokens,
# K = N = d_model 5120, F = d_expert 1536; capacity 8 at decode (the
# min_capacity floor) and 24 for a 512-token prefill chunk
_DSV2 = dict(E=160, K=5120, F=1536, top_k=6)
_DSV2_C = {"decode": 8, "prefill_512": 24}


def _dsv2_sizes(phase: str):
    """Group sizes of one step at deepseek-v2's shapes: the decode step's
    head (experts with two or more of 8 tokens x top-6) or a 512-token
    prefill's ragged sizes up to its capacity."""
    import numpy as np

    E, C = _DSV2["E"], _DSV2_C[phase]
    rng = np.random.default_rng(C)
    if phase == "prefill_512":
        return rng.integers(0, C + 1, E).tolist()
    counts = np.zeros(E, np.int64)
    for _ in range(8):
        counts[rng.choice(E, size=_DSV2["top_k"], replace=False)] += 1
    return np.where(counts >= 2, counts, 0).tolist()


def _dsv2_tail_valid(dev):
    """One decode step's tail rows at deepseek-v2's shapes: the experts of
    8 tokens x top-6 that got exactly one token (about 37 of 160)."""
    import numpy as np

    rng = np.random.default_rng(1)
    counts = np.zeros(_DSV2["E"], np.int64)
    for _ in range(8):
        counts[rng.choice(_DSV2["E"], size=_DSV2["top_k"], replace=False)] += 1
    return torch.as_tensor((counts == 1).astype(np.int32), device=dev)


@pytest.mark.cuda
class TestDeepseekShapes:
    """The four MoE kernels of the deepseek-v2 serving path at its decode
    and 512-token-prefill shapes, each three launches on the same buffers
    against the plain version and bitwise equal from launch to launch."""

    @pytest.mark.parametrize("phase", list(_DSV2_C))
    def test_fused_head(self, cuda, phase):
        E, K, F = _DSV2["E"], _DSV2["K"], _DSV2["F"]
        sizes = _dsv2_sizes(phase)
        args, want, dead = _head_case(cuda, 7, E, E, _DSV2_C[phase], K, F, K, sizes)
        _three_launches(lambda: ops.swiglu_gmm_capacity(*args), want, dead)

    def test_fused_tail(self, cuda):
        E, K, F = _DSV2["E"], _DSV2["K"], _DSV2["F"]
        g = torch.Generator(device=cuda).manual_seed(8)
        toks = _rnd(g, (E, K), cuda)
        wg, wu = (_rnd(g, (E, K, F), cuda, K**-0.5) for _ in range(2))
        wd = _rnd(g, (E, F, K), cuda, F**-0.5)
        eids = torch.arange(E, dtype=torch.int32, device=cuda)
        valid = _dsv2_tail_valid(cuda)
        want = ref.fused_swiglu_gemv_ref(toks, wg, wu, wd, eids, valid)
        _three_launches(lambda: ops.swiglu_gemv(toks, wg, wu, wd, eids, valid), want, valid == 0)

    @pytest.mark.parametrize("phase", list(_DSV2_C))
    @pytest.mark.parametrize("call", ["gate", "down"])
    def test_gmm_capacity(self, cuda, phase, call):
        E, C = _DSV2["E"], _DSV2_C[phase]
        K, N = (_DSV2["K"], _DSV2["F"]) if call == "gate" else (_DSV2["F"], _DSV2["K"])
        g = torch.Generator(device=cuda).manual_seed(C + K)
        buf = _rnd(g, (E, C, K), cuda)
        rhs = _rnd(g, (E, K, N), cuda, K**-0.5)
        gs = torch.tensor(_dsv2_sizes(phase), dtype=torch.int32, device=cuda)
        dead = torch.arange(C, device=cuda)[None, :] >= gs[:, None]
        _three_launches(lambda: ops.gmm_capacity(buf, rhs, gs), ref.gmm_ref(buf, rhs, gs), dead)

    @pytest.mark.parametrize("call", ["gate", "down"])
    def test_expert_gemv(self, cuda, call):
        E = _DSV2["E"]
        K, N = (_DSV2["K"], _DSV2["F"]) if call == "gate" else (_DSV2["F"], _DSV2["K"])
        g = torch.Generator(device=cuda).manual_seed(K)
        toks = _rnd(g, (E, K), cuda)
        w = _rnd(g, (E, K, N), cuda, K**-0.5)
        eids = torch.arange(E, dtype=torch.int32, device=cuda)
        valid = _dsv2_tail_valid(cuda)
        want = ref.expert_gemv_ref(toks, w, eids, valid)
        _three_launches(lambda: ops.expert_gemv(toks, w, eids, valid), want, valid == 0)


@pytest.mark.cuda
class TestDeepseekDecodeStep:
    @pytest.mark.parametrize("fused", ["1", "0"])
    def test_replay_matches_eager(self, cuda, monkeypatch, fused):
        """deepseek-v2 at full width cut to two layers (the dense block and
        the first MoE block, MLA attention) on the Sieve dual path: an
        engine replaying its captured decode step and an eager one, stepped
        side by side, give the same tokens, counts and drops, logits and
        both cache groups within the bf16 tolerance (and whether bitwise
        equal, printed); one capture holding the path's two MoE kernels and
        no attention kernel."""
        import dataclasses

        from repro_torch.configs import get_arch
        from repro_torch.models import LM
        from repro_torch.serving import BatchingConfig, Request, ServingEngine

        monkeypatch.setenv("REPRO_FUSED_SWIGLU", fused)
        arch = get_arch("deepseek-v2-236b")
        arch = dataclasses.replace(arch, n_layers=2,
                                   moe=dataclasses.replace(arch.moe, expert_exec="dual_path_cost"))
        lm = LM(arch, dtype=BF, device="cuda")
        params = lm.init(seed=0)
        engines = [ServingEngine(lm, params, BatchingConfig(n_slots=2, max_seq=128), sieve_refresh_every=2)
                   for _ in range(2)]
        engines[0]._replay = False
        steps = [[], []]

        def recorded(i, fn):
            def run(batch):
                logits, aux = fn(batch)
                steps[i].append((logits.float().cpu(), aux.counts.cpu(), int(aux.dropped)))
                return logits, aux
            return run

        new_tokens = (4, 12, 9)
        for i, eng in enumerate(engines):
            eng._decode = recorded(i, eng._decode)
            for n, m in zip((30, 17, 45), new_tokens):
                prompt = torch.randint(0, arch.vocab_size, (n,), generator=torch.Generator().manual_seed(n))
                eng.submit(Request(prompt=prompt.tolist(), max_new_tokens=m))
        bitwise = True
        while not all(e.sched.idle for e in engines):
            for eng in engines:
                eng.step()
            for key in ("prefix", "blocks"):
                for a, b in zip(engines[0].cache[key], engines[1].cache[key]):
                    _close(b, a)
                    bitwise &= torch.equal(a, b)
        assert len(steps[0]) == len(steps[1]) > 2
        for (le, ce, de), (lr, cr, dr) in zip(*steps):
            assert torch.allclose(lr, le, **TOL), float((lr - le).abs().max())
            bitwise &= torch.equal(lr, le)
            assert ce.shape == (1, arch.moe.n_experts) and torch.equal(cr, ce) and dr == de
        tokens = [[r.generated for r in sorted(e.sched.finished, key=lambda r: r.req_id)] for e in engines]
        assert tokens[0] == tokens[1] and [len(g) for g in tokens[1]] == list(new_tokens)
        assert (engines[0].n_captures, engines[1].n_captures) == (0, 1)
        kernels = ("swiglu_gmm_capacity", "swiglu_gemv") if fused == "1" else ("gmm_capacity", "expert_gemv")
        captured = engines[1]._graph_launches
        assert all(captured[k] > 0 for k in kernels), captured
        assert all(n == 0 for k, n in captured.items() if k not in kernels), captured
        print(f"\ndeepseek-v2 2 layers, REPRO_FUSED_SWIGLU={fused}: replayed against eager over "
              f"{len(steps[1])} decode steps, logits and caches bitwise equal: {bitwise}")


def _decode_counts(seed: int, E: int, k: int, n_tok: int = 8):
    """A decode step's per-expert counts: ``n_tok`` tokens, each to ``k``
    distinct experts."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return np.bincount(np.concatenate([rng.choice(E, k, replace=False) for _ in range(n_tok)]),
                       minlength=E).astype(np.int32)


@pytest.mark.cuda
class TestSievePartition:
    @pytest.mark.parametrize("E,dims", [(128, (2048, 768, 8)), (160, (5120, 1536, 6))])
    def test_replayed_split_equals_host_sieve(self, cuda, E, dims):
        """``sieve_partition_torch`` and ``sieve_partition_dynamic``, greedy
        and argmin, captured once and replayed with new counts written in
        place: the GPU set equals the host ``sieve_schedule``'s on every
        count vector (a cost table fed by the DRAM-timing model)."""
        import numpy as np

        from repro_torch.core import cost_model as cm_mod
        from repro_torch.core.cost_table import CostTable
        from repro_torch.core.scheduler import sieve_schedule
        from repro_torch.core.scheduler_torch import (
            SieveParams, make_sieve_state, sieve_partition_dynamic, sieve_partition_torch,
        )
        from repro_torch.sim.dram import PimGemvModel

        d, f, k = dims
        cm = cm_mod.CostModel(system=cm_mod.b200_pim_system(),
                              layer=cm_mod.MoELayerSpec(d_model=d, d_ff=f, n_experts=E, top_k=k))
        table, pim = CostTable(fallback=cm.t_pim_gemv_roofline), PimGemvModel(cm.system.pim)
        batches = [_decode_counts(s, E, k) for s in range(24)]
        for c in batches:
            for n in c[c > 0]:
                table.update(int(n), pim.expert_time(cm.layer, int(n)))
        state = make_sieve_state(table, cm, 1024, device=cuda)
        params = SieveParams.from_cost_model(cm, 0)
        counts = torch.zeros((E,), dtype=torch.int32, device=cuda)
        for mode in ("greedy", "argmin"):
            for call in (lambda: sieve_partition_torch(counts, state.pim_time_by_count, params, mode),
                         lambda: sieve_partition_dynamic(counts, *state, mode)):
                call()
                torch.cuda.synchronize()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    res = call()
                for c in batches:
                    counts.copy_(torch.as_tensor(c))
                    graph.replay()
                    host = sieve_schedule(c, cm, table, mode=mode)
                    assert int(res["split"]) == host.meta["split"]
                    got = np.nonzero(res["gpu_mask"].cpu().numpy())[0]
                    assert set(got.tolist()) == set(host.gpu_experts.tolist())


@pytest.mark.cuda
class TestEngineChaos:
    def test_scenarios_detect_clamp_and_restore(self, cuda):
        """``run_engine_chaos`` on the card (bf16, the proxy widened to the
        kernels' smallest instances) under tests/test_faults.py's checks,
        with one capture throughout."""
        from repro_torch.faults import ENGINE_SCENARIOS, run_engine_chaos

        control = run_engine_chaos("pim-brownout-engine", n_steps=28, seed=0, refresh=4, magnitude=1.0)
        assert control["gpu_only_step"] is None
        for scenario in ENGINE_SCENARIOS:
            r = run_engine_chaos(scenario, n_steps=28, seed=0, refresh=4)
            assert r["gpu_only_step"] is not None and r["gpu_only_step"] - r["fault_t"] <= 4
            assert r["cache_at_end"] == 1 and r["cache_misses_after_fault"] == 0
            assert r["recover_step"] is not None and r["restored"]
            assert all(rec["quarantined"] == rec["gpu_only"] for rec in r["trajectory"])
            if scenario == "probe-poison":
                assert r["feed_rejected"] > 0
            else:
                assert r["tokens"] == control["tokens"]
