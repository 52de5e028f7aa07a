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

    @pytest.mark.parametrize("page", [8, 16])
    def test_paged(self, cuda, page):
        """Shuffled pool blocks, trash cells past each length, an idle slot
        of length 1 on the trash block, a length-0 slot, and poisoned free
        blocks that no slot may read."""
        g = torch.Generator(device=cuda).manual_seed(page)
        B, Kv, G, dh, max_blocks = 8, 4, 8, 128, 1024 // page
        n_pool = B * max_blocks + 1
        q = _rnd(g, (B, Kv * G, dh), cuda)
        pk, pv = (_rnd(g, (n_pool, page, Kv, dh), cuda) for _ in range(2))
        lens = [1024, 0, 1, 17, 300, page, page + 1, 640]
        order = torch.randperm(n_pool - 1, generator=g, device=cuda).add(1).tolist()
        tab = torch.zeros((B, max_blocks), dtype=torch.int32)
        nxt = 0
        for b, n in enumerate(lens):
            if b == 2:
                continue  # idle slot: every cell is the trash block
            for j in range(-(-n // page)):
                tab[b, j] = order[nxt]
                nxt += 1
        used = set(tab.flatten().tolist())
        free = [b for b in range(1, n_pool) if b not in used]
        pk[free], pv[free] = 1e4, -1e4  # poison: a read of a free block shows
        tab = tab.to(cuda)
        L = torch.tensor(lens, dtype=torch.int32, device=cuda)
        got = ops.decode_attention_paged(q, pk, pv, tab, L)
        _close(got, ref.decode_attention_paged_ref(q, pk, pv, tab, L))
        assert (got[1] == 0).all()
