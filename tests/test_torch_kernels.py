"""The port's kernel wrappers and plain versions against the JAX Pallas
kernels run in interpret mode (as tests/test_kernels.py runs them).

On the CPU each wrapper runs its kernel's plain version, so these tests
hold the plain versions to the TPU kernels, edge cases included.  The
CUDA kernels themselves run only on the card (tests/test_torch_cuda.py
and chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from _torch_port import assert_close, pin_threads, t

pin_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


def _weights(rng, E, K, F, N):
    return (
        (rng.standard_normal((E, K, F)) * 0.1).astype(np.float32),
        (rng.standard_normal((E, K, F)) * 0.1).astype(np.float32),
        (rng.standard_normal((E, F, N)) * 0.1).astype(np.float32),
    )


class TestSwigluGmmCapacity:
    @pytest.mark.parametrize(
        "sizes",
        [
            [12, 0, 5, 1],  # ragged groups
            [0, 0, 0, 0],  # every group dead
            [12, 12, 12, 12],  # every row live
        ],
    )
    def test_matches_pallas_interpret(self, sizes):
        E, C, K, F, N = 4, 12, 64, 64, 64
        rng = np.random.default_rng(0)
        buf = rng.standard_normal((E, C, K)).astype(np.float32)
        wg, wu, wd = _weights(rng, E, K, F, N)
        gs = np.asarray(sizes, np.int32)
        want = jops.swiglu_gmm_capacity(
            jnp.asarray(buf), jnp.asarray(wg), jnp.asarray(wu), jnp.asarray(wd),
            jnp.asarray(gs), bm=8, bk=32, bf=32, interpret=True,
        )
        got = ops.swiglu_gmm_capacity(t(buf), t(wg), t(wu), t(wd), t(gs))
        assert_close(got, want)
        dead = np.arange(C)[None, :] >= gs[:, None]
        assert (got.numpy()[dead] == 0).all()  # exact zeros past the size

    def test_rhs_of_group_matches_pallas(self):
        E, G, C, K, F, N = 3, 4, 8, 32, 32, 32
        rng = np.random.default_rng(1)
        buf = rng.standard_normal((G, C, K)).astype(np.float32)
        wg, wu, wd = _weights(rng, E, K, F, N)
        gs = np.asarray([8, 3, 0, 6], np.int32)
        rhs = np.asarray([2, 0, 1, 2], np.int32)
        want = jops.swiglu_gmm_capacity(
            jnp.asarray(buf), jnp.asarray(wg), jnp.asarray(wu), jnp.asarray(wd),
            jnp.asarray(gs), rhs_of_group=jnp.asarray(rhs), bm=8, bk=32, bf=32,
            interpret=True,
        )
        got = ops.swiglu_gmm_capacity(t(buf), t(wg), t(wu), t(wd), t(gs), t(rhs))
        assert_close(got, want)

    def test_bf16_casts_silu_product_like_the_tpu_kernel(self):
        """In bf16 the SiLU product is rounded to bf16 before the down
        product (repro/kernels/fused_swiglu.py:117); the plain version must
        match the Pallas kernel at the repo's bf16 tolerance."""
        E, C, K, F, N = 2, 8, 64, 64, 64
        rng = np.random.default_rng(2)
        buf = rng.standard_normal((E, C, K)).astype(np.float32)
        wg, wu, wd = _weights(rng, E, K, F, N)
        gs = np.asarray([8, 3], np.int32)
        bf = jnp.bfloat16
        want = jops.swiglu_gmm_capacity(
            jnp.asarray(buf, bf), jnp.asarray(wg, bf), jnp.asarray(wu, bf),
            jnp.asarray(wd, bf), jnp.asarray(gs), bm=8, bk=32, bf=32, interpret=True,
        )
        tb = torch.bfloat16
        got = ops.swiglu_gmm_capacity(
            t(buf).to(tb), t(wg).to(tb), t(wu).to(tb), t(wd).to(tb), t(gs)
        )
        assert got.dtype == tb
        # the repo's bf16 tolerance (tests/test_fused_swiglu.py:50): both sides
        # round the SiLU product to bf16 but sum in other orders first
        assert_close(got, np.asarray(want, np.float32), rtol=2e-2, atol=2e-2)


class TestSwigluGemv:
    @pytest.mark.parametrize(
        "valid", [[1, 0, 1, 1, 0, 1], [0] * 6, [1] * 6], ids=["mixed", "all_dead", "all_live"]
    )
    def test_matches_pallas_interpret(self, valid):
        E, S, K, F, N = 4, 6, 64, 64, 32
        rng = np.random.default_rng(3)
        toks = rng.standard_normal((S, K)).astype(np.float32)
        wg, wu, wd = _weights(rng, E, K, F, N)
        eids = np.asarray([3, 0, 1, 3, 2, 2], np.int32)
        v = np.asarray(valid, np.int32)
        want = jops.swiglu_gemv(
            jnp.asarray(toks), jnp.asarray(wg), jnp.asarray(wu), jnp.asarray(wd),
            jnp.asarray(eids), jnp.asarray(v), bk=32, bf=32, interpret=True,
        )
        got = ops.swiglu_gemv(t(toks), t(wg), t(wu), t(wd), t(eids), t(v))
        assert_close(got, want)
        assert (got.numpy()[v == 0] == 0).all()  # exact zeros on dead rows

    def test_valid_defaults_to_all_rows(self):
        E, S, K, F, N = 2, 3, 32, 32, 32
        rng = np.random.default_rng(4)
        toks = rng.standard_normal((S, K)).astype(np.float32)
        wg, wu, wd = _weights(rng, E, K, F, N)
        eids = np.asarray([1, 0, 1], np.int32)
        want = jops.swiglu_gemv(
            jnp.asarray(toks), jnp.asarray(wg), jnp.asarray(wu), jnp.asarray(wd),
            jnp.asarray(eids), None, bk=32, bf=32, interpret=True,
        )
        assert_close(ops.swiglu_gemv(t(toks), t(wg), t(wu), t(wd), t(eids)), want)

    def test_all_to_all_layout(self):
        """The expert-parallel all-to-all layout: each local expert's rows
        come as one segment per source rank, ``expert_ids``
        repeat_interleaved over the segments, most rows dead and the live
        ones sharing experts."""
        E, ep, K, F, N = 4, 4, 64, 64, 32
        S = E * ep
        rng = np.random.default_rng(6)
        toks = rng.standard_normal((S, K)).astype(np.float32)
        wg, wu, wd = _weights(rng, E, K, F, N)
        eids = np.repeat(np.arange(E, dtype=np.int32), ep)
        v = np.zeros(S, np.int32)
        v[[0, 2, 3, 9, 13]] = 1  # 5 live rows of 3 experts
        want = jops.swiglu_gemv(
            jnp.asarray(toks), jnp.asarray(wg), jnp.asarray(wu), jnp.asarray(wd),
            jnp.asarray(eids), jnp.asarray(v), bk=32, bf=32, interpret=True,
        )
        got = ops.swiglu_gemv(t(toks), t(wg), t(wu), t(wd), t(eids), t(v))
        assert_close(got, want)
        assert (got.numpy()[v == 0] == 0).all()

    def test_every_row_on_one_expert(self):
        E, S, K, F, N = 3, 40, 64, 64, 32
        rng = np.random.default_rng(7)
        toks = rng.standard_normal((S, K)).astype(np.float32)
        wg, wu, wd = _weights(rng, E, K, F, N)
        eids = np.full(S, 1, np.int32)
        v = np.ones(S, np.int32)
        want = jops.swiglu_gemv(
            jnp.asarray(toks), jnp.asarray(wg), jnp.asarray(wu), jnp.asarray(wd),
            jnp.asarray(eids), jnp.asarray(v), bk=32, bf=32, interpret=True,
        )
        assert_close(ops.swiglu_gemv(t(toks), t(wg), t(wu), t(wd), t(eids), t(v)), want)

    def test_strided_rows(self):
        """The tail path passes ``buf[:, :1]`` rows of the capacity slab."""
        E, C, K, F, N = 3, 4, 32, 32, 32
        rng = np.random.default_rng(5)
        slab = t(rng.standard_normal((E, C, K)).astype(np.float32))
        wg, wu, wd = (t(w) for w in _weights(rng, E, K, F, N))
        eids = torch.arange(E, dtype=torch.int32)
        valid = torch.tensor([1, 0, 1], dtype=torch.int32)
        got = ops.swiglu_gemv(slab[:, :1].reshape(E, K), wg, wu, wd, eids, valid)
        want = ops.swiglu_gemv(slab[:, 0].contiguous(), wg, wu, wd, eids, valid)
        assert torch.equal(got, want)


class TestDecodeAttention:
    @pytest.mark.parametrize(
        "T,bt,lens",
        [
            (32, 8, [32, 17, 1, 9]),  # full, mid-tile, single position
            (30, 8, [30, 29, 0, 7]),  # ragged T % bt tail and a length-0 row
            (16, 16, [0, 0, 0, 0]),  # every row empty
        ],
    )
    def test_matches_pallas_interpret(self, T, bt, lens):
        B, Kv, G, dh = 4, 2, 4, 32
        rng = np.random.default_rng(6)
        q = rng.standard_normal((B, Kv * G, dh)).astype(np.float32)
        ck = rng.standard_normal((B, T, Kv, dh)).astype(np.float32)
        cv = rng.standard_normal((B, T, Kv, dh)).astype(np.float32)
        L = np.asarray(lens, np.int32)
        want = jops.decode_attention(
            jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(L),
            bt=bt, interpret=True,
        )
        got = ops.decode_attention(t(q), t(ck), t(cv), t(L))
        assert_close(got, want)
        assert (got.numpy()[L == 0] == 0).all()  # exact zeros, not a uniform mean


class TestGmmCapacity:
    @pytest.mark.parametrize(
        "sizes,rhs_of_group",
        [
            ([12, 0, 5, 1], None),  # ragged groups, one dead
            ([0, 0, 0, 0], None),  # every group dead
            ([12, 3, 0, 6], [2, 0, 1, 2]),  # groups sharing weights
        ],
        ids=["ragged", "all_dead", "rhs_of_group"],
    )
    def test_matches_pallas_interpret(self, sizes, rhs_of_group):
        G, E, C, K, N = 4, 3, 12, 64, 32
        rng = np.random.default_rng(9)
        buf = rng.standard_normal((G, C, K)).astype(np.float32)
        rhs = (rng.standard_normal((E if rhs_of_group else G, K, N)) * 0.1).astype(np.float32)
        gs = np.asarray(sizes, np.int32)
        rog = None if rhs_of_group is None else np.asarray(rhs_of_group, np.int32)
        want = jops.gmm_capacity(
            jnp.asarray(buf), jnp.asarray(rhs), jnp.asarray(gs), bm=8, bk=32, bn=32,
            interpret=True, rhs_of_group=None if rog is None else jnp.asarray(rog),
        )
        got = ops.gmm_capacity(t(buf), t(rhs), t(gs), None if rog is None else t(rog))
        assert_close(got, want)
        dead = np.arange(C)[None, :] >= gs[:, None]
        assert (got.numpy()[dead] == 0).all()  # exact zeros past the size


class TestExpertGemv:
    @pytest.mark.parametrize("valid", [[1, 0, 1, 1, 0, 1], None], ids=["mixed", "default_all_live"])
    def test_matches_pallas_interpret(self, valid):
        E, S, K, N = 4, 6, 64, 32
        rng = np.random.default_rng(10)
        toks = rng.standard_normal((S, K)).astype(np.float32)
        w = (rng.standard_normal((E, K, N)) * 0.1).astype(np.float32)
        eids = np.asarray([3, 0, 1, 3, 2, 2], np.int32)
        v = None if valid is None else np.asarray(valid, np.int32)
        want = jops.expert_gemv(
            jnp.asarray(toks), jnp.asarray(w), jnp.asarray(eids),
            None if v is None else jnp.asarray(v), bk=32, bn=32, interpret=True,
        )
        got = ops.expert_gemv(t(toks), t(w), t(eids), None if v is None else t(v))
        assert_close(got, want)
        if v is not None:
            assert (got.numpy()[v == 0] == 0).all()


class TestDecodeAttentionSplit:
    @pytest.mark.parametrize("n_splits", [2, 3, 8])
    def test_matches_pallas_interpret(self, n_splits):
        """Lengths leave the later splits of most rows empty (lse at
        NEG_INF, zero weight) and one row has no live position at all."""
        B, Kv, G, dh, T = 5, 2, 4, 32, 200
        rng = np.random.default_rng(11)
        q = rng.standard_normal((B, Kv * G, dh)).astype(np.float32)
        ck = rng.standard_normal((B, T, Kv, dh)).astype(np.float32)
        cv = rng.standard_normal((B, T, Kv, dh)).astype(np.float32)
        L = np.asarray([0, 1, 63, 130, 200], np.int32)
        want = jops.decode_attention(
            jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(L),
            bt=16, n_splits=n_splits, interpret=True,
        )
        got = ops.decode_attention(t(q), t(ck), t(cv), t(L), n_splits=n_splits)
        assert_close(got, want)
        assert (got.numpy()[0] == 0).all()  # length 0: exact zeros

    def test_partials_mark_empty_splits(self):
        B, Kv, G, dh, T = 2, 1, 2, 16, 256
        rng = np.random.default_rng(12)
        q = t(rng.standard_normal((B, Kv * G, dh)).astype(np.float32))
        ck = t(rng.standard_normal((B, T, Kv, dh)).astype(np.float32))
        L = torch.tensor([70, 0], dtype=torch.int32)
        assert ref.split_span(T, 8) == (4, 64) and ref.split_span(T, 3) == (3, 128)
        out_p, lse = ref.decode_attention_split_partials(q, ck, ck, L, 4)
        assert out_p.shape == (B, Kv, 4, G, dh) and lse.shape == (B, Kv, 4, G)
        assert (lse[0, :, :2] > ref.NEG_INF).all() and (lse[0, :, 2:] == ref.NEG_INF).all()
        assert (lse[1] == ref.NEG_INF).all() and (out_p[1] == 0).all()


class TestDecodeAttentionPaged:
    def test_matches_pallas_interpret(self):
        """Page 8, shuffled blocks, trash cells past each length, an idle
        slot of length 1 on the trash block and a length-0 slot."""
        B, Kv, G, dh, page, nb = 5, 2, 4, 32, 8, 4
        rng = np.random.default_rng(13)
        n_pool = B * nb + 1
        pk = rng.standard_normal((n_pool, page, Kv, dh)).astype(np.float32)
        pv = rng.standard_normal((n_pool, page, Kv, dh)).astype(np.float32)
        q = rng.standard_normal((B, Kv * G, dh)).astype(np.float32)
        lens = np.asarray([0, 5, 8, 29, 1], np.int32)
        order = rng.permutation(np.arange(1, n_pool))
        tab = np.zeros((B, nb), np.int32)
        nxt = 0
        for b in range(B - 1):  # the last slot is idle: all trash cells
            for j in range(-(-int(lens[b]) // page)):
                tab[b, j] = order[nxt]
                nxt += 1
        want = jops.decode_attention_paged(
            jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(tab),
            jnp.asarray(lens), interpret=True,
        )
        got = ops.decode_attention_paged(t(q), t(pk), t(pv), t(tab), t(lens))
        assert_close(got, want)
        assert (got.numpy()[0] == 0).all()


class TestWrapperDispatch:
    def test_launch_counters_untouched_on_cpu(self):
        ops.reset_launches()
        rng = np.random.default_rng(8)
        q = t(rng.standard_normal((1, 2, 8)).astype(np.float32))
        ck = t(rng.standard_normal((1, 4, 1, 8)).astype(np.float32))
        one = torch.tensor([3], dtype=torch.int32)
        ops.decode_attention(q, ck, ck, one)
        ops.decode_attention(q, ck, ck, one, n_splits=2)
        ops.decode_attention_paged(q, ck, ck, torch.zeros((1, 1), dtype=torch.int32), one)
        w = t(rng.standard_normal((1, 8, 8)).astype(np.float32))
        ops.gmm_capacity(q.reshape(1, 2, 8), w, torch.tensor([1], dtype=torch.int32))
        ops.expert_gemv(q[0], w, torch.zeros(2, dtype=torch.int32))
        ops.gmm_ragged(torch.zeros((8, 8)), w, torch.tensor([1], dtype=torch.int32), bm=8)
        assert set(ops.LAUNCHES) == {
            "swiglu_gmm_capacity", "swiglu_gemv", "decode_attention", "decode_attention_split",
            "decode_attention_paged", "gmm_capacity", "gmm_ragged", "expert_gemv",
        }
        assert all(n == 0 for n in ops.LAUNCHES.values())

    def test_mixed_devices_raise(self):
        q = torch.zeros((1, 2, 8))
        with pytest.raises(ValueError, match="mixed or unsupported"):
            ops.decode_attention(q, torch.zeros((1, 4, 1, 8), device="meta"),
                                 torch.zeros((1, 4, 1, 8)), torch.ones(1, dtype=torch.int32))
