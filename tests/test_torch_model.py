"""The port's layers, attention and LM against the JAX reference on the
qwen3-moe proxy, with the JAX weights crossing through
``repro_torch.bridge.params_from_numpy``."""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_port import assert_close, pin_threads, proxy_arch, t

pin_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.models import attention as jattn, layers as jlayers  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_arch as tget  # noqa: E402
from repro_torch.models import LM as TLM  # noqa: E402
from repro_torch.models import attention as tattn, layers as tlayers  # noqa: E402


def _pair(mode="dual_path_cost", dense=False, seed=0):
    ja, ta = proxy_arch(jget, mode), proxy_arch(tget, mode)
    if dense:
        ja = dataclasses.replace(ja, family="dense", moe=None, d_ff=96)
        ta = dataclasses.replace(ta, family="dense", moe=None, d_ff=96)
    jlm = JLM(ja, dtype=jnp.float32)
    jp = jlm.init(jax.random.PRNGKey(seed))
    tlm = TLM(ta, dtype=torch.float32, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.float32)
    return jlm, jp, tlm, tp


class TestLayers:
    def test_rmsnorm_and_rope(self):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
        scale = rng.random(32).astype(np.float32)
        assert_close(
            tlayers.apply_norm({"scale": t(scale)}, t(x), "rmsnorm"),
            jlayers.apply_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x), "rmsnorm"),
        )
        pos = rng.integers(0, 900, (2, 5)).astype(np.int32)
        assert_close(
            tlayers.apply_rope(t(x), t(pos), 1e6),
            jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6),
        )
        assert_close(tlayers.rope_freqs(32, 1e6), jlayers.rope_freqs(32, 1e6))

    @pytest.mark.parametrize("q_chunk,kv_chunk,q_offset", [(32, 32, 0), (8, 8, 0), (16, 8, 16)])
    def test_flash_attention(self, q_chunk, kv_chunk, q_offset):
        rng = np.random.default_rng(1)
        q = rng.standard_normal((2, 32, 4, 16)).astype(np.float32)
        k = rng.standard_normal((2, 32 + q_offset, 2, 16)).astype(np.float32)
        v = rng.standard_normal((2, 32 + q_offset, 2, 16)).astype(np.float32)
        kw = dict(causal=True, q_chunk=q_chunk, kv_chunk=kv_chunk, q_offset=q_offset)
        assert_close(
            tattn.flash_attention(t(q), t(k), t(v), **kw),
            jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw),
        )

    def test_decode_attention_ref(self):
        rng = np.random.default_rng(4)
        q = rng.standard_normal((3, 1, 4, 16)).astype(np.float32)
        ck = rng.standard_normal((3, 10, 2, 16)).astype(np.float32)
        cv = rng.standard_normal((3, 10, 2, 16)).astype(np.float32)
        L = np.asarray([10, 1, 6], np.int32)
        assert_close(
            tattn.decode_attention_ref(t(q), t(ck), t(cv), t(L)),
            jattn.decode_attention_ref(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(L)),
        )

    def test_gqa_decode_writes_cache_in_place(self):
        cfg_j, cfg_t = proxy_arch(jget).attn, proxy_arch(tget).attn
        d, B, T = 128, 3, 16
        rng = np.random.default_rng(2)
        p = {n: (rng.standard_normal(s) * d**-0.5).astype(np.float32) for n, s in (
            ("wq", (d, 128)), ("wk", (d, 64)), ("wv", (d, 64)), ("wo", (128, d)))}
        x = rng.standard_normal((B, 1, d)).astype(np.float32)
        ck = rng.standard_normal((B, T, 2, 32)).astype(np.float32)
        cv = rng.standard_normal((B, T, 2, 32)).astype(np.float32)
        pos = np.asarray([0, 7, 15], np.int32)
        jy, jk, jv = jattn.gqa_decode(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jnp.asarray(pos),
            jnp.asarray(ck), jnp.asarray(cv), cfg_j,
        )
        tk, tv = t(ck.copy()), t(cv.copy())
        ty = tattn.gqa_decode({k: t(v) for k, v in p.items()}, t(x), t(pos), tk, tv, cfg_t)
        assert_close(ty, jy)
        assert_close(tk, jk)
        assert_close(tv, jv)


def _pool(rng, B, nb, page, Kv, dh, lens):
    """A shuffled block pool with each slot's first ceil(len/page) blocks
    allocated (block 0 is trash) and the owner / block_pos it implies."""
    n_pool = B * nb + 1
    pk = rng.standard_normal((n_pool, page, Kv, dh)).astype(np.float32)
    pv = rng.standard_normal((n_pool, page, Kv, dh)).astype(np.float32)
    order = rng.permutation(np.arange(1, n_pool))
    tab = np.zeros((B, nb), np.int32)
    owner = np.full((n_pool,), -1, np.int32)
    bpos = np.zeros((n_pool,), np.int32)
    nxt = 0
    for b, n in enumerate(lens):
        for j in range(-(-int(n) // page)):
            tab[b, j] = order[nxt]
            owner[order[nxt]], bpos[order[nxt]] = b, j
            nxt += 1
    return pk, pv, tab, owner, bpos


class TestPagedAttention:
    def test_ref_and_pool_major_twin_match_jax(self):
        B, Kv, G, dh, page, nb = 4, 2, 2, 16, 8, 4
        rng = np.random.default_rng(5)
        lens = np.asarray([0, 5, 8, 29], np.int32)
        pk, pv, tab, owner, bpos = _pool(rng, B, nb, page, Kv, dh, lens)
        q = rng.standard_normal((B, 1, Kv * G, dh)).astype(np.float32)
        J = jnp.asarray
        got = tattn.paged_decode_attention_ref(t(q), t(pk), t(pv), t(tab), t(lens))
        want = jattn.paged_decode_attention_ref(J(q), J(pk), J(pv), J(tab), J(lens))
        # a length-0 row is exact zeros, as in the TPU kernel; the JAX oracle
        # gives a uniform mean there (kernels/ref.py docstring)
        assert_close(got[1:], np.asarray(want)[1:])
        assert (got[0] == 0).all()
        want = jattn.paged_decode_attention_xla(J(q), J(pk), J(pv), J(owner), J(bpos), J(lens))
        got = tattn.paged_decode_attention_xla(t(q), t(pk), t(pv), t(owner), t(bpos), t(lens))
        assert_close(got, want)

    def test_gqa_decode_paged_writes_pool_in_place(self, monkeypatch):
        """Slot 3 is idle (position 0, an all-trash table row): its write
        lands in the trash block and no live row changes.  The idle slot
        then attends over its trash row, as the TPU kernel and the JAX
        oracle do (the JAX pool-major twin gives it zeros), so JAX runs its
        oracle here."""
        monkeypatch.setenv("REPRO_FLASH_DECODE", "0")
        cfg_j, cfg_t = proxy_arch(jget).attn, proxy_arch(tget).attn
        d, B, page, nb = 128, 4, 8, 4
        rng = np.random.default_rng(6)
        p = {n: (rng.standard_normal(s) * d**-0.5).astype(np.float32) for n, s in (
            ("wq", (d, 128)), ("wk", (d, 64)), ("wv", (d, 64)), ("wo", (128, d)))}
        pos = np.asarray([0, 7, 16, 0], np.int32)
        pk, pv, tab, owner, bpos = _pool(rng, B, nb, page, 2, 32, [1, 8, 17, 0])
        x = rng.standard_normal((B, 1, d)).astype(np.float32)
        J = jnp.asarray
        jy, jk, jv = jattn.gqa_decode_paged(
            {k: J(v) for k, v in p.items()}, J(x), J(pos), J(pk), J(pv),
            (J(tab), J(owner), J(bpos)), cfg_j,
        )
        tk, tv = t(pk.copy()), t(pv.copy())
        ty = tattn.gqa_decode_paged(
            {k: t(v) for k, v in p.items()}, t(x), t(pos), tk, tv, (t(tab), t(owner), t(bpos)), cfg_t,
        )
        assert_close(ty, jy)
        live = np.arange(1, pk.shape[0])  # the trash block takes two writes in any order
        assert_close(tk[live], np.asarray(jk)[live])
        assert_close(tv[live], np.asarray(jv)[live])
        assert not np.allclose(tk.numpy()[tab[1, 0], 7], pk[tab[1, 0], 7])  # the new row landed


class TestLM:
    @pytest.mark.parametrize("mode", ["dual_path_cost", "dense_family"])
    def test_prefill_and_decode_match_jax(self, mode):
        dense = mode == "dense_family"
        jlm, jp, tlm, tp = _pair("dual_path_cost", dense=dense)
        rng = np.random.default_rng(3)
        toks = rng.integers(0, 512, (1, 24)).astype(np.int32)
        jl, jc, jaux = jlm.prefill(jp, {"tokens": jnp.asarray(toks)})
        tl, tc, taux = tlm.prefill(tp, {"tokens": t(toks).long()})
        assert_close(tl, jl)
        for a, b in zip(tc["blocks"], jc["blocks"]):
            assert_close(a, b)
        np.testing.assert_array_equal(np.asarray(jaux.counts), taux.counts.numpy())
        assert int(jaux.dropped) == int(taux.dropped)

        B, T = 3, 32
        kv = rng.standard_normal((2, B, T, 2, 32)).astype(np.float32)
        jcache = {"blocks": (jnp.asarray(kv), jnp.asarray(kv * 0.5))}
        tcache = {"blocks": (t(kv.copy()), t(kv * 0.5))}
        tok = rng.integers(0, 512, (B, 1)).astype(np.int32)
        pos = np.asarray([5, 0, 17], np.int32)
        jl, jnc, jaux = jlm.decode_step(jp, {"tokens": jnp.asarray(tok), "position": jnp.asarray(pos)}, jcache)
        tl, tnc, taux = tlm.decode_step(tp, {"tokens": t(tok).long(), "position": t(pos)}, tcache)
        assert tnc is tcache  # updated in place
        assert_close(tl, jl)
        for a, b in zip(tnc["blocks"], jnc["blocks"]):
            assert_close(a, b)
        np.testing.assert_array_equal(np.asarray(jaux.counts), taux.counts.numpy())
        assert int(jaux.dropped) == int(taux.dropped)
        assert_close(taux.moe_aux, jaux.moe_aux)

    def test_paged_decode_matches_jax(self):
        jlm, jp, tlm, tp = _pair("dual_path_cost")
        rng = np.random.default_rng(7)
        B, page, nb = 3, 8, 4
        pos = np.asarray([5, 0, 17], np.int32)
        pk, pv, tab, owner, bpos = _pool(rng, B, nb, page, 2, 32, pos + 1)
        L = jlm.arch.n_layers
        pools = [np.stack([pk * (i + 1) for i in range(L)]), np.stack([pv * (i + 1) for i in range(L)])]
        jc = jlm.init_paged_cache(pk.shape[0], page)
        tc = tlm.init_paged_cache(pk.shape[0], page)
        assert [tuple(a.shape) for a in tc["blocks"]] == [a.shape for a in jc["blocks"]]
        jcache = {"blocks": tuple(jnp.asarray(a) for a in pools)}
        tcache = {"blocks": tuple(t(a.copy()) for a in pools)}
        tok = rng.integers(0, 512, (B, 1)).astype(np.int32)
        jb = {"tokens": jnp.asarray(tok), "position": jnp.asarray(pos), "block_tables": jnp.asarray(tab),
              "pool_owner": jnp.asarray(owner), "pool_pos": jnp.asarray(bpos)}
        tb = {"tokens": t(tok).long(), "position": t(pos), "block_tables": t(tab),
              "pool_owner": t(owner), "pool_pos": t(bpos)}
        jl, jnc, jaux = jlm.decode_step(jp, jb, jcache)
        tl, tnc, taux = tlm.decode_step(tp, tb, tcache)
        assert tnc is tcache
        assert_close(tl, jl)
        for a, b in zip(tnc["blocks"], jnc["blocks"]):
            assert_close(a[:, 1:], np.asarray(b)[:, 1:])  # the trash block is write-only
        np.testing.assert_array_equal(np.asarray(jaux.counts), taux.counts.numpy())

    def test_padded_vocab_is_masked(self):
        arch = dataclasses.replace(proxy_arch(tget), vocab_size=500)
        lm = TLM(arch, dtype=torch.float32, device="cpu")
        p = lm.init(seed=0)
        logits, _, _ = lm.prefill(p, {"tokens": torch.zeros((1, 4), dtype=torch.long)})
        assert lm.vocab_padded == 512
        assert (logits[..., 500:] == -1e30).all()

    def test_init_is_seeded_and_mirrors_the_jax_tree(self):
        jlm, jp, tlm, _ = _pair()
        p0, p1 = tlm.init(seed=7), tlm.init(seed=7)
        assert torch.equal(p0["blocks"][1]["moe"]["w_gate"], p1["blocks"][1]["moe"]["w_gate"])
        assert not torch.equal(p0["embed"], tlm.init(seed=8)["embed"])
        jshapes = jax.tree.map(lambda a: a.shape[1:], jp["blocks"])
        tshapes = jax.tree.map(lambda a: tuple(a.shape), p0["blocks"][0])
        assert jshapes == tshapes
        assert len(p0["blocks"]) == jp["blocks"]["norm1"]["scale"].shape[0]
        assert p0["blocks"][0]["moe"]["w_router"].dtype == torch.float32

    def test_cuda_default_raises_without_a_gpu(self):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present: the default device is usable")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TLM(proxy_arch(tget))

    def test_unported_families_raise(self):
        arch = proxy_arch(tget)
        for unported in (dataclasses.replace(arch, family="diffusion"),
                         dataclasses.replace(arch, attn=dataclasses.replace(arch.attn, kind="none"))):
            with pytest.raises(NotImplementedError):
                TLM(unported, device="cpu")
