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
        arch = dataclasses.replace(proxy_arch(tget), family="ssm")
        with pytest.raises(NotImplementedError):
            TLM(arch, device="cpu")
