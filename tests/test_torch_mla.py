"""DeepSeek-V2 in the port against the JAX reference: the config and its
``reduced()``, the weight bridge's ``prefix_blocks`` and float32 latent
norm scales, MLA prefill and absorbed decode, ``LM`` prefill and decode
with the dense prefix block, the serving engine on the Sieve dual path,
the paged cache's refusal, and a snapshot/restore of the MLA engine.

Weights come from the JAX package and cross through
``repro_torch.bridge``; float32 is held to the repo's tolerance
(``_torch_port.F32_TOL``), integers exactly.  Each JAX engine runs once
per expert-exec mode, in a module fixture."""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_port import F32_TOL, assert_close, pin_threads, t

pin_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget  # noqa: E402
from repro.configs.base import AttnConfig as JAttn, MLAConfig as JMLA  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.serving import BatchingConfig as JBatching, Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_arch as tget  # noqa: E402
from repro_torch.configs.base import AttnConfig as TAttn, MLAConfig as TMLA  # noqa: E402
from repro_torch.models import LM as TLM  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.serving import BatchingConfig, Request, ServingEngine  # noqa: E402

NAME = "deepseek-v2-236b"
MODES = ("dense", "dual_path_cost")


def _fields(cfg) -> dict:
    """A config as nested plain values, dataclass by dataclass."""
    return {f.name: (_fields(v) if dataclasses.is_dataclass(v) else v)
            for f in dataclasses.fields(cfg) for v in (getattr(cfg, f.name),)}


def _reduced(get_arch, mode: str, n_layers: int = 3):
    """``reduced()`` with three layers (the dense prefix block and two MoE
    blocks) on the given expert-exec path."""
    arch = get_arch(NAME).reduced(n_layers=n_layers)
    return dataclasses.replace(arch, moe=dataclasses.replace(arch.moe, expert_exec=mode))


def _pair(mode: str, seed: int = 0):
    jlm = JLM(_reduced(jget, mode), dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(seed)))
    tlm = TLM(_reduced(tget, mode), dtype=torch.float32, device="cpu")
    return jlm, jax.tree.map(jnp.asarray, tree), tlm, params_from_numpy(tree, "cpu", torch.float32)


# ---------------------------------------------------------------------------
# config and bridge
# ---------------------------------------------------------------------------


def test_config_matches_jax():
    """Every field of the port's config equals the JAX config's, the MLA
    dims included, and so does every field of ``reduced()``; the JAX
    fields the port does not carry are at their defaults."""
    ta, ja = tget(NAME), jget(NAME)
    jf = _fields(ja)
    assert _fields(ta) == {k: jf[k] for k in _fields(ta)}
    assert ja.ssm is None and not ja.encdec and ja.attn_every == 0
    assert ta.attn.kind == "mla" and ta.moe.first_k_dense == 1 and ta.moe.expert_exec == "dense"
    for overrides in ({}, {"n_layers": 3}):
        tr, jr = _fields(ta.reduced(**overrides)), _fields(ja.reduced(**overrides))
        assert tr == {k: jr[k] for k in tr}
    assert tr["attn"]["n_kv_heads"] == 0 and tr["attn"]["mla"]["kv_lora_rank"] == 32


def test_bridge_unstacks_prefix_and_keeps_latent_scales_float32():
    jlm = JLM(_reduced(jget, "dense"), dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(0)))
    tp = params_from_numpy(tree, "cpu", torch.bfloat16)
    assert isinstance(tp["prefix_blocks"], list) and len(tp["prefix_blocks"]) == 1
    assert isinstance(tp["blocks"], list) and len(tp["blocks"]) == 2
    assert "mlp" in tp["prefix_blocks"][0] and "moe" in tp["blocks"][0]
    for blk in tp["prefix_blocks"] + tp["blocks"]:
        a = blk["attn"]
        assert a["q_norm_scale"].dtype == a["kv_norm_scale"].dtype == torch.float32
        assert a["w_dq"].dtype == a["w_uk"].dtype == a["wo"].dtype == torch.bfloat16
    for i, blk in enumerate(tp["prefix_blocks"]):
        want = tree["prefix_blocks"]["mlp"]["w_gate"][i]
        assert_close(blk["mlp"]["w_gate"], want.astype(np.float32), rtol=1e-2, atol=1e-2)
    # the port's own init gives the same tree, float32 leaves included
    tlm = TLM(_reduced(tget, "dense"), dtype=torch.bfloat16, device="cpu")
    own = tlm.init(seed=0)
    for ref_blk, own_blk in zip(tp["prefix_blocks"] + tp["blocks"], own["prefix_blocks"] + own["blocks"]):
        flat_ref = {k: (v.shape, v.dtype) for k, v in ref_blk["attn"].items()}
        assert flat_ref == {k: (v.shape, v.dtype) for k, v in own_blk["attn"].items()}


# ---------------------------------------------------------------------------
# MLA prefill and absorbed decode
# ---------------------------------------------------------------------------

# (d_model, MLA dims) of the attention cases: reduced() dims, and the real
# per-head dims of deepseek-v2 on four heads at d_model 64
_MLA_CASES = {
    "reduced": (64, dict(q_lora_rank=32, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)),
    "real_head_dims": (64, dict(q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                                v_head_dim=128)),
}


def _mla(case: str, seed: int = 0):
    d, dims = _MLA_CASES[case]
    jcfg = JAttn(kind="mla", n_heads=4, n_kv_heads=4, d_head=128, rope_theta=1e4, mla=JMLA(**dims))
    tcfg = TAttn(kind="mla", n_heads=4, n_kv_heads=4, d_head=128, rope_theta=1e4, mla=TMLA(**dims))
    jp = jattn.init_mla(jax.random.PRNGKey(seed), jcfg, d, jnp.float32)
    tp = {k: t(np.asarray(v)) for k, v in jp.items()}
    return jcfg, jp, tcfg, tp, d


@pytest.mark.parametrize("case", list(_MLA_CASES))
def test_mla_prefill_matches_jax(case):
    jcfg, jp, tcfg, tp, d = _mla(case)
    rng = np.random.default_rng(1)
    B, S = 2, 24
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    jy, jc, jr = jattn.mla_prefill(jp, jnp.asarray(x), jnp.asarray(pos), jcfg, q_chunk=8, kv_chunk=8)
    ty, tc, tr = tattn.mla_prefill(tp, t(x), t(pos), tcfg, q_chunk=8, kv_chunk=8)
    m = tcfg.mla
    assert ty.shape == (B, S, d) and tc.shape == (B, S, m.kv_lora_rank) and tr.shape == (B, S, m.qk_rope_dim)
    for got, want in ((ty, jy), (tc, jc), (tr, jr)):
        assert_close(got, want)


@pytest.mark.parametrize("case", list(_MLA_CASES))
def test_mla_decode_writes_caches_in_place_as_jax_returns_them(case):
    """Several decode steps: the caches written in place equal the JAX
    function's returned caches after every step, the outputs agree, and a
    position past the cache writes its row at T - 1 (the clamp of
    ``dynamic_update_slice``) while attending over every position."""
    jcfg, jp, tcfg, tp, d = _mla(case, seed=2)
    m = tcfg.mla
    rng = np.random.default_rng(3)
    B, T = 3, 20
    ckv = rng.standard_normal((B, T, m.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((B, T, m.qk_rope_dim)).astype(np.float32)
    jc, jr = jnp.asarray(ckv), jnp.asarray(kr)
    tc, tr = t(ckv.copy()), t(kr.copy())
    position = np.asarray([4, 0, T - 3], np.int32)
    for step in range(4):  # slot 2 reaches T - 1, then T and T + 1 (clamped)
        x = rng.standard_normal((B, 1, d)).astype(np.float32)
        jy, jc, jr = jattn.mla_decode(jp, jnp.asarray(x), jnp.asarray(position), jc, jr, jcfg)
        ty = tattn.mla_decode(tp, t(x), t(position), tc, tr, tcfg)
        assert ty.shape == (B, 1, d)
        assert_close(ty, jy)
        assert_close(tc, jc)
        assert_close(tr, jr)
        position = position + 1
    assert position[2] > T  # the last two steps wrote past the cache's end
    assert not np.allclose(np.asarray(jc)[2, T - 1], ckv[2, T - 1])


# ---------------------------------------------------------------------------
# LM prefill and decode with the dense prefix
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_lm_prefill_and_decode_match_jax(mode):
    jlm, jp, tlm, tp = _pair(mode)
    E = tlm.arch.moe.n_experts
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 256, (2, 16)).astype(np.int32)
    jl, jc, jaux = jlm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc, taux = tlm.prefill(tp, {"tokens": t(toks).long()})
    assert_close(tl, jl)
    assert sorted(tc) == sorted(jc) == ["blocks", "prefix"]
    for key in tc:
        for x, y in zip(tc[key], jc[key]):
            assert x.shape == y.shape
            assert_close(x, y)
    assert taux.counts.shape == (2, E)  # the MoE blocks only
    np.testing.assert_array_equal(taux.counts.numpy(), np.asarray(jaux.counts))
    assert int(taux.dropped) == int(jaux.dropped)
    assert_close(taux.moe_aux, jaux.moe_aux)

    B, T = 3, 32
    jcache, tcache = jlm.init_cache(B, T), tlm.init_cache(B, T)
    for key in tcache:
        leaves = []
        for x in tcache[key]:
            v = rng.standard_normal(x.shape).astype(np.float32)
            x.copy_(t(v))
            leaves.append(jnp.asarray(v))
        jcache[key] = tuple(leaves)
    tok = rng.integers(0, 256, (B, 1)).astype(np.int32)
    position = np.asarray([5, 0, 17], np.int32)
    jl, jnc, jaux = jlm.decode_step(jp, {"tokens": jnp.asarray(tok), "position": jnp.asarray(position)}, jcache)
    tl, tnc, taux = tlm.decode_step(tp, {"tokens": t(tok).long(), "position": t(position)}, tcache)
    assert tnc is tcache
    assert_close(tl, jl)
    for key in tnc:
        for x, y in zip(tnc[key], jnc[key]):
            assert_close(x, y)
    assert taux.counts.shape == (2, E)
    np.testing.assert_array_equal(taux.counts.numpy(), np.asarray(jaux.counts))
    assert int(taux.dropped) == int(jaux.dropped)


def test_paged_cache_raises_for_mla():
    jlm, jp, tlm, tp = _pair("dual_path_cost")
    with pytest.raises(ValueError, match="gqa"):
        jlm.init_paged_cache(9, 8)
    with pytest.raises(ValueError, match="gqa"):
        tlm.init_paged_cache(9, 8)
    with pytest.raises(ValueError, match="gqa"):
        ServingEngine(tlm, tp, BatchingConfig(n_slots=2, max_seq=48, paged=True, page_size=8))


# ---------------------------------------------------------------------------
# serving engine: one run of each package per expert-exec mode
# ---------------------------------------------------------------------------

_PROMPTS = [np.random.default_rng(s).integers(0, 256, 12).tolist() for s in range(3)]
_MAX_NEW = 6


def _engines(mode: str):
    jlm, jp, tlm, tp = _pair(mode)
    # two slots for three requests: a slot is reused after a retire
    je = JEngine(jlm, jp, JBatching(n_slots=2, max_seq=48), sieve_refresh_every=2)
    te = ServingEngine(tlm, tp, BatchingConfig(n_slots=2, max_seq=48), sieve_refresh_every=2)
    for p in _PROMPTS:
        je.submit(JRequest(prompt=list(p), max_new_tokens=_MAX_NEW))
        te.submit(Request(prompt=list(p), max_new_tokens=_MAX_NEW))
    return je, te


@pytest.fixture(scope="module")
def served():
    runs = {}

    def get(mode):
        if mode not in runs:
            je, te = _engines(mode)
            je.run_until_done()
            te.run_until_done()
            runs[mode] = (je, te)
        return runs[mode]

    return get


def _tokens(eng):
    return [r.generated for r in sorted(eng.sched.finished, key=lambda r: r.req_id)]


@pytest.mark.parametrize("mode", MODES)
def test_engine_greedy_tokens_match_jax(served, mode):
    je, te = served(mode)
    assert _tokens(te) == _tokens(je)
    assert all(len(g) == _MAX_NEW for g in _tokens(te))
    assert (te.stats.steps, te.stats.decode_tokens, te.stats.prefill_tokens) == (
        je.stats.steps, je.stats.decode_tokens, je.stats.prefill_tokens)
    assert (te.stats.routed_tokens, te.stats.dropped_tokens) == (je.stats.routed_tokens, je.stats.dropped_tokens)


@pytest.mark.parametrize("mode", MODES)
def test_engine_sieve_state_matches_jax(served, mode):
    """The host scheduler's partitions (two MoE layers a step, the dense
    prefix not among them), the refresh steps and the cost table's cells
    equal the JAX engine's."""
    je, te = served(mode)
    assert te.is_moe and te.uses_cost_split == (mode == "dual_path_cost")
    assert len(te.stats.partitions) == len(je.stats.partitions) > 0
    assert {p["layer"] for p in te.stats.partitions} == {0, 1}
    for a, b in zip(te.stats.partitions, je.stats.partitions):
        assert {k: a[k] for k in ("step", "layer", "n_gpu", "n_pim")} == \
            {k: b[k] for k in ("step", "layer", "n_gpu", "n_pim")}
        np.testing.assert_allclose(a["t_total_est"], b["t_total_est"], **F32_TOL)
    assert te.sieve_refreshes == je.sieve_refreshes
    if mode == "dual_path_cost":
        assert len(te.sieve_refreshes) >= 2
    assert te.cost_table.version == je.cost_table.version
    np.testing.assert_array_equal(te.cost_table.export(64), je.cost_table.export(64))


def test_engine_cache_layout(served):
    """The engine's cache holds MLA's compressed rows for the prefix and
    the MoE blocks, and the decode inputs are the tokens and positions."""
    _, te = served("dual_path_cost")
    m = te.lm.arch.attn.mla
    assert sorted(te.cache) == ["blocks", "prefix"]
    assert [tuple(x.shape) for x in te.cache["prefix"]] == [(1, 2, 48, m.kv_lora_rank), (1, 2, 48, m.qk_rope_dim)]
    assert [tuple(x.shape) for x in te.cache["blocks"]] == [(2, 2, 48, m.kv_lora_rank), (2, 2, 48, m.qk_rope_dim)]
    assert sorted(te._decode_in) == ["position", "tokens"]


def test_snapshot_restore_continues_bit_for_bit(tmp_path):
    """An MLA engine snapshotted mid-run and a fresh engine restored from
    it step on with the same logits, tokens, caches (prefix and blocks)
    and cost table, bit for bit."""
    _, _, tlm, tp = _pair("dual_path_cost")

    def engine():
        eng = ServingEngine(tlm, tp, BatchingConfig(n_slots=2, max_seq=48), sieve_refresh_every=2)
        logits = []
        decode = eng._decode

        def recorded(batch):
            out = decode(batch)
            logits.append(out[0].clone())
            return out

        eng._decode = recorded
        return eng, logits

    a, logits_a = engine()
    for p in _PROMPTS:
        a.submit(Request(prompt=list(p), max_new_tokens=_MAX_NEW))
    for _ in range(4):
        a.step()
    a.snapshot(str(tmp_path))
    n_before = len(logits_a)
    a.run_until_done()
    b, logits_b = engine()
    b.restore(str(tmp_path))
    b.run_until_done()
    assert len(logits_b) == len(logits_a) - n_before > 0
    assert all(torch.equal(x, y) for x, y in zip(logits_a[n_before:], logits_b))
    assert _tokens(b) == _tokens(a)
    for key in a.cache:
        assert all(torch.equal(x, y) for x, y in zip(a.cache[key], b.cache[key]))
    np.testing.assert_array_equal(b.cost_table.export(64), a.cost_table.export(64))
    assert b.sieve_refreshes[-1] == a.sieve_refreshes[-1]
