"""The dense and VLM families in the port against the JAX reference: the
five configs, ``LM`` prefill and decode, M-RoPE, the vision-patch stub,
the serving engine's greedy tokens, and the plain decode-attention
versions at the head dims and group sizes these models use.

Models are cut to two layers and a narrow ``d_model`` but keep each
config's real head dim, head counts and query-group size (the JAX
``reduced()`` sets ``d_head=16``, which would hide them).  Weights come
from the JAX package and cross through ``repro_torch.bridge``; the QKV
biases, which both packages initialise to zero, are drawn at random so
that the bias path is exercised."""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_port import assert_close, pin_threads, t

pin_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.serving import BatchingConfig as JBatching, Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_arch as tget  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import LM as TLM  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.serving import BatchingConfig, Request, ServingEngine  # noqa: E402

FAMILIES = ("granite-3-2b", "qwen1.5-0.5b", "granite-3-8b", "deepseek-coder-33b", "qwen2-vl-7b")
VOCAB = 512


def _narrow(get_arch, name: str):
    """The config at two layers, d_model 64, d_ff 96 and a 512-token
    vocabulary, with its attention (heads, kv heads, head dim, bias,
    M-RoPE sections) unchanged."""
    return dataclasses.replace(get_arch(name), n_layers=2, d_model=64, d_ff=96, vocab_size=VOCAB)


def _pair(name: str, seed: int = 0):
    jlm = JLM(_narrow(jget, name), dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(seed)))
    if jlm.arch.attn.qkv_bias:
        rng = np.random.default_rng(seed + 100)
        attn = tree["blocks"]["attn"]
        for b in ("bq", "bk", "bv"):
            attn[b] = (0.1 * rng.standard_normal(attn[b].shape)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, tree)
    tlm = TLM(_narrow(tget, name), dtype=torch.float32, device="cpu")
    return jlm, jp, tlm, params_from_numpy(tree, "cpu", torch.float32)


def _mrope_positions(B: int, S: int, offset: int = 0) -> np.ndarray:
    """(3, B, S) positions whose t, h and w streams differ: patches of
    frames of 3 x 4, row by row."""
    s = np.arange(S) + offset
    grid = np.stack([s // 12, s // 4 % 3 + 2 * (s // 12), s % 4 + s // 12])
    return np.broadcast_to(grid[:, None, :], (3, B, S)).astype(np.int32).copy()


@pytest.mark.parametrize("name", FAMILIES)
def test_config_matches_jax(name):
    """Every field of the port's config equals the JAX config's, and the
    JAX fields the port does not carry are at their defaults."""
    ta, ja = tget(name), jget(name)
    for f in dataclasses.fields(ta):
        tv, jv = getattr(ta, f.name), getattr(ja, f.name)
        if dataclasses.is_dataclass(tv):
            for g in dataclasses.fields(tv):
                assert getattr(tv, g.name) == getattr(jv, g.name), (f.name, g.name)
        else:
            assert tv == jv, f.name
    assert ja.ssm is None and ja.attn.mla is None and not ja.encdec and ja.attn_every == 0
    assert ta.family in ("dense", "vlm") and ta.source == ja.source and ta.source


@pytest.mark.parametrize("name", FAMILIES)
def test_lm_prefill_and_decode_match_jax(name):
    jlm, jp, tlm, tp = _pair(name)
    a = tlm.arch.attn
    vlm = tlm.arch.family == "vlm"
    rng = np.random.default_rng(3)
    S = 20
    toks = rng.integers(0, VOCAB, (1, S)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": t(toks).long()}
    if vlm:
        pos = _mrope_positions(1, S)
        jb["mrope_positions"], tb["mrope_positions"] = jnp.asarray(pos), t(pos)
    jl, jc, _ = jlm.prefill(jp, jb)
    tl, tc, _ = tlm.prefill(tp, tb)
    assert_close(tl, jl)
    for x, y in zip(tc["blocks"], jc["blocks"]):
        assert_close(x, y)

    B, T = 3, 32
    kv = rng.standard_normal((2, B, T, a.n_kv_heads, a.d_head)).astype(np.float32)
    jcache = {"blocks": (jnp.asarray(kv), jnp.asarray(kv * 0.5))}
    tcache = {"blocks": (t(kv.copy()), t(kv * 0.5))}
    tok = rng.integers(0, VOCAB, (B, 1)).astype(np.int32)
    position = np.asarray([5, 0, 17], np.int32)
    jb = {"tokens": jnp.asarray(tok), "position": jnp.asarray(position)}
    tb = {"tokens": t(tok).long(), "position": t(position)}
    if vlm:
        pos = np.stack([position, position + 3, position * 2])[:, :, None].astype(np.int32)
        jb["mrope_positions"], tb["mrope_positions"] = jnp.asarray(pos), t(pos)
    jl, jnc, _ = jlm.decode_step(jp, jb, jcache)
    tl, tnc, _ = tlm.decode_step(tp, tb, tcache)
    assert tnc is tcache
    assert_close(tl, jl)
    for x, y in zip(tnc["blocks"], jnc["blocks"]):
        assert_close(x, y)


def test_apply_mrope_matches_jax_and_is_not_rope():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 4, 128)).astype(np.float32)
    pos = _mrope_positions(2, 9, offset=5)
    assert not (pos[0] == pos[1]).all() and not (pos[1] == pos[2]).all()
    got = tlayers.apply_mrope(t(x), t(pos), 1e6, (16, 24, 24))
    assert_close(got, jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, (16, 24, 24)))
    # distinct streams rotate otherwise than RoPE of any one stream
    for stream in range(3):
        rope = tlayers.apply_rope(t(x), t(pos[stream]), 1e6)
        assert not torch.allclose(got, rope, atol=1e-3)
    # equal streams reduce M-RoPE to RoPE
    same = np.broadcast_to(pos[0], (3,) + pos.shape[1:]).copy()
    assert_close(tlayers.apply_mrope(t(x), t(same), 1e6, (16, 24, 24)),
                 tlayers.apply_rope(t(x), t(pos[0]), 1e6))


def test_vlm_stub_prefill_matches_jax():
    """A prefill on the vision-patch stub's seeded embeddings with
    distinct t/h/w positions (``LM.stub_inputs``), against JAX on the same
    inputs; the positions change the logits."""
    jlm, jp, tlm, tp = _pair("qwen2-vl-7b", seed=2)
    stub = tlm.stub_inputs(batch=2, seq=16, seed=4)
    emb, pos = stub["embeds"], stub["mrope_positions"]
    assert emb.shape == (2, 16, 64) and pos.shape == (3, 2, 16)
    assert not torch.equal(pos[0], pos[1]) and not torch.equal(pos[1], pos[2])
    jl, jc, _ = jlm.prefill(jp, {"embeds": jnp.asarray(emb.numpy()), "mrope_positions": jnp.asarray(pos.numpy())})
    tl, tc, _ = tlm.prefill(tp, stub)
    assert tl.shape == (2, 1, tlm.vocab_padded) and torch.isfinite(tl[..., :VOCAB]).all()
    assert_close(tl, jl)
    for x, y in zip(tc["blocks"], jc["blocks"]):
        assert_close(x, y)
    text, _, _ = tlm.prefill(tp, {"embeds": emb, "mrope_positions": pos[0].expand(3, -1, -1)})
    assert not torch.allclose(text, tl, atol=1e-4)
    with pytest.raises(ValueError, match="no vision-patch stub"):
        _pair("granite-3-2b")[2].stub_inputs(1, 4, 0)


# ---------------------------------------------------------------------------
# serving engine: greedy tokens against the JAX engine, one run per layout
# ---------------------------------------------------------------------------

_PROMPTS = [np.random.default_rng(s).integers(0, VOCAB, 12).tolist() for s in range(3)]
_MAX_NEW = 6
# (config, paged) of each layout
_ENGINE_CASES = {
    "granite_3_2b_dense": ("granite-3-2b", False),
    "granite_3_2b_paged": ("granite-3-2b", True),
    "qwen2_vl_7b_dense": ("qwen2-vl-7b", False),
}


def _serve(case: str):
    """Both engines over three requests on two slots (a slot is reused):
    (JAX engine, port engine).  Paged: page 8, and the JAX side runs its
    oracle paged attention (``REPRO_FLASH_DECODE=0``): its pool-major twin
    gives an idle slot zeros, where the kernels attend over the trash-block
    row."""
    name, paged = _ENGINE_CASES[case]
    jlm, jp, tlm, tp = _pair(name)
    kw = dict(paged=True, page_size=8) if paged else {}
    with pytest.MonkeyPatch.context() as mp:
        if paged:
            mp.setenv("REPRO_FLASH_DECODE", "0")
        je = JEngine(jlm, jp, JBatching(n_slots=2, max_seq=48, **kw))
        te = ServingEngine(tlm, tp, BatchingConfig(n_slots=2, max_seq=48, **kw))
        for p in _PROMPTS:
            je.submit(JRequest(prompt=list(p), max_new_tokens=_MAX_NEW))
            te.submit(Request(prompt=list(p), max_new_tokens=_MAX_NEW))
        je.run_until_done()
        te.run_until_done()
    return je, te


@pytest.fixture(scope="module")
def served():
    runs = {}

    def get(case):
        if case not in runs:
            runs[case] = _serve(case)
        return runs[case]

    return get


def _tokens(eng):
    return [r.generated for r in sorted(eng.sched.finished, key=lambda r: r.req_id)]


@pytest.mark.parametrize("case", list(_ENGINE_CASES))
def test_engine_greedy_tokens_match_jax(served, case):
    je, te = served(case)
    assert _tokens(te) == _tokens(je)
    assert all(len(g) == _MAX_NEW for g in _tokens(te))


@pytest.mark.parametrize("case", list(_ENGINE_CASES))
def test_engine_steps_and_inputs(served, case):
    """The same steps and token counts as the JAX engine, no MoE state, a
    paged pool all free again, and for the VLM its M-RoPE positions among
    the fixed-address decode inputs."""
    je, te = served(case)
    assert (te.stats.steps, te.stats.decode_tokens, te.stats.prefill_tokens) == (
        je.stats.steps, je.stats.decode_tokens, je.stats.prefill_tokens)
    assert not te.is_moe and te.sieve_refreshes == [] and te._sieve_state is None
    if te.paged is not None:
        assert te.paged.n_free == te.paged.n_pool - 1
    vlm = te.lm.arch.family == "vlm"
    assert ("mrope_positions" in te._decode_in) == vlm
    if vlm:
        assert tuple(te._decode_in["mrope_positions"].shape) == (3, 2, 1)


# ---------------------------------------------------------------------------
# the plain decode-attention versions at the families' head dims and groups
# ---------------------------------------------------------------------------

# (dh, Kv, G): granite-3-2b, zamba2-7b's shared attention, an MQA group of
# 32 query heads (two of the card's 16-head blocks), deepseek/qwen2-vl's 7
_ATTN = {"dh64_g4": (64, 8, 4), "dh112_g1": (112, 4, 1), "dh128_g32": (128, 1, 32),
         "dh128_g7": (128, 2, 7)}


@pytest.mark.parametrize("case", list(_ATTN))
@pytest.mark.parametrize("n_splits", [1, 3])
def test_plain_decode_attention_matches_pallas(case, n_splits):
    dh, Kv, G = _ATTN[case]
    rng = np.random.default_rng(dh + G)
    B, T = 4, 40
    q = rng.standard_normal((B, Kv * G, dh)).astype(np.float32)
    ck = rng.standard_normal((B, T, Kv, dh)).astype(np.float32)
    cv = rng.standard_normal((B, T, Kv, dh)).astype(np.float32)
    L = np.asarray([40, 0, 17, 1], np.int32)
    want = jops.decode_attention(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(L),
                                 bt=8, n_splits=n_splits, interpret=True)
    got = ops.decode_attention(t(q), t(ck), t(cv), t(L), n_splits=n_splits)
    assert_close(got, want)
    assert (got[1] == 0).all()


@pytest.mark.parametrize("case", list(_ATTN))
def test_plain_paged_attention_matches_pallas(case):
    dh, Kv, G = _ATTN[case]
    rng = np.random.default_rng(2 * dh + G)
    B, page, nb = 4, 8, 4
    n_pool = B * nb + 1
    pk = rng.standard_normal((n_pool, page, Kv, dh)).astype(np.float32)
    pv = rng.standard_normal((n_pool, page, Kv, dh)).astype(np.float32)
    q = rng.standard_normal((B, Kv * G, dh)).astype(np.float32)
    lens = np.asarray([29, 0, 8, 1], np.int32)
    order = rng.permutation(np.arange(1, n_pool))
    tab = np.zeros((B, nb), np.int32)
    nxt = 0
    for b in range(B - 1):  # the last slot is idle: all trash cells
        for j in range(-(-int(lens[b]) // page)):
            tab[b, j] = order[nxt]
            nxt += 1
    want = jops.decode_attention_paged(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(tab),
                                       jnp.asarray(lens), interpret=True)
    got = ops.decode_attention_paged(t(q), t(pk), t(pv), t(tab), t(lens))
    assert_close(got, want)
    assert (got[1] == 0).all()
