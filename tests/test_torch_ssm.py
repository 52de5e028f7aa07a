"""The port's Mamba2 and RWKV6 blocks, whisper's cross-attention and the
layers the hybrid, ssm and audio families add (LayerNorm, GELU,
sinusoidal positions) against the JAX reference, in float32 within
``F32_TOL``; then, in the port alone, the sequence forms against their
one-token steps.

Sizes are JAX's ``reduced()`` ones (d_model 64; SSM d_state 16, head dim
16, decay LoRA 8, WKV chunk 16), plus one attention case at zamba2-7b's
real shared attention (32 heads of dh 112).  Inputs are seeded numpy;
weights are JAX's ``init_*`` with their fixed leaves (D, the mixes, the
norm scales) moved off their init values, crossing through
``repro_torch.bridge``."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_port import assert_close, pin_threads, t

pin_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import AttnConfig as JAttn, SSMConfig as JSSM  # noqa: E402
from repro.models import attention as jattn, layers as jlayers, ssm as jssm  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.base import AttnConfig as TAttn, SSMConfig as TSSM  # noqa: E402
from repro_torch.models import attention as tattn, layers as tlayers, ssm as tssm  # noqa: E402

D, FF = 64, 128
MAMBA = dict(kind="mamba2", d_state=16, head_dim=16, expand=2, conv_width=4)
RWKV = dict(kind="rwkv6", head_dim=16, decay_lora=8, wkv_chunk=16)
# float32 leaves set to constants at init, drawn here so a misplaced one shows
_JITTER = ("D", "dt_bias", "norm_scale", "mix_r", "mix_k", "mix_v", "mix_w", "mix_g", "cmix_k",
           "cmix_r", "ln_x_scale", "w0", "conv_b")


def _block(init, seed: int):
    """(JAX params, port params) of one block, the fixed leaves jittered."""
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 50)
    for name in _JITTER:
        if name in tree:
            tree[name] = (tree[name] + rng.uniform(-0.4, 0.4, tree[name].shape)).astype(np.float32)
    return jax.tree.map(jnp.asarray, tree), params_from_numpy({"b": tree}, "cpu", torch.float32)["b"]


def _x(seed: int, shape, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _mamba():
    jp, tp = _block(lambda k: jssm.init_mamba2(k, D, JSSM(**MAMBA), jnp.float32), 0)
    return jp, tp, JSSM(**MAMBA), TSSM(**MAMBA)


def _rwkv():
    jp, tp = _block(lambda k: jssm.init_rwkv6(k, D, FF, JSSM(**RWKV), jnp.float32), 1)
    return jp, tp, JSSM(**RWKV), TSSM(**RWKV)


def _mamba_state(seed: int, B: int, zero: bool):
    """(JAX, port) Mamba2 states: zeros, or seeded values."""
    conv_ch = 2 * D + 2 * MAMBA["d_state"]
    H = 2 * D // MAMBA["head_dim"]
    conv = _x(seed, (B, MAMBA["conv_width"] - 1, conv_ch)) * (not zero)
    h = _x(seed + 1, (B, H, MAMBA["head_dim"], MAMBA["d_state"])) * (not zero)
    return jssm.Mamba2State(jnp.asarray(conv), jnp.asarray(h)), tssm.Mamba2State(t(conv), t(h))


def _rwkv_state(seed: int, B: int):
    H = D // RWKV["head_dim"]
    xs = [_x(seed, (B, D)), _x(seed + 1, (B, D)), _x(seed + 2, (B, H, 16, 16), 0.2)]
    return jssm.RWKV6State(*map(jnp.asarray, xs)), tssm.RWKV6State(*map(t, xs))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_layernorm_matches_jax():
    x = _x(0, (3, 5, D), 2.0) + 1.5
    rng = np.random.default_rng(1)
    p = {"scale": rng.standard_normal(D).astype(np.float32), "bias": rng.standard_normal(D).astype(np.float32)}
    want = jlayers.apply_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x), "layernorm")
    assert_close(tlayers.apply_norm({k: t(v) for k, v in p.items()}, t(x), "layernorm"), want)
    init = tlayers.init_norm(D, "layernorm", "cpu")
    assert set(init) == {"scale", "bias"} and init["bias"].dtype == torch.float32
    assert set(tlayers.init_norm(D, "rmsnorm", "cpu")) == {"scale"}


def test_gelu_mlp_matches_jax():
    jp = jax.tree.map(np.asarray, jlayers.init_mlp(jax.random.PRNGKey(2), D, FF, "gelu", jnp.float32))
    assert set(jp) == {"w_up", "w_down"}
    x = _x(3, (2, 7, D), 2.0)
    want = jlayers.apply_mlp(jax.tree.map(jnp.asarray, jp), jnp.asarray(x), "gelu")
    assert_close(tlayers.apply_mlp({k: t(v) for k, v in jp.items()}, t(x), "gelu"), want)
    gen = torch.Generator().manual_seed(0)
    assert set(tlayers.init_mlp(gen, D, FF, "gelu", torch.float32, "cpu")) == {"w_up", "w_down"}
    # the tanh approximation, as jax.nn.gelu computes by default
    z = np.linspace(-6, 6, 101).astype(np.float32)
    assert_close(F.gelu(t(z), approximate="tanh"), jax.nn.gelu(jnp.asarray(z)))


@pytest.mark.parametrize("n_pos,d", [(16, 64), (1500, 512)])
def test_sinusoidal_positions_match_jax(n_pos, d):
    assert_close(tlayers.sinusoidal_positions(n_pos, d), jlayers.sinusoidal_positions(n_pos, d))


def test_softplus_matches_jax_around_the_threshold():
    """``F.softplus`` returns x itself above 20; ``jax.nn.softplus`` is
    ``logaddexp(x, 0)``: equal within float32 over the range dt takes."""
    z = np.linspace(-30, 30, 241).astype(np.float32)
    assert_close(F.softplus(t(z)), jax.nn.softplus(jnp.asarray(z)))


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,zero", [(12, True), (12, False), (136, False)],
                         ids=["T12-from-zeros", "T12-from-state", "T136-chunk-8"])
def test_mamba2_seq_matches_jax(T, zero):
    """Outputs and final states; T = 136 takes the chunk search down from
    128 to 8 (17 chunks)."""
    jp, tp, jc, tc = _mamba()
    x = _x(4, (2, T, D))
    js, ts = _mamba_state(5, 2, zero)
    jy, jst = jssm.mamba2_seq(jp, jnp.asarray(x), jc, js)
    ty, tst = tssm.mamba2_seq(tp, t(x), tc, ts)
    assert_close(ty, jy)
    assert_close(tst.conv, jst.conv)
    assert_close(tst.ssm, jst.ssm)


def test_mamba2_step_matches_jax():
    jp, tp, jc, tc = _mamba()
    js, ts = _mamba_state(6, 3, zero=False)
    for i in range(4):
        x = _x(7 + i, (3, 1, D))
        jy, js = jssm.mamba2_step(jp, jnp.asarray(x), jc, js)
        ty, ts = tssm.mamba2_step(tp, t(x), tc, ts)
        assert_close(ty, jy)
        assert_close(ts.conv, js.conv)
        assert_close(ts.ssm, js.ssm)


def test_ssd_and_wkv_chunk_search():
    """Mamba2 halves from 128, RWKV6 decrements from its target, each
    until the chunk divides T (repro/models/ssm.py:155-157, 362-364)."""
    assert [tssm.ssd_chunk(T) for T in (12, 128, 256, 136, 129, 100)] == [12, 128, 128, 8, 1, 100]
    assert [tssm.wkv_chunk(T, 16) for T in (10, 16, 18, 17, 1)] == [10, 16, 9, 1, 1]


def test_mamba2_chunked_equals_stepwise():
    """The counterpart of tests/test_attention_ssm.py:134, in the port."""
    _, tp, _, tc = _mamba()
    x = t(_x(8, (2, 12, D)))
    y_seq, st_seq = tssm.mamba2_seq(tp, x, tc)
    st = tssm.mamba2_init_state(2, D, tc, torch.float32, "cpu")
    ys = []
    for i in range(12):
        y, st = tssm.mamba2_step(tp, x[:, i: i + 1], tc, st)
        ys.append(y)
    assert_close(y_seq, torch.cat(ys, 1), rtol=2e-3, atol=2e-4)
    assert_close(st_seq.ssm, st.ssm, rtol=2e-3, atol=2e-4)
    assert_close(st_seq.conv, st.conv)


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T", [10, 18], ids=["T10-one-chunk", "T18-two-chunks-of-9"])
def test_rwkv6_time_and_channel_mix_match_jax(T):
    jp, tp, jc, tc = _rwkv()
    x = _x(9, (2, T, D))
    js, ts = _rwkv_state(10, 2)
    jy, jst = jssm.rwkv6_time_mix_seq(jp, jnp.asarray(x), jc, js)
    ty, tst = tssm.rwkv6_time_mix_seq(tp, t(x), tc, ts)
    assert_close(ty, jy)
    for a, b in zip(tst, jst):
        assert_close(a, b)
    jy, jst = jssm.rwkv6_channel_mix_seq(jp, jnp.asarray(x), js)
    ty, tst = tssm.rwkv6_channel_mix_seq(tp, t(x), ts)
    assert_close(ty, jy)
    for a, b in zip(tst, jst):
        assert_close(a, b)


def test_rwkv6_seq_equals_stepwise():
    """The counterpart of tests/test_attention_ssm.py:165, in the port, over
    the whole block (time mix and channel mix)."""
    _, tp, _, tc = _rwkv()
    norms = ({"scale": torch.ones(D), "bias": torch.zeros(D)},) * 2
    x = t(_x(11, (2, 18, D)))
    y_seq, st_seq = tssm.rwkv6_block_seq(tp, x, tc, tssm.rwkv6_init_state(2, D, tc, torch.float32, "cpu"),
                                         norms)
    st = tssm.rwkv6_init_state(2, D, tc, torch.float32, "cpu")
    ys = []
    for i in range(18):
        y, st = tssm.rwkv6_block_step(tp, x[:, i: i + 1], tc, st, norms)
        ys.append(y)
    assert_close(y_seq, torch.cat(ys, 1), rtol=1e-4, atol=1e-5)
    for a, b in zip(st_seq, st):
        assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_ssm_inits_mirror_the_jax_trees():
    """Same leaves, shapes and dtypes (float32 where the reference keeps
    float32) at bf16, and the fixed leaves at the reference's values."""
    gen = torch.Generator().manual_seed(0)
    for jinit, tinit in (
        (lambda: jssm.init_mamba2(jax.random.PRNGKey(0), D, JSSM(**MAMBA), jnp.bfloat16),
         lambda: tssm.init_mamba2(gen, D, TSSM(**MAMBA), torch.bfloat16, "cpu")),
        (lambda: jssm.init_rwkv6(jax.random.PRNGKey(0), D, FF, JSSM(**RWKV), jnp.bfloat16),
         lambda: tssm.init_rwkv6(gen, D, FF, TSSM(**RWKV), torch.bfloat16, "cpu")),
    ):
        jp, tp = jinit(), tinit()
        assert set(jp) == set(tp)
        for k in jp:
            assert tuple(tp[k].shape) == jp[k].shape, k
            assert (tp[k].dtype == torch.float32) == (jp[k].dtype == jnp.float32), k
            if k in ("A_log", "D", "dt_bias", "norm_scale", "conv_b", "w0", "ln_x_scale") or k.startswith(
                    ("mix_", "cmix_")):
                assert_close(tp[k], np.asarray(jp[k], np.float32))


# ---------------------------------------------------------------------------
# attention: whisper's cross-attention, zamba2's shared attention
# ---------------------------------------------------------------------------

_ATTN = {"reduced": dict(n_heads=4, n_kv_heads=2, d_head=16, d=64),
         "zamba2_real": dict(n_heads=32, n_kv_heads=32, d_head=112, d=256)}


def _attn_cfgs(case):
    c = _ATTN[case]
    kw = dict(kind="gqa", n_heads=c["n_heads"], n_kv_heads=c["n_kv_heads"], d_head=c["d_head"], rope_theta=1e4)
    return JAttn(**kw), TAttn(**kw), c["d"]


@pytest.mark.parametrize("case", list(_ATTN))
@pytest.mark.parametrize("Sq,Se", [(1, 16), (8, 16), (3, 1500)], ids=["decode", "prefill", "1500-frames"])
def test_cross_attention_matches_jax(case, Sq, Se):
    """``project_cross_kv`` then ``cross_attention``: 1500 encoder frames
    take kv chunks of 750."""
    jc, tc, d = _attn_cfgs(case)
    jp = jax.tree.map(np.asarray, jattn.init_cross_attention(jax.random.PRNGKey(3), jc, d, jnp.float32))
    tp = {k: t(v) for k, v in jp.items()}
    enc, x = _x(12, (2, Se, d)), _x(13, (2, Sq, d))
    jk, jv = jattn.project_cross_kv(jp, jnp.asarray(enc), jc)
    tk, tv = tattn.project_cross_kv(tp, t(enc), tc)
    assert_close(tk, jk)
    assert_close(tv, jv)
    assert_close(tattn.cross_attention(tp, t(x), tk, tv, tc), jattn.cross_attention(jp, jnp.asarray(x), jk, jv, jc))
    assert tattn._divisor_chunk(1500, 1024) == 750


@pytest.mark.parametrize("use_rope", [True, False], ids=["rope", "no-rope"])
def test_gqa_decode_at_zamba2_shared_attention(use_rope):
    """The shared block's decode attention at its real heads (and
    whisper's, without rotation), plain path against JAX: output and the
    cache rows written in place."""
    jc, tc, d = _attn_cfgs("zamba2_real")
    jp = jax.tree.map(np.asarray, jattn.init_gqa(jax.random.PRNGKey(4), jc, d, jnp.float32))
    B, T = 3, 24
    ck, cv = _x(14, (B, T, 32, 112)), _x(15, (B, T, 32, 112))
    x = _x(16, (B, 1, d))
    position = np.asarray([5, 0, 23], np.int32)
    jy, jk, jv = jattn.gqa_decode(jp, jnp.asarray(x), jnp.asarray(position), jnp.asarray(ck), jnp.asarray(cv),
                                  jc, use_rope=use_rope)
    tk, tv = t(ck.copy()), t(cv.copy())
    ty = tattn.gqa_decode({k: t(v) for k, v in jp.items()}, t(x), t(position), tk, tv, tc, use_rope=use_rope)
    assert_close(ty, jy)
    assert_close(tk, jk)
    assert_close(tv, jv)

