"""The hybrid, ssm and audio families in the port against the JAX
reference, through ``LM.prefill`` and ``LM.decode_step`` as
tests/test_consistency.py and tests/test_models_smoke.py drive them (the
JAX ``ServingEngine`` cannot serve them; the port's refuses them).

Models are JAX's ``reduced()`` zamba2-7b (5 blocks: two segments of the
shared attention and one Mamba2 block, and a 1-block Mamba2 tail),
rwkv6-7b (2 blocks) and whisper-base (2 encoder and 2 decoder layers over
16 frames), in float32 with the JAX weights crossing through
``repro_torch.bridge``.  Each family's JAX run (prefill, then 8 decode
steps fed seeded tokens) happens once, in a module fixture."""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_port import F32_TOL, assert_close, pin_threads, t

pin_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_arch as tget  # noqa: E402
from repro_torch.models import LM as TLM  # noqa: E402
from repro_torch.serving import BatchingConfig, ServingEngine  # noqa: E402

NAMES = ("zamba2-7b", "rwkv6-7b", "whisper-base")
B, S, STEPS = 2, 12, 8  # batch, prompt, decode steps
T = S + STEPS  # positions of the decode cache
FRAMES = 16  # whisper's encoder frames (its reduced enc_seq)
KV_KEYS = ("attn", "self")  # cache entries with a position axis (axis 2)


def _inputs(name: str, vocab: int, d_model: int):
    rng = np.random.default_rng(7)
    out = {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
           "steps": rng.integers(0, vocab, (STEPS, B, 1)).astype(np.int32)}
    if name == "whisper-base":
        out["embeds"] = (rng.standard_normal((B, FRAMES, d_model)) * 0.1).astype(np.float32)
    return out


def _close_leaf(got, want) -> None:
    """A cache leaf within ``F32_TOL`` of the JAX one, on values scaled to
    at most 1: a WKV state holds values up to ~6 after 20 steps, and the
    two frameworks' sums of its updates differ by a few float32 ulps of
    that magnitude in its small entries too."""
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    assert_close(got.float() / scale, want / scale, **F32_TOL)


def _leaves(cache: dict) -> list:
    """A cache's leaves in the key order of the JAX tree (sorted keys)."""
    return [leaf for key in sorted(cache) for leaf in cache[key]]


def _jax_decode_cache(jc: dict) -> dict:
    """The JAX prefill cache with its K/V padded to T positions: the cache
    the port's ``prefill(max_seq=T)`` returns."""
    out = dict(jc)
    for key in KV_KEYS:
        if key in jc:
            out[key] = tuple(jnp.zeros(a.shape[:2] + (T,) + a.shape[3:], a.dtype).at[:, :, :S].set(a)
                             for a in jc[key])
    return out


@pytest.fixture(scope="module", params=NAMES)
def run(request):
    """The JAX model and weights, its prefill and 8 decode steps."""
    name = request.param
    jlm = JLM(jget(name).reduced(), dtype=jnp.float32, q_chunk=4, kv_chunk=4)
    tree = jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(0)))
    jp = jax.tree.map(jnp.asarray, tree)
    x = _inputs(name, jlm.arch.vocab_size, jlm.arch.d_model)
    batch = {k: jnp.asarray(v) for k, v in x.items() if k != "steps"}
    logits, cache, _ = jax.jit(jlm.prefill)(jp, batch)
    step = jax.jit(jlm.decode_step)
    dcache, steps = _jax_decode_cache(cache), []
    for i in range(STEPS):
        db = {"tokens": jnp.asarray(x["steps"][i]), "position": jnp.full((B,), S + i, jnp.int32)}
        lg, dcache, _ = step(jp, db, dcache)
        steps.append((np.asarray(lg), [np.asarray(a) for a in jax.tree.leaves(dcache)]))
    return dict(name=name, tree=tree, inputs=x, logits=np.asarray(logits),
                cache=[np.asarray(a) for a in jax.tree.leaves(cache)], steps=steps)


def _port(run, dtype=torch.float32):
    tlm = TLM(tget(run["name"]).reduced(), dtype=dtype, device="cpu", q_chunk=4, kv_chunk=4)
    return tlm, params_from_numpy(run["tree"], "cpu", dtype)


def _prompt(run) -> dict:
    return {k: t(v).long() if k == "tokens" else t(v) for k, v in run["inputs"].items() if k != "steps"}


@pytest.mark.parametrize("name", NAMES)
def test_config_matches_jax(name):
    """Every field of the port's config, and of its reduced config, equals
    the JAX one's."""
    for ta, ja in ((tget(name), jget(name)), (tget(name).reduced(), jget(name).reduced())):
        for f in dataclasses.fields(ta):
            tv, jv = getattr(ta, f.name), getattr(ja, f.name)
            if dataclasses.is_dataclass(tv):
                assert dataclasses.asdict(tv) == dataclasses.asdict(jv), f.name
            else:
                assert tv == jv, f.name
    assert {f.name for f in dataclasses.fields(tget(name))} == {f.name for f in dataclasses.fields(jget(name))}


def test_prefill_matches_jax(run):
    """The last position's logits and every leaf of the prompt cache."""
    tlm, tp = _port(run)
    logits, cache, aux = tlm.prefill(tp, _prompt(run))
    assert_close(logits, run["logits"])
    got = _leaves(cache)
    assert len(got) == len(run["cache"])
    for a, b in zip(got, run["cache"]):
        assert tuple(a.shape) == b.shape
        _close_leaf(a, b)
    assert aux.counts.shape == (0, 1) and int(aux.dropped) == 0


def test_decode_steps_match_jax(run):
    """``prefill(max_seq=T)`` then 8 decode steps: each step's logits and
    every state and K/V leaf, updated in place at fixed addresses."""
    tlm, tp = _port(run)
    _, cache, _ = tlm.prefill(tp, _prompt(run), max_seq=T)
    leaves = _leaves(cache)
    ptrs = [a.data_ptr() for a in leaves]
    for i, (want_logits, want_leaves) in enumerate(run["steps"]):
        batch = {"tokens": t(run["inputs"]["steps"][i]).long(), "position": torch.full((B,), S + i, dtype=torch.int32)}
        logits, out, _ = tlm.decode_step(tp, batch, cache)
        assert out is cache
        assert_close(logits, want_logits)
        for a, b in zip(_leaves(cache), want_leaves):
            _close_leaf(a, b)
    assert [a.data_ptr() for a in _leaves(cache)] == ptrs


def test_prefill_equals_stepwise_decode(run):
    """The port's prefill logits against its own decode fed the prompt one
    token at a time from an empty cache (whisper: with the prefill's cross
    K/V), by tests/test_consistency.py's bound."""
    tlm, tp = _port(run)
    prompt = _prompt(run)
    logits_pf, pcache, _ = tlm.prefill(tp, prompt)
    cache = tlm.init_cache(B, S)
    if tlm.arch.family == "audio":
        cache["cross"] = pcache["cross"]
    for i in range(S):
        batch = {"tokens": prompt["tokens"][:, i:i + 1], "position": torch.full((B,), i, dtype=torch.int32)}
        logits, cache, _ = tlm.decode_step(tp, batch, cache)
    V = tlm.arch.vocab_size
    a, b = logits_pf[:, 0, :V], logits[:, 0, :V]
    rel = float((a - b).abs().max() / (a.abs().max() + 1e-9))
    assert rel < 2e-3, rel


def test_bridge_trees_and_float32_leaves(run):
    """zamba2's ``mamba_seg`` becomes a list of segments of blocks, the
    other stacked trees lists of blocks, ``shared_attn`` one dict; at bf16
    every leaf the JAX init keeps in float32 stays float32 and every other
    floating leaf takes bf16."""
    name = run["name"]
    tlm, tp = _port(run, torch.bfloat16)
    a = tlm.arch
    if name == "zamba2-7b":
        assert [len(seg) for seg in tp["mamba_seg"]] == [1, 1] and len(tp["mamba_tail"]) == 1
        assert isinstance(tp["shared_attn"], dict) and "mamba" in tp["mamba_seg"][1][0]
    elif name == "rwkv6-7b":
        assert len(tp["blocks"]) == a.n_layers and "rwkv" in tp["blocks"][0]
    else:
        assert len(tp["enc_blocks"]) == a.enc_layers and len(tp["blocks"]) == a.n_layers
        assert tuple(tp["dec_pos"].shape) == (448, a.d_model)
    jtree = JLM(jget(name).reduced(), dtype=jnp.bfloat16).init(jax.random.PRNGKey(0))
    jdtypes = jax.tree.map(lambda x: str(x.dtype), jtree)

    def walk(tp_node, jd):
        if isinstance(tp_node, dict):
            for k in tp_node:
                walk(tp_node[k], jd[k])
        elif isinstance(tp_node, list):  # a stacked tree's blocks share its dtypes
            for node in tp_node:
                walk(node, jd)
        else:
            want = torch.float32 if jd == "float32" else torch.bfloat16
            assert tp_node.dtype == want, (jd, tp_node.dtype)

    walk(tp, jdtypes)
    # and the port's own init keeps the same leaves in float32
    walk(TLM(a, dtype=torch.bfloat16, device="cpu").init(seed=0), jdtypes)


def test_init_mirrors_the_jax_tree_and_is_seeded(run):
    """``init`` and ``init(keyed=True)`` give the bridged JAX tree's leaves
    and shapes; each is a function of the seed."""
    tlm, tp = _port(run)
    shapes = lambda tree: jax.tree.map(lambda x: tuple(x.shape), tree)  # noqa: E731
    for keyed in (False, True):
        p0, p1 = tlm.init(seed=3, keyed=keyed), tlm.init(seed=3, keyed=keyed)
        assert shapes(p0) == shapes(tp)
        assert all(torch.equal(x, y) for x, y in zip(jax.tree.leaves(p0), jax.tree.leaves(p1)))
        assert not torch.equal(p0["embed"], tlm.init(seed=4, keyed=keyed)["embed"])
    keyed = tlm.init(seed=3, keyed=True)
    for name, leaf in (("A_log", "mamba"), ("w0", "rwkv")):
        blocks = [b for seg in keyed.get("mamba_seg", []) for b in seg] + keyed.get("blocks", [])
        for blk in blocks:
            if leaf in blk:
                want = torch.log(torch.linspace(1.0, 16.0, blk[leaf][name].shape[0])) if name == "A_log" else -6.0
                assert torch.allclose(blk[leaf][name], torch.as_tensor(want)), name


@pytest.mark.parametrize("name", NAMES)
def test_kv_int8_is_off_for_the_recurrent_families(name, monkeypatch):
    """``REPRO_KV_INT8=1`` quantises the cache of the GQA decoder-only
    families only, as the reference's ``init_cache`` does: zamba2's shared
    attention and whisper's self-attention keep model-dtype K/V."""
    monkeypatch.setenv("REPRO_KV_INT8", "1")
    tlm = TLM(tget(name).reduced(), dtype=torch.float32, device="cpu")
    assert not tlm._kv_int8()
    jcache = JLM(jget(name).reduced(), dtype=jnp.float32).init_cache(B, T)
    tcache = tlm.init_cache(B, T)
    assert [str(a.dtype).removeprefix("torch.") for a in _leaves(tcache)] == [
        str(a.dtype) for a in jax.tree.leaves(jcache)]
    assert [tuple(a.shape) for a in _leaves(tcache)] == [a.shape for a in jax.tree.leaves(jcache)]


@pytest.mark.parametrize("name", NAMES)
def test_serving_engine_refuses_them(name):
    tlm = TLM(tget(name).reduced(), dtype=torch.float32, device="cpu")
    with pytest.raises(NotImplementedError, match="slot insert"):
        ServingEngine(tlm, tlm.init(seed=0), BatchingConfig(n_slots=2, max_seq=32))


@pytest.mark.parametrize("name", NAMES)
def test_cuda_default_raises_without_a_gpu(name):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TLM(tget(name))


def test_prefill_refuses_a_short_cache_and_whisper_decodes_from_its_stub(run):
    tlm, tp = _port(run)
    with pytest.raises(ValueError, match="cannot hold"):
        tlm.prefill(tp, _prompt(run), max_seq=S - 1)
    if tlm.arch.family == "audio":
        stub = tlm.stub_inputs(B, FRAMES, seed=1)
        assert tuple(stub["embeds"].shape) == (B, FRAMES, tlm.arch.d_model) and set(stub) == {"embeds"}
        logits, cache, _ = tlm.prefill(tp, dict(stub, tokens=_prompt(run)["tokens"]), max_seq=T)
        assert torch.isfinite(logits).all() and tuple(cache["cross"][0].shape[2:4]) == (FRAMES, 4)
