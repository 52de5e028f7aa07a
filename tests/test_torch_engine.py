"""The port's ServingEngine against the JAX engine on the qwen3-moe proxy:
same weights (through the bridge), same requests, same greedy tokens."""

import numpy as np
import pytest
import torch

from _torch_port import pin_threads, proxy_arch

pin_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.serving import BatchingConfig as JBatching, Request as JRequest  # noqa: E402
from repro.serving import PagedKVCache as JPaged, ServingEngine as JEngine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_arch as tget  # noqa: E402
from repro_torch.models import LM as TLM  # noqa: E402
from repro_torch.serving import BatchingConfig, PagedKVCache, Request, ServingEngine  # noqa: E402

PROMPTS = [np.random.default_rng(s).integers(0, 512, 12).tolist() for s in range(3)]
MAX_NEW = 6


def _engines(mode: str, policy: str = "sieve", refresh: int = 2, **batching):
    jlm = JLM(proxy_arch(jget, mode), dtype=jnp.float32)
    jp = jlm.init(jax.random.PRNGKey(0))
    # two slots for three requests: slot reuse after a retire is exercised
    je = JEngine(jlm, jp, JBatching(n_slots=2, max_seq=48, **batching), policy=policy,
                 sieve_refresh_every=refresh)
    tlm = TLM(proxy_arch(tget, mode), dtype=torch.float32, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.float32)
    te = ServingEngine(tlm, tp, BatchingConfig(n_slots=2, max_seq=48, **batching), policy=policy,
                       sieve_refresh_every=refresh)
    for p in PROMPTS:
        je.submit(JRequest(prompt=list(p), max_new_tokens=MAX_NEW))
        te.submit(Request(prompt=list(p), max_new_tokens=MAX_NEW))
    return je, te


def _tokens(finished):
    return [r.generated for r in sorted(finished, key=lambda r: r.req_id)]


@pytest.mark.parametrize(
    "mode,policy",
    [("dual_path_cost", "sieve"), ("dual_path_cost", "dual_cost"), ("dual_path", "sieve"), ("dense", "sieve")],
)
def test_greedy_tokens_match_jax_engine(mode, policy):
    je, te = _engines(mode, policy)
    jt, tt = _tokens(je.run_until_done()), _tokens(te.run_until_done())
    assert tt == jt
    assert all(len(g) == MAX_NEW for g in tt)
    # the host scheduler fed the same cost table, refreshed at the same steps
    assert te.sieve_refreshes == je.sieve_refreshes
    assert te.stats.steps == je.stats.steps
    assert (te.stats.routed_tokens, te.stats.dropped_tokens) == (je.stats.routed_tokens, je.stats.dropped_tokens)
    assert te.stats.drop_rate == je.stats.drop_rate
    if mode != "dense":
        assert te.cost_table.version == je.cost_table.version
        np.testing.assert_array_equal(te.cost_table.export(64), je.cost_table.export(64))


@pytest.mark.parametrize("fused", ["1", "0"])
def test_paged_greedy_tokens_match_jax_engine(monkeypatch, fused):
    """Paged KV (page 8) on the fused and the three-call MoE path.  The
    JAX engine runs its Pallas kernels for the three-call path and its
    oracle paged attention: idle slots then attend over their trash-block
    row on both sides, as the TPU kernel does."""
    monkeypatch.setenv("REPRO_FUSED_SWIGLU", fused)
    monkeypatch.setenv("REPRO_FLASH_DECODE", "0")
    if fused == "0":
        monkeypatch.setenv("REPRO_DUAL_BACKEND", "pallas")
    je, te = _engines("dual_path_cost", paged=True, page_size=8)
    jt, tt = _tokens(je.run_until_done()), _tokens(te.run_until_done())
    assert tt == jt
    assert all(len(g) == MAX_NEW for g in tt)
    assert te.stats.steps == je.stats.steps
    assert (te.stats.routed_tokens, te.stats.dropped_tokens) == (je.stats.routed_tokens, je.stats.dropped_tokens)
    assert te.cost_table.version == je.cost_table.version
    np.testing.assert_array_equal(te.cost_table.export(64), je.cost_table.export(64))
    # every slot's blocks are back in the pool
    assert te.paged.n_free == te.paged.n_pool - 1 == 12
    assert (te.paged.block_table == PagedKVCache.TRASH).all() and (te.paged.owner == -1).all()
    assert te.paged.free_blocks == je.paged.free_blocks


def test_paged_kv_cache_matches_jax_allocator():
    """The same ensure / free_slot sequence gives the same block tables,
    owners, positions and free stack as the JAX allocator, and both raise
    when the pool runs out."""
    kw = dict(n_slots=3, max_seq=40, page_size=8, pool_blocks=10)
    jc, tc = JPaged(JBatching(paged=True, **kw)), PagedKVCache(BatchingConfig(paged=True, **kw))
    rng = np.random.default_rng(0)
    for _ in range(60):
        slot = int(rng.integers(0, 3))
        if rng.random() < 0.3:
            jc.free_slot(slot)
            tc.free_slot(slot)
        else:
            n = int(rng.integers(0, 41))
            jerr = terr = None
            try:
                jc.ensure(slot, n)
            except RuntimeError as e:
                jerr = e
            try:
                tc.ensure(slot, n)
            except RuntimeError as e:
                terr = e
            assert (jerr is None) == (terr is None)
        for name in ("block_table", "owner", "block_pos", "slot_blocks"):
            np.testing.assert_array_equal(getattr(tc, name), getattr(jc, name))
        assert tc.free_blocks == jc.free_blocks and tc.n_free == jc.n_free
        assert tc.n_free + int(tc.slot_blocks.sum()) == tc.n_pool - 1
    assert BatchingConfig(max_seq=1024, page_size=16).blocks_per_slot == 64
    assert BatchingConfig(n_slots=8, max_seq=1024).resolved_pool_blocks() == 513
    with pytest.raises(ValueError, match="pool_blocks"):
        PagedKVCache(BatchingConfig(paged=True, pool_blocks=1))


def test_sieve_state_refreshes_in_place():
    _, te = _engines("dual_path_cost", refresh=3)
    state = te._sieve_state
    table, params = state.pim_time_by_count, state.params
    assert te.sieve_refreshes == [0]
    te.step()
    te.step()
    assert te.sieve_refreshes == [0]  # stale between boundaries
    for c in range(1, te._sieve_max_count + 1):
        te.cost_table.update(c, 1.0)
    before = table.clone()
    te.step()  # boundary: re-export into the same tensors
    assert te.sieve_refreshes == [0, 3]
    assert te._sieve_state.pim_time_by_count is table and te._sieve_state.params is params
    assert not torch.equal(before, table) and float(table[-1]) == 1.0


def test_kv_cache_updated_in_place():
    _, te = _engines("dense")
    k0 = te.cache["blocks"][0]
    ptr = k0.data_ptr()
    te.run_until_done()
    assert te.cache["blocks"][0] is k0 and k0.data_ptr() == ptr
    assert k0.abs().sum() > 0


def test_unported_features_raise():
    tlm = TLM(proxy_arch(tget), dtype=torch.float32, device="cpu")
    p = tlm.init(seed=0)
    with pytest.raises(NotImplementedError):
        ServingEngine(tlm, p, BatchingConfig(n_slots=2, max_seq=16), cost_source="measured")
    # the paged KV cache is ported: it builds and serves a request
    paged = ServingEngine(tlm, p, BatchingConfig(n_slots=2, max_seq=16, paged=True, page_size=4))
    paged.submit(Request(prompt=[1, 2, 3, 4, 5], max_new_tokens=3))
    (done,) = paged.run_until_done()
    assert len(done.generated) == 3 and paged.paged.n_free == paged.paged.n_pool - 1
    for kw in ({"telemetry": object()}, {"health": object()}):
        with pytest.raises(NotImplementedError):
            ServingEngine(tlm, p, BatchingConfig(n_slots=2, max_seq=16), **kw)
    eng = ServingEngine(tlm, p, BatchingConfig(n_slots=2, max_seq=16))
    for call in (lambda: eng.set_brownout_stage(2), lambda: eng.snapshot("x"), lambda: eng.restore("x")):
        with pytest.raises(NotImplementedError):
            call()
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit(Request(prompt=[1] * 17))
