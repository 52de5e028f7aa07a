"""The port's ServingEngine against the JAX engine on the qwen3-moe proxy:
same weights (through the bridge), same requests, same greedy tokens."""

import functools

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
    [("dual_path_cost", "sieve"), ("dual_path_cost", "dual_cost"), ("dual_path", "sieve"), ("dense", "sieve"),
     ("dual_path", "dual_threshold"), ("dual_path_cost", "pimoe")],
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
    """What the port refuses raises loudly; the runtime loop, once refused
    here, is ported: a measured engine, brownout and snapshots work, and
    bad arguments raise as in the JAX engine."""
    tlm = TLM(proxy_arch(tget), dtype=torch.float32, device="cpu")
    p = tlm.init(seed=0)
    with pytest.raises(ValueError, match="cost_source"):
        ServingEngine(tlm, p, BatchingConfig(n_slots=2, max_seq=16), cost_source="bogus")
    # the paged KV cache is ported: it builds and serves a request
    paged = ServingEngine(tlm, p, BatchingConfig(n_slots=2, max_seq=16, paged=True, page_size=4))
    paged.submit(Request(prompt=[1, 2, 3, 4, 5], max_new_tokens=3))
    (done,) = paged.run_until_done()
    assert len(done.generated) == 3 and paged.paged.n_free == paged.paged.n_pool - 1
    eng = ServingEngine(tlm, p, BatchingConfig(n_slots=2, max_seq=16), cost_source="measured")
    eng.set_brownout_stage(2)
    assert eng._sieve_gpu_only
    with pytest.raises(FileNotFoundError):
        eng.restore("no-such-snapshot-dir")
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit(Request(prompt=[1] * 17))


@functools.lru_cache(maxsize=None)
def _jax_run(paged: bool):
    """The JAX engine's greedy tokens on the proxy (dense or paged, page 8),
    with the torch LM and bridged weights of the same run, shared by the
    tests below so the JAX engine runs once per layout."""
    kw = dict(paged=True, page_size=8) if paged else {}
    je, te = _engines("dual_path_cost", **kw)
    return _tokens(je.run_until_done()), te.lm, te.params


def _fresh_engine(paged: bool) -> ServingEngine:
    """A torch engine as ``_engines`` builds it, with the prompts submitted."""
    _, lm, params = _jax_run(paged)
    kw = dict(paged=True, page_size=8) if paged else {}
    te = ServingEngine(lm, params, BatchingConfig(n_slots=2, max_seq=48, **kw), sieve_refresh_every=2)
    for p in PROMPTS:
        te.submit(Request(prompt=list(p), max_new_tokens=MAX_NEW))
    return te


def _decode_calls(te):
    """Wrap ``te._decode``: each call's input tensors (by name) are kept."""
    calls = []
    decode = te._decode

    def run(batch):
        calls.append({k: v for k, v in batch.items() if torch.is_tensor(v)})
        return decode(batch)

    te._decode = run
    return calls


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_decode_inputs_keep_their_address(paged):
    """The decode step reads its inputs from buffers allocated once: every
    step, through admits into a retired slot, page growth (page 8, prompts
    of 12 growing past 16) and retires, passes the same tensors at the same
    addresses, filled with that step's values.  Tokens still equal the JAX
    engine's."""
    te = _fresh_engine(paged)
    calls = _decode_calls(te)
    assert _tokens(te.run_until_done()) == _jax_run(paged)[0]
    names = {"tokens", "position"} | ({"block_tables", "pool_owner", "pool_pos"} if paged else set())
    assert len(calls) >= MAX_NEW + 2 and all(set(c) == names for c in calls)
    for name in names:
        assert len({c[name].data_ptr() for c in calls}) == 1
        assert all(c[name] is calls[0][name] for c in calls)
    assert te.sched.idle and len(te.sched.finished) == len(PROMPTS)
    if paged:
        assert int(calls[0]["block_tables"].max()) > 0  # blocks were mapped through the buffer


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_replay_reads_the_refilled_inputs(monkeypatch, paged):
    """The engine's replay branch on the CPU, with a stand-in for the CUDA
    graph that re-runs the captured call on the tensors it was captured
    with, into the captured outputs: tokens equal the JAX engine's only if
    every step refills those same tensors.  Each replay adds the launches
    the capture recorded, and the capture adds none."""
    from repro_torch.kernels import ops

    class Replay:
        """Re-runs ``LM.decode_step`` on the captured batch dict."""

        def __init__(self, eng, batch):
            self.eng, self.batch = eng, batch
            self.replays = 0

        def run(self):
            logits, _, aux = self.eng.lm.decode_step(self.eng.params, self.batch, self.eng.cache)
            return logits, aux

        def replay(self):
            self.replays += 1
            logits, aux = self.run()
            self.eng._graph_out[0].copy_(logits)
            for dst, src in zip(self.eng._graph_out[1], aux):
                dst.copy_(src)

    def capture(self, batch):
        graph = Replay(self, batch)
        with ops.recording_launches(self._graph_launches):
            ops.LAUNCHES["decode_attention"] += 1  # as a wrapper call inside a capture
            # rewriting the step's K/V rows with the same values changes nothing
            self._graph_out = graph.run()
        self._graph = graph

    monkeypatch.setattr(ServingEngine, "_capture", capture)
    te = _fresh_engine(paged)
    te._replay = True
    ops.reset_launches()
    assert _tokens(te.run_until_done()) == _jax_run(paged)[0]
    assert te._graph_launches == {k: int(k == "decode_attention") for k in ops.LAUNCHES}
    assert te._graph.replays >= MAX_NEW and ops.LAUNCHES["decode_attention"] == te._graph.replays
