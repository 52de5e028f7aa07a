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
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_arch as tget  # noqa: E402
from repro_torch.models import LM as TLM  # noqa: E402
from repro_torch.serving import BatchingConfig, Request, ServingEngine  # noqa: E402

PROMPTS = [np.random.default_rng(s).integers(0, 512, 12).tolist() for s in range(3)]
MAX_NEW = 6


def _engines(mode: str, policy: str = "sieve", refresh: int = 2):
    jlm = JLM(proxy_arch(jget, mode), dtype=jnp.float32)
    jp = jlm.init(jax.random.PRNGKey(0))
    # two slots for three requests: slot reuse after a retire is exercised
    je = JEngine(jlm, jp, JBatching(n_slots=2, max_seq=48), policy=policy,
                 sieve_refresh_every=refresh)
    tlm = TLM(proxy_arch(tget, mode), dtype=torch.float32, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.float32)
    te = ServingEngine(tlm, tp, BatchingConfig(n_slots=2, max_seq=48), policy=policy,
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
    with pytest.raises(NotImplementedError):
        ServingEngine(tlm, p, BatchingConfig(n_slots=2, max_seq=16, paged=True))
    for kw in ({"telemetry": object()}, {"health": object()}):
        with pytest.raises(NotImplementedError):
            ServingEngine(tlm, p, BatchingConfig(n_slots=2, max_seq=16), **kw)
    eng = ServingEngine(tlm, p, BatchingConfig(n_slots=2, max_seq=16))
    for call in (lambda: eng.set_brownout_stage(2), lambda: eng.snapshot("x"), lambda: eng.restore("x")):
        with pytest.raises(NotImplementedError):
            call()
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit(Request(prompt=[1] * 17))
