"""Every scheduling policy of the port against the JAX package's.

The port's ``core/scheduler.py`` and ``core/cost_model.py`` are copies of
the JAX package's: on the same counts and cost table each policy must
give the same expert ids, iteration count and meta, and bit-identical
times.  Each function is held to its own JAX counterpart only (a
vectorized form is never held to a scalar oracle: the two sum in other
orders).  The on-device split (``sieve_partition_torch``/``_dynamic``)
must give JAX's integer outputs exactly, and the engine's host decision
trail under each policy must be JAX's ``schedule`` on the counts the
engine saw."""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_port import pin_threads, proxy_arch, t

pin_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget  # noqa: E402
from repro.core import cost_model as jcm, cost_table as jct  # noqa: E402
from repro.core import scheduler as jsched, scheduler_jax as jsj  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.sim.dram import PimGemvModel as JPim  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_arch as tget  # noqa: E402
from repro_torch.core import cost_model as tcm, cost_table as tct  # noqa: E402
from repro_torch.core import scheduler as tsched, scheduler_torch as tst  # noqa: E402
from repro_torch.models import LM as TLM  # noqa: E402
from repro_torch.serving import BatchingConfig, Request, ServingEngine  # noqa: E402
from repro_torch.sim.dram import PimGemvModel as TPim  # noqa: E402

# (d_model, d_ff, top_k) by expert count: the reduced proxy, qwen3-moe,
# deepseek-v2
SHAPES = {8: (64, 32, 2), 128: (2048, 768, 8), 160: (5120, 1536, 6)}
POLICIES = tsched.POLICIES


def _pair(E: int, ep_degree: int = 1, **kw):
    """The same cost model in both packages (``ep_degree > 1`` gives a
    nonzero T_Comm)."""
    d, f, k = SHAPES[E]
    out = []
    for m in (jcm, tcm):
        system = m.b200_pim_system()
        out.append(m.CostModel(system=system, layer=m.MoELayerSpec(d_model=d, d_ff=f, n_experts=E, top_k=k),
                               ep_degree=ep_degree, **kw))
    return out


def _tables(jm, tm, seed: int):
    """The same EMA observations fed to both packages' cost tables."""
    jt = jct.CostTable(fallback=jm.t_pim_gemv_roofline)
    tt = tct.CostTable(fallback=tm.t_pim_gemv_roofline)
    jpim, tpim = JPim(jm.system.pim), TPim(tm.system.pim)
    rng = np.random.default_rng(1000 + seed)
    for n in rng.integers(1, 80, 40).tolist():
        scale = float(rng.uniform(0.5, 3.0))
        jt.update(n, jpim.expert_time(jm.layer, n) * scale)
        tt.update(n, tpim.expert_time(tm.layer, n) * scale)
    return jt, tt


def _bimodal(E: int, seed: int) -> np.ndarray:
    """A few hot experts with many tokens, most with zero to two."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 3, E)
    hot = rng.choice(E, max(1, E // 8), replace=False)
    counts[hot] = rng.integers(4, 96, hot.size)
    return counts.astype(np.int64)


def _same(jp, tp) -> None:
    np.testing.assert_array_equal(jp.gpu_experts, tp.gpu_experts)
    np.testing.assert_array_equal(jp.pim_experts, tp.pim_experts)
    assert jp.gpu_experts.dtype == tp.gpu_experts.dtype
    assert (jp.iterations, jp.policy, jp.meta) == (tp.iterations, tp.policy, tp.meta)
    # bit-identical, not close
    assert (jp.t_comm, jp.t_gpu, jp.t_pim) == (tp.t_comm, tp.t_gpu, tp.t_pim)
    assert jp.t_total == tp.t_total


def _kw(policy: str, seed: int) -> dict:
    if policy in ("dual_threshold", "dual_cost"):
        return {"tail_tokens": 1 + seed % 3, "max_head": (0, 3, 12)[seed % 3]}
    return {}


@pytest.mark.parametrize("table", [False, True], ids=["roofline", "table"])
@pytest.mark.parametrize("E", sorted(SHAPES))
@pytest.mark.parametrize("policy", POLICIES)
def test_schedule_matches_jax(policy, E, table):
    jm, tm = _pair(E, ep_degree=4)
    for seed in range(4):
        jt, tt = _tables(jm, tm, seed) if table else (None, None)
        counts = _bimodal(E, seed)
        kw = _kw(policy, seed)
        _same(jsched.schedule(policy, counts, jm, jt, **kw), tsched.schedule(policy, counts, tm, tt, **kw))
    # an empty layer (no routed token) too
    zeros = np.zeros(E, np.int64)
    _same(jsched.schedule(policy, zeros, jm, None, **_kw(policy, 0)),
          tsched.schedule(policy, zeros, tm, None, **_kw(policy, 0)))


@pytest.mark.parametrize("batch,seq", [(0, 0), (8, 512), (32, 4096)])
def test_gpu_only_with_attention_spec(batch, seq):
    jm, tm = _pair(128)
    dims = dict(d_model=2048, n_heads=32, n_kv_heads=4, d_head=128)
    counts = _bimodal(128, 3)
    jp = jsched.schedule("gpu_only", counts, jm, attn_spec=jcm.AttnLayerSpec(**dims), batch=batch, seq=seq)
    tp = tsched.schedule("gpu_only", counts, tm, attn_spec=tcm.AttnLayerSpec(**dims), batch=batch, seq=seq)
    _same(jp, tp)


@pytest.mark.parametrize("form", ["ids", "mask"])
def test_pimoe_static_partition(form):
    jm, tm = _pair(128)
    jt, tt = _tables(jm, tm, 0)
    pinned = jsched.pimoe_schedule(_bimodal(128, 0), jm, jt).pim_experts
    if form == "mask":
        mask = np.zeros(128, np.bool_)
        mask[pinned] = True
        pinned = mask
    else:
        pinned = pinned.tolist()
    for seed in range(1, 4):  # the runtime distribution shifts away from calibration
        counts = _bimodal(128, seed)
        _same(jsched.pimoe_static_partition(counts, pinned, jm, jt),
              tsched.pimoe_static_partition(counts, pinned, tm, tt))


REFERENCES = [
    ("sieve_schedule_reference", {"mode": "greedy"}),
    ("sieve_schedule_reference", {"mode": "argmin"}),
    ("dual_cost_schedule_reference", {"mode": "argmin", "tail_tokens": 1, "max_head": 0}),
    ("dual_cost_schedule_reference", {"mode": "greedy", "tail_tokens": 2, "max_head": 3}),
    ("pimoe_schedule_reference", {}),
    ("brute_force_schedule", {}),
]


@pytest.mark.parametrize("name,kw", REFERENCES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(REFERENCES)])
def test_scalar_reference_matches_jax(name, kw):
    """Each scalar oracle against its own JAX counterpart (brute force at
    E = 8: 2^|E| splits)."""
    E = 8 if name == "brute_force_schedule" else 128
    jm, tm = _pair(E, ep_degree=2)
    for seed in range(3):
        jt, tt = _tables(jm, tm, seed) if seed else (None, None)
        counts = _bimodal(E, seed)
        _same(getattr(jsched, name)(counts, jm, jt, **kw), getattr(tsched, name)(counts, tm, tt, **kw))


def test_unknown_modes_raise():
    _, tm = _pair(8)
    for fn in (tsched.sieve_schedule, tsched.sieve_schedule_reference, tsched.dual_cost_schedule):
        with pytest.raises(ValueError, match="unknown mode"):
            fn(np.ones(8), tm, mode="best")
    with pytest.raises(ValueError, match="small"):
        tsched.brute_force_schedule(np.ones(20), _pair(128)[1])


def test_cost_model_methods_match_jax():
    """The methods the port had cut: T_GPU's two terms, T_PIM, T_total,
    the attention placements, the xPU helpers, ``SystemSpec.replace`` and
    the TPU v5e system, all bit-identical."""
    jm, tm = _pair(128, ep_degree=8, gpu_base_flops=3e9, gpu_base_bytes=2e8, pim_attn_time=4e-6)
    jt, tt = _tables(jm, tm, 5)
    rng = np.random.default_rng(0)
    for _ in range(20):
        g = rng.integers(0, 300, int(rng.integers(0, 30)))
        p = rng.integers(0, 40, int(rng.integers(0, 60)))
        for name in ("t_gpu_offchip", "t_gpu_comp", "t_gpu"):
            assert getattr(jm, name)(g) == getattr(tm, name)(g)
        assert jm.t_pim(p) == tm.t_pim(p) and jm.t_pim(p, jt) == tm.t_pim(p, tt)
        n = int(g.sum() + p.sum())
        assert jm.t_total(g, p, n) == tm.t_total(g, p, n) and jm.t_total(g, p, n, jt) == tm.t_total(g, p, n, tt)
    jx, tx = jm.system.xpu, tm.system.xpu
    for n in (0, 1, 127, 128, 129, 1000):
        assert jx.padded_rows(n) == tx.padded_rows(n)
        assert jx.gemm_time(n * 1e9) == tx.gemm_time(n * 1e9)
    dims = dict(d_model=5120, n_heads=128, n_kv_heads=128, d_head=128)
    ja, ta = jcm.AttnLayerSpec(**dims), tcm.AttnLayerSpec(**dims)
    assert ja.qkvo_param_bytes() == ta.qkvo_param_bytes()
    for b, s in ((1, 1), (8, 1024), (64, 32768)):
        assert ja.kv_bytes(b, s) == ta.kv_bytes(b, s) and ja.decode_flops(b, s) == ta.decode_flops(b, s)
        for fn in ("attention_time_on_pim", "attention_time_on_xpu"):
            assert getattr(jcm, fn)(jm.system, ja, b, s) == getattr(tcm, fn)(tm.system, ta, b, s)
    jv, tv = jcm.tpu_v5e_system(4), tcm.tpu_v5e_system(4)
    assert dataclasses.asdict(jv) == dataclasses.asdict(tv) and tv.pim is None
    for fn in (tcm.attention_time_on_pim,):
        with pytest.raises(ValueError, match="no PIM"):
            fn(tv, ta, 1, 1)
    assert jcm.attention_time_on_xpu(jv, ja, 8, 1024) == tcm.attention_time_on_xpu(tv, ta, 8, 1024)
    assert dataclasses.asdict(jm.system.replace(n_devices=3)) == dataclasses.asdict(tm.system.replace(n_devices=3))


# ---------------------------------------------------------------------------
# The on-device greedy split
# ---------------------------------------------------------------------------

INT_KEYS = ("gpu_mask", "order", "rank", "split", "n_active")


@pytest.mark.parametrize("mode", ["greedy", "argmin"])
@pytest.mark.parametrize("E", sorted(SHAPES))
def test_sieve_partition_matches_jax(E, mode):
    jm, _ = _pair(E, ep_degree=2)
    for seed in range(6):
        counts = _bimodal(E, seed).astype(np.int32)
        jt = _tables(jm, _pair(E)[1], seed)[0] if seed % 2 else None
        state = jsj.make_sieve_state(jt, jm, 128, total_routed_tokens=int(counts.sum()))
        params = jsj.SieveParams.from_cost_model(jm, int(counts.sum()))
        pim, arr = np.asarray(state.pim_time_by_count), np.asarray(state.params)
        tparams = tst.SieveParams.from_array(params.to_array())
        np.testing.assert_array_equal(tparams.to_array(), params.to_array())
        pairs = (
            (jsj.sieve_partition_jax(jnp.asarray(counts), jnp.asarray(pim), params, mode=mode),
             tst.sieve_partition_torch(t(counts), t(pim), tparams, mode=mode)),
            (jsj.sieve_partition_dynamic(jnp.asarray(counts), jnp.asarray(pim), jnp.asarray(arr), mode=mode),
             tst.sieve_partition_dynamic(t(counts), t(pim), t(arr), mode=mode)),
        )
        for jr, tr in pairs:
            for key in INT_KEYS:
                np.testing.assert_array_equal(np.asarray(jr[key]), tr[key].numpy(), err_msg=key)
            assert float(jr["t_comm"]) == float(tr["t_comm"])


def test_sieve_partition_rejects_unknown_mode():
    state = tst.make_sieve_state(None, _pair(8)[1], 16, device="cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        tst.sieve_partition_dynamic(t(np.ones(8, np.int32)), *state, mode="best")


# ---------------------------------------------------------------------------
# The engine's host decision trail under every policy
# ---------------------------------------------------------------------------

PROMPTS = [np.random.default_rng(s).integers(0, 512, 12).tolist() for s in range(3)]


@pytest.fixture(scope="module")
def proxy_weights():
    jlm = JLM(proxy_arch(jget), dtype=jnp.float32)
    jp = jlm.init(jax.random.PRNGKey(0))
    return params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.float32)


def _serve(params, policy: str):
    """The port's engine on the proxy under ``policy``, recording the
    per-layer counts each host pass saw."""
    lm = TLM(proxy_arch(tget), dtype=torch.float32, device="cpu")
    eng = ServingEngine(lm, params, BatchingConfig(n_slots=2, max_seq=48), policy=policy, sieve_refresh_every=2)
    seen, run_sieve = [], eng._run_sieve

    def recorded(counts):
        seen.append(np.array(counts))
        run_sieve(counts)

    eng._run_sieve = recorded
    for p in PROMPTS:
        eng.submit(Request(prompt=list(p), max_new_tokens=6))
    finished = eng.run_until_done()
    return eng, seen, [r.generated for r in sorted(finished, key=lambda r: r.req_id)]


@pytest.fixture(scope="module")
def sieve_tokens(proxy_weights):
    return _serve(proxy_weights, "sieve")[2]


@pytest.mark.parametrize("policy", POLICIES)
def test_engine_partitions_match_jax_schedule(proxy_weights, sieve_tokens, policy):
    """The port engine's ``stats.partitions`` equal JAX's ``schedule`` run
    over the counts that engine recorded, with a JAX cost table fed the
    way the engine feeds its own (DRAM-timing model times of each chosen
    PIM set); the dual-path rules get the decode step's window.  The
    split the decode step runs does not depend on the host policy, so the
    tokens equal the default policy's."""
    eng, seen, tokens = _serve(proxy_weights, policy)
    assert tokens == sieve_tokens
    moe = eng.lm.arch.moe
    jm = jcm.CostModel(system=jcm.b200_pim_system(), layer=jcm.MoELayerSpec(
        d_model=eng.lm.arch.d_model, d_ff=moe.d_expert, n_experts=moe.n_experts, top_k=moe.top_k,
        n_shared=moe.n_shared))
    jt, jpim = jct.CostTable(fallback=jm.t_pim_gemv_roofline), JPim(jm.system.pim)
    kw = ({"tail_tokens": moe.dual_tail_tokens, "max_head": moe.dual_max_head}
          if policy in ("dual_threshold", "dual_cost") else {})
    want = []
    for counts in seen:
        for li, c in enumerate(counts):
            part = jsched.schedule(policy, c, jm, jt, **kw)
            for e in part.pim_experts:
                if c[e] > 0:
                    jt.update(int(c[e]), jpim.expert_time(jm.layer, int(c[e])))
            want.append((li, len(part.gpu_experts), len(part.pim_experts), part.t_total))
    got = [(p["layer"], p["n_gpu"], p["n_pim"], p["t_total_est"]) for p in eng.stats.partitions]
    assert len(seen) > 0 and got == want
    np.testing.assert_array_equal(eng.cost_table.export(64), jt.export(64))
