"""The port's cost stack and Sieve split against the JAX package: the host
copies (cost model, cost table, PIM timing model, scheduler policies) must
agree bit for bit, the on-device split on masks, order, rank and drops."""

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as st

from _torch_port import pin_threads, t

pin_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import cost_model as jcm, cost_table as jct  # noqa: E402
from repro.core import scheduler as jsched, scheduler_jax as jsj  # noqa: E402
from repro.sim.dram import PimGemvModel as JPim  # noqa: E402
from repro_torch.core import cost_model as tcm, cost_table as tct  # noqa: E402
from repro_torch.core import scheduler as tsched, scheduler_torch as tst  # noqa: E402
from repro_torch.sim.dram import PimGemvModel as TPim  # noqa: E402

LAYER = dict(d_model=2048, d_ff=768, n_experts=128, top_k=8)


def _models(cm_mod):
    return cm_mod.CostModel(
        system=cm_mod.b200_pim_system(), layer=cm_mod.MoELayerSpec(**LAYER)
    )


def _tables(seed: int):
    """The same EMA observations fed to both packages' cost tables."""
    jm, tm = _models(jcm), _models(tcm)
    jt = jct.CostTable(fallback=jm.t_pim_gemv_roofline)
    tt = tct.CostTable(fallback=tm.t_pim_gemv_roofline)
    jpim, tpim = JPim(jm.system.pim), TPim(tm.system.pim)
    rng = np.random.default_rng(seed)
    for n in rng.integers(1, 40, 30).tolist():
        scale = float(rng.uniform(0.5, 3.0))
        jt.update(n, jpim.expert_time(jm.layer, n) * scale)
        tt.update(n, tpim.expert_time(tm.layer, n) * scale)
    return jm, tm, jt, tt


class TestHostCopies:
    def test_pim_model_and_cost_table_bit_identical(self):
        jm, tm, jt, tt = _tables(0)
        for n in range(0, 70):
            assert JPim(jm.system.pim).expert_time(jm.layer, n) == TPim(tm.system.pim).expert_time(tm.layer, n)
        np.testing.assert_array_equal(jt.export(256), tt.export(256))
        assert jt.version == tt.version
        counts = np.arange(0, 90)
        np.testing.assert_array_equal(jt.lookup_vec(counts), tt.lookup_vec(counts))

    def test_cost_table_rejects_bad_observations(self):
        tt = tct.CostTable(fallback=lambda n: 1.0)
        tt.update(3, float("nan"))
        assert tt.n_rejected == 1 and tt.version == 0
        with pytest.raises(ValueError):
            tt.update(3, -1.0)

    def test_sieve_params_and_state_export(self):
        jm, tm, jt, tt = _tables(1)
        np.testing.assert_array_equal(
            jsj.SieveParams.from_cost_model(jm, 64).to_array(),
            tst.SieveParams.from_cost_model(tm, 64).to_array(),
        )
        js = jsj.make_sieve_state(jt, jm, 300, total_routed_tokens=64)
        ts = tst.make_sieve_state(tt, tm, 300, total_routed_tokens=64, device="cpu")
        np.testing.assert_array_equal(js.pim_time_by_count, ts.pim_time_by_count.numpy())
        np.testing.assert_array_equal(js.params, ts.params.numpy())
        np.testing.assert_array_equal(
            jsj.export_cost_table(None, jm, 100), tst.export_cost_table(None, tm, 100)
        )

    @settings(max_examples=20, deadline=None, database=None)
    @given(seed=st.integers(0, 10_000), max_head=st.integers(0, 12))
    def test_schedule_policies_bit_identical(self, seed, max_head):
        jm, tm, jt, tt = _tables(seed % 7)
        counts = np.random.default_rng(seed).integers(0, 5, 128) * (
            np.random.default_rng(seed + 1).random(128) < 0.4
        )
        for policy, kw in (("sieve", {}), ("dual_cost", {"tail_tokens": 1, "max_head": max_head})):
            jp = jsched.schedule(policy, counts, jm, jt, **kw)
            tp = tsched.schedule(policy, counts, tm, tt, **kw)
            np.testing.assert_array_equal(jp.gpu_experts, tp.gpu_experts)
            np.testing.assert_array_equal(jp.pim_experts, tp.pim_experts)
            assert (jp.t_gpu, jp.t_pim, jp.t_comm) == (tp.t_gpu, tp.t_pim, tp.t_comm)

    def test_unported_policy_raises(self):
        with pytest.raises(ValueError, match="not ported"):
            tsched.schedule("pimoe", np.ones(8), _models(tcm))


def _state(seed: int, maxc: int = 64):
    jm, _, jt, _ = _tables(seed)
    s = jsj.make_sieve_state(jt, jm, maxc, total_routed_tokens=64)
    return np.asarray(s.pim_time_by_count), np.asarray(s.params)


class TestDevicesplit:
    @settings(max_examples=40, deadline=None, database=None)
    @given(
        seed=st.integers(0, 100_000),
        e_pick=st.integers(0, 1),
        cap_pick=st.integers(0, 2),
    )
    def test_dual_path_split_cost_matches_jax(self, seed, e_pick, cap_pick):
        E = (16, 128)[e_pick]
        max_head = (None, 3, 0)[cap_pick]
        rng = np.random.default_rng(seed)
        rows = (rng.integers(0, 6, E) * (rng.random(E) < 0.5)).astype(np.int32)
        pim, params = _state(seed % 5)
        jr = jsj.dual_path_split_cost(
            jnp.asarray(rows), jnp.asarray(pim), jnp.asarray(params),
            tail_tokens=1, max_head=max_head,
        )
        tr = tst.dual_path_split_cost(t(rows), t(pim), t(params), tail_tokens=1, max_head=max_head)
        # popularity order and rank are integer sorts: exact
        np.testing.assert_array_equal(np.asarray(jr["order"]), tr["order"].numpy())
        np.testing.assert_array_equal(np.asarray(jr["rank"]), tr["rank"].numpy())
        assert int(jr["n_dropped"]) == int(tr["n_dropped"])
        if int(jr["split"]) == int(tr["split"]):
            for key in ("head_mask", "tail_mask", "n_head", "n_tail"):
                np.testing.assert_array_equal(np.asarray(jr[key]), tr[key].numpy())
        else:
            # XLA may sum the float32 cumsums in another order than torch;
            # two splits whose T_total tie within 1e-6 are both argmins
            tj, tt_ = float(jr["t_total"]), float(tr["t_total"])
            assert abs(tj - tt_) <= 1e-6 * max(abs(tj), 1e-30), (tj, tt_)

    @pytest.mark.parametrize("max_head", [None, 0, 2, 5])
    def test_dual_path_split_matches_jax(self, max_head):
        rows = np.asarray([0, 3, 1, 1, 7, 0, 2, 1, 4, 0], np.int32)
        jr = jsj.dual_path_split(jnp.asarray(rows), tail_tokens=1, max_head=max_head)
        tr = tst.dual_path_split(t(rows), tail_tokens=1, max_head=max_head)
        for key in ("head_mask", "tail_mask", "order", "rank", "n_head", "n_tail", "n_dropped"):
            np.testing.assert_array_equal(np.asarray(jr[key]), tr[key].numpy())

    def test_split_reads_state_in_place(self):
        """The engine refreshes a SieveState by ``copy_``: the split must
        read the new numbers from the same tensors."""
        rows = t(np.asarray([5, 1, 1, 1, 1, 0, 0, 0], np.int32))
        pim, params = _state(0)
        state = tst.SieveState(t(pim.copy()), t(params))
        before = int(tst.dual_path_split_cost(rows, *state, tail_tokens=1)["n_head"])
        state.pim_time_by_count.copy_(torch.full_like(state.pim_time_by_count, 1.0))
        state.pim_time_by_count[0] = 0.0
        after = int(tst.dual_path_split_cost(rows, *state, tail_tokens=1)["n_head"])
        assert before < after == 5  # 1-second PIM entries pull every expert to the head
