"""The port's MoE layer (router, capacity dispatch, dual-path executor)
against ``repro.models.moe`` on the same numpy inputs."""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_port import assert_close, pin_threads, proxy_arch, t

pin_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_arch as tget  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402


def _params(rng, d, f, E, n_shared=0):
    p = {
        "w_router": rng.standard_normal((d, E)).astype(np.float32),
        "w_gate": (rng.standard_normal((E, d, f)) * d**-0.5).astype(np.float32),
        "w_up": (rng.standard_normal((E, d, f)) * d**-0.5).astype(np.float32),
        "w_down": (rng.standard_normal((E, f, d)) * f**-0.5).astype(np.float32),
    }
    if n_shared:
        p["shared"] = {
            "w_gate": (rng.standard_normal((d, n_shared * f)) * d**-0.5).astype(np.float32),
            "w_up": (rng.standard_normal((d, n_shared * f)) * d**-0.5).astype(np.float32),
            "w_down": (rng.standard_normal((n_shared * f, d)) * f**-0.5).astype(np.float32),
        }
    return p


def _tree(p, conv):
    return {k: _tree(v, conv) if isinstance(v, dict) else conv(v) for k, v in p.items()}


def _router(rng, T, E, k):
    """A RouterOut pair with distinct experts per token (injected, so the
    dispatch tests do not depend on top-k tie breaking)."""
    idx = np.stack([rng.choice(E, size=k, replace=False) for _ in range(T)]).astype(np.int32)
    w = rng.random((T, k)).astype(np.float32)
    counts = np.bincount(idx.reshape(-1), minlength=E).astype(np.int32)
    jr = jmoe.RouterOut(jnp.asarray(idx), jnp.asarray(w), jnp.zeros(()), jnp.asarray(counts))
    tr = tmoe.RouterOut(t(idx), t(w), torch.zeros(()), t(counts))
    return jr, tr


class TestRouter:
    def test_route_matches_jax_on_tie_free_logits(self):
        arch = proxy_arch(tget)
        cfg = arch.moe
        rng = np.random.default_rng(0)
        x = rng.standard_normal((24, arch.d_model)).astype(np.float32)
        w = rng.standard_normal((arch.d_model, cfg.n_experts)).astype(np.float32)
        logits = x @ w
        srt = np.sort(logits, axis=-1)
        assert (np.diff(srt, axis=-1) > 1e-4).all()  # tie-free, so top-k is unique
        jr = jmoe.route(jnp.asarray(x), jnp.asarray(w), proxy_arch(jget).moe)
        tr = tmoe.route(t(x), t(w), cfg)
        np.testing.assert_array_equal(np.asarray(jr.expert_idx), tr.expert_idx.numpy())
        np.testing.assert_array_equal(np.asarray(jr.counts), tr.counts.numpy())
        assert_close(tr.weights, jr.weights)
        assert_close(tr.aux_loss, jr.aux_loss)

    @pytest.mark.parametrize("tie", ["flat_row", "two_way", "three_way"])
    def test_route_breaks_ties_as_jax_top_k(self, tie):
        """Tied probabilities: ``jax.lax.top_k`` puts the lower index first,
        and the port must pick the same experts in the same order, so the
        counts and the dispatch's slots and drops match exactly.  At qwen3
        routing widths (128 experts, top-8); ``flat_row`` feeds zero rows of
        x (all 128 probabilities equal), the others duplicate router columns
        among the top 8."""
        E, k, d, T = 128, 8, 16, 12
        jcfg = dataclasses.replace(proxy_arch(jget).moe, n_experts=E, top_k=k)
        tcfg = dataclasses.replace(proxy_arch(tget).moe, n_experts=E, top_k=k)
        rng = np.random.default_rng(7)
        x = rng.standard_normal((T, d)).astype(np.float32)
        w = rng.standard_normal((d, E)).astype(np.float32)
        if tie == "flat_row":
            x[::3] = 0.0
            tied = [(r, list(range(E))) for r in range(0, T, 3)]
        else:
            x = np.abs(x) + 0.1
            cols = [5, 77] if tie == "two_way" else [5, 40, 77]
            w[:, cols] = 2.0 + np.abs(w[:, [cols[0]]])  # the same, largest column
            tied = [(r, cols) for r in range(T)]
        probs = torch.softmax(t(x) @ t(w), dim=-1)
        for r, cols in tied:  # the ties are exact on the port's side too
            assert (probs[r, cols] == probs[r, cols[0]]).all()
        jr = jmoe.route(jnp.asarray(x), jnp.asarray(w), jcfg)
        tr = tmoe.route(t(x), t(w), tcfg)
        np.testing.assert_array_equal(np.asarray(jr.expert_idx), tr.expert_idx.numpy())
        np.testing.assert_array_equal(np.asarray(jr.counts), tr.counts.numpy())
        assert_close(tr.weights, jr.weights)
        for r, cols in tied:
            want = list(range(k)) if tie == "flat_row" else cols
            assert tr.expert_idx[r, : len(want)].tolist() == want
        cap = 2  # the tied experts overflow: drops
        jd = jmoe.dispatch(jnp.asarray(x), jr, E, cap)
        td = tmoe.dispatch(t(x), tr, E, cap)
        np.testing.assert_array_equal(np.asarray(jd.slot_of), td.slot_of.numpy())
        np.testing.assert_array_equal(np.asarray(jd.buf), td.buf.numpy())
        assert int(jd.n_dropped) == int(td.n_dropped) > 0


class TestDispatch:
    @pytest.mark.parametrize(
        "T,E,k,cap,d",
        [
            (8, 128, 8, 8, 16),  # decode step at qwen3 routing widths
            (40, 16, 4, 6, 8),  # overflow: drops
            (4000, 128, 8, 40, 4),  # past _COUNTING_DISPATCH_MAX_ELEMS: the sort path
        ],
    )
    def test_slots_and_drops_match_jax(self, T, E, k, cap, d):
        rng = np.random.default_rng(T)
        x = rng.standard_normal((T, d)).astype(np.float32)
        jr, tr = _router(rng, T, E, k)
        counting = T * k * (E + 1) <= tmoe._COUNTING_DISPATCH_MAX_ELEMS
        assert counting == (T * k * (E + 1) <= jmoe._COUNTING_DISPATCH_MAX_ELEMS)
        jd = jmoe.dispatch(jnp.asarray(x), jr, E, cap)
        for fn in (tmoe.dispatch, tmoe.dispatch_counting, tmoe.dispatch_argsort):
            td = fn(t(x), tr, E, cap)
            np.testing.assert_array_equal(np.asarray(jd.slot_of), td.slot_of.numpy())
            np.testing.assert_array_equal(np.asarray(jd.buf), td.buf.numpy())
            assert int(jd.n_dropped) == int(td.n_dropped)

    def test_combine_matches_jax(self):
        rng = np.random.default_rng(1)
        T, E, k, cap, d = 12, 8, 2, 3, 16
        x = rng.standard_normal((T, d)).astype(np.float32)
        jr, tr = _router(rng, T, E, k)
        jd = jmoe.dispatch(jnp.asarray(x), jr, E, cap)
        td = tmoe.dispatch(t(x), tr, E, cap)
        y = rng.standard_normal((E, cap, d)).astype(np.float32)
        assert_close(
            tmoe.combine(t(y), td.slot_of, tr.weights, T),
            jmoe.combine(jnp.asarray(y), jd.slot_of, jr.weights, T),
        )


class TestExecutor:
    @pytest.mark.parametrize("mode", ["dense", "dual_path", "dual_path_cost"])
    @pytest.mark.parametrize("max_head", [0, 3])
    def test_experts_ffn_exec_matches_jax(self, mode, max_head):
        jcfg = dataclasses.replace(proxy_arch(jget, mode).moe, dual_max_head=max_head)
        tcfg = dataclasses.replace(proxy_arch(tget, mode).moe, dual_max_head=max_head)
        E, C, d, f = jcfg.n_experts, 6, 128, jcfg.d_expert
        rng = np.random.default_rng(2)
        p = _params(rng, d, f, E)
        rows = (rng.integers(0, C + 1, E) * (rng.random(E) < 0.3)).astype(np.int32)
        buf = rng.standard_normal((E, C, d)).astype(np.float32)
        buf *= (np.arange(C)[None, :] < rows[:, None])[..., None]  # dispatch zero-fills
        jy, jdrop = jmoe.experts_ffn_exec(_tree(p, jnp.asarray), jnp.asarray(buf), jnp.asarray(rows), jcfg)
        ty, tdrop = tmoe.experts_ffn_exec(_tree(p, t), t(buf), t(rows), tcfg)
        assert_close(ty, jy)
        assert int(jdrop) == int(tdrop)
        if mode != "dense":
            # padded rows and empty experts compute exact zeros
            dead = np.arange(C)[None, :] >= rows[:, None]
            assert (ty.numpy()[dead] == 0).all()

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("mode,max_head", [("dual_path", 0), ("dual_path_cost", 0), ("dual_path_cost", 3)])
    def test_three_call_executor_matches_jax(self, monkeypatch, mode, max_head, dtype):
        """REPRO_FUSED_SWIGLU=0: head and tail run gate, up and down as
        three calls each (the JAX side runs its Pallas kernels in interpret
        mode).  Tolerance: float32 1e-5; bf16 2e-2 (tests/test_fused_swiglu.py:50),
        since silu(gate) * up is rounded to bf16 between the calls on both
        sides after sums taken in other orders."""
        monkeypatch.setenv("REPRO_FUSED_SWIGLU", "0")
        monkeypatch.setenv("REPRO_DUAL_BACKEND", "pallas")
        calls = dict.fromkeys(("gmm_capacity", "expert_gemv", "swiglu_gmm_capacity", "swiglu_gemv"), 0)
        for name in calls:
            def counted(*args, _fn=getattr(tmoe.ops, name), _name=name):
                calls[_name] += 1
                return _fn(*args)
            monkeypatch.setattr(tmoe.ops, name, counted)
        jcfg = dataclasses.replace(proxy_arch(jget, mode).moe, dual_max_head=max_head)
        tcfg = dataclasses.replace(proxy_arch(tget, mode).moe, dual_max_head=max_head)
        E, C, d, f = jcfg.n_experts, 6, 128, jcfg.d_expert
        rng = np.random.default_rng(4)
        p = _params(rng, d, f, E)
        rows = (rng.integers(0, C + 1, E) * (rng.random(E) < 0.3)).astype(np.int32)
        buf = rng.standard_normal((E, C, d)).astype(np.float32)
        buf *= (np.arange(C)[None, :] < rows[:, None])[..., None]
        jd, td = getattr(jnp, dtype), getattr(torch, dtype)
        jp = _tree(p, lambda a: jnp.asarray(a, jd))
        jp["w_router"] = jnp.asarray(p["w_router"])
        tp = _tree(p, lambda a: t(a).to(td))
        tp["w_router"] = t(p["w_router"])
        jy, jdrop = jmoe.experts_ffn_exec(jp, jnp.asarray(buf, jd), jnp.asarray(rows), jcfg)
        ty, tdrop = tmoe.experts_ffn_exec(tp, t(buf).to(td), t(rows), tcfg)
        assert ty.dtype == td
        tol = {} if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
        assert_close(ty, np.asarray(jy, np.float32), **tol)
        assert int(jdrop) == int(tdrop)
        assert calls == {"gmm_capacity": 3, "expert_gemv": 3, "swiglu_gmm_capacity": 0, "swiglu_gemv": 0}
        dead = np.arange(C)[None, :] >= rows[:, None]
        assert (ty.float().numpy()[dead] == 0).all()

    @pytest.mark.parametrize("mode", ["dense", "dual_path_cost"])
    def test_moe_block_matches_jax(self, mode):
        jarch = dataclasses.replace(proxy_arch(jget, mode), moe=dataclasses.replace(proxy_arch(jget, mode).moe, n_shared=1))
        tarch = dataclasses.replace(proxy_arch(tget, mode), moe=dataclasses.replace(proxy_arch(tget, mode).moe, n_shared=1))
        rng = np.random.default_rng(3)
        d = jarch.d_model
        p = _params(rng, d, jarch.moe.d_expert, jarch.moe.n_experts, n_shared=1)
        p["w_router"] *= 0.05
        x = rng.standard_normal((2, 10, d)).astype(np.float32)
        jo = jmoe.moe_block(_tree(p, jnp.asarray), jnp.asarray(x), jarch)
        to = tmoe.moe_block(_tree(p, t), t(x), tarch)
        np.testing.assert_array_equal(np.asarray(jo.counts), to.counts.numpy())
        assert int(jo.n_dropped) == int(to.n_dropped)
        assert_close(to.y, jo.y)
        assert_close(to.aux_loss, jo.aux_loss)

    def test_default_sieve_state_matches_jax(self):
        ts = tmoe.default_sieve_state(tget("qwen3-moe-30b-a3b"), "cpu")
        js = jmoe.default_sieve_state(jget("qwen3-moe-30b-a3b"))
        np.testing.assert_array_equal(np.asarray(js.pim_time_by_count), ts.pim_time_by_count.numpy())
        np.testing.assert_array_equal(np.asarray(js.params), ts.params.numpy())

    def test_unknown_exec_mode_raises(self):
        cfg = dataclasses.replace(proxy_arch(tget).moe, expert_exec="bogus")
        with pytest.raises(ValueError, match="expert_exec"):
            tmoe.experts_ffn_exec({}, torch.zeros((2, 1, 4)), torch.zeros(2, dtype=torch.int32), cfg)
