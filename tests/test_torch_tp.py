"""Tensor parallelism of the port (``repro_torch.models.sharding``'s layout,
the row-parallel sums and vocab-parallel ends of ``layers``,
head-sharded GQA and MLA, column/row-parallel dense and shared-expert
FFNs, ``LM(mesh_info=...)``) against the JAX package's GSPMD layout
(``param_pspecs``) and its mesh ``LM`` under ``jax.jit``.

Three proxies (``_torch_tp_cases``): the qwen3-moe proxy, whose 2 kv
heads split over (2, 2) but not over (1, 4), where decode runs
sequence-parallel; qwen1.5-0.5b reduced (dense MHA, QKV biases, tied
embeddings, a padded vocabulary); deepseek-v2 reduced (MLA, the dense
prefix block, two shared experts).  One module fixture runs one JAX
subprocess with four host devices and one ``run_on_mesh`` spawn of four
gloo ranks side by side, from the same numpy inputs.  Tolerances: float32
1e-5 (``tests/test_fused_swiglu.py:49``), the layout and integers exact.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port import F32_TOL, assert_close, pin_threads, t

pin_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import _torch_tp_cases as cases  # noqa: E402
import _torch_tp_ranks  # noqa: E402
from _torch_ep_cases import flatten, unflatten  # noqa: E402
from repro.configs import get_arch as jget  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.configs import get_arch as tget  # noqa: E402
from repro_torch.launch.mesh import run_on_mesh  # noqa: E402
from repro_torch.models import LM as TLM  # noqa: E402
from repro_torch.models.layers import apply_mlp, embed, lm_logits  # noqa: E402

TESTS = Path(__file__).resolve().parent
RUNS = [(case, shape) for case in cases.CASES for shape in cases.MESHES]
IDS = [f"{case}-{s[0]}x{s[1]}" for case, s in RUNS]
NEAR_TIE = 1e-5  # relative gap of a router's k-th and (k+1)-th probability


def _one_process(arch, tree: dict, tokens: np.ndarray) -> dict:
    """The port's one-process LM on the same weights and tokens."""
    lm = TLM(arch, dtype=torch.float32, device="cpu")
    p = params_from_numpy(tree, "cpu", torch.float32)
    logits, cache, aux = lm.prefill(p, {"tokens": t(tokens)}, max_seq=cases.MAX_SEQ)
    out = {"prefill_logits": logits.numpy(), "prefill_counts": aux.counts.numpy(),
           "keyed": flatten(params_to_numpy(lm.init(seed=3, keyed=True)))}
    tok = torch.argmax(logits[:, 0, : arch.vocab_size], dim=-1).to(torch.int32)
    for i in range(cases.STEPS):
        pos = torch.full((cases.BATCH,), cases.PROMPT + i, dtype=torch.int32)
        logits, cache, aux = lm.decode_step(p, {"tokens": tok[:, None], "position": pos}, cache)
        out.update({f"tokens{i}": tok.numpy(), f"decode_logits{i}": logits.numpy(),
                    f"decode_counts{i}": aux.counts.numpy()})
        tok = torch.argmax(logits[:, 0, : arch.vocab_size], dim=-1).to(torch.int32)
    return out


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    inputs = {}
    for i, case in enumerate(cases.CASES):
        jarch = cases.arch(jget, case)
        tree = jax.tree.map(np.asarray, JLM(jarch, dtype=jnp.float32).init(jax.random.PRNGKey(i)))
        inputs.update({f"{case}/params/{k}": v for k, v in cases.perturb(flatten(tree), i).items()})
        inputs[f"{case}/tokens"] = cases.tokens(case, jarch.vocab_size)
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(TESTS.parent / "src"), str(TESTS)]))
    proc = subprocess.Popen([sys.executable, str(TESTS / "_torch_tp_jax.py"), str(tmp / "inputs.npz"),
                             str(tmp / "jax.npz")], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        ranks = run_on_mesh(_torch_tp_ranks.rank_main, (2, 2), "gloo", "cpu",
                            args=(str(tmp / "inputs.npz"),))
    finally:
        _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    one = {case: _one_process(cases.arch(tget, case), unflatten(inputs, f"{case}/params/"),
                              inputs[f"{case}/tokens"]) for case in cases.CASES}
    return dict(np.load(tmp / "jax.npz")), ranks, one, inputs


def _at(a: np.ndarray, idx: np.ndarray) -> np.ndarray:
    return a[tuple(slice(lo, hi) for lo, hi in idx)]


def _whole(idx: np.ndarray, shape) -> bool:
    return all(lo == 0 and hi == n for (lo, hi), n in zip(idx, shape))


@pytest.mark.parametrize("case,shape", RUNS, ids=IDS)
def test_rank_slices_are_param_pspecs_shards(tp_runs, case, shape):
    """Every leaf of every rank, from the bridge's cut of the JAX weights and
    from the rank's own keyed draw, is exactly device r's shard of that
    tree under ``to_shardings(mesh, param_pspecs(...))`` (the JAX side
    checks each addressable shard is the array at its index), except the
    leaves ``REPLICATED_BY_PORT`` lists: those the rank holds whole where
    the reference splits them, and no others."""
    jout, ranks, one, inputs = tp_runs
    key = f"{case}/{shape[0]}x{shape[1]}"
    listed = cases.REPLICATED_BY_PORT.get((case, shape), ())
    full = {k[len(f"{case}/params/"):]: v for k, v in inputs.items() if k.startswith(f"{case}/params/")}
    kept_whole, split = set(), set()
    for r in ranks:
        got = r[key]
        assert got["tp"] == (case != "qwen3-moe" or shape == (2, 2))
        assert got["seq_par"] == (case == "qwen3-moe" and shape == (1, 4))
        layout, keyed = flatten(got["layout"]), flatten(got["keyed"])
        assert set(layout) == set(full) == set(keyed)
        for name, whole in full.items():
            idx = jout[f"{key}/idx/{name}/{r['rank']}"]
            if not _whole(idx, whole.shape):
                split.add(name)
            exempt = any(name.endswith("/" + e) for e in listed)
            for mine, src in ((layout[name], whole), (keyed[name], one[case]["keyed"][name])):
                if exempt:
                    np.testing.assert_array_equal(mine, src, err_msg=name)
                    kept_whole.add(name)
                else:
                    np.testing.assert_array_equal(mine, _at(src, idx), err_msg=name)
    assert {e for e in listed} == {e for e in listed if any(n.endswith("/" + e) for n in kept_whole)}
    assert kept_whole <= split  # the listed leaves are ones the reference splits
    assert any("embed" == n for n in split)  # the vocabulary splits on both meshes


def _assert_counts(got: np.ndarray, want: np.ndarray, routes: list, first_call: int, top_k: int,
                   what: str) -> None:
    """Per-layer counts equal, or each differing assignment shown to be a
    router near-tie: the counts differ by whole assignments moved between
    a token's k-th and (k+1)-th expert, whose probabilities are within
    ``NEAR_TIE`` relative in this run's own router."""
    for layer, (g, w) in enumerate(zip(got, want)):
        diff = g.astype(np.int64) - w
        if not diff.any():
            continue
        top_p, top_i = routes[first_call + layer]
        gap = (top_p[:, top_k - 1] - top_p[:, top_k]) / top_p[:, top_k - 1]
        pairs = [set(top_i[j, top_k - 1:top_k + 1].tolist()) for j in np.flatnonzero(gap < NEAR_TIE)]
        moved = set(np.flatnonzero(diff).tolist())
        assert pairs and moved <= set().union(*pairs) and np.abs(diff).sum() <= 2 * len(pairs), (
            f"{what} layer {layer}: counts differ by {diff[diff != 0]} at experts {sorted(moved)} "
            "without a router near-tie")


@pytest.mark.parametrize("case,shape", RUNS, ids=IDS)
def test_lm_on_mesh_matches_jax_mesh_and_one_process(tp_runs, case, shape):
    """Prefill and greedy decode steps of the port's mesh ``LM``: logits
    within float32 1e-5 of JAX's ``LM(mesh_info=...)`` on the
    ``param_pspecs``-placed weights and of the port's one-process LM,
    the same greedy tokens, the same per-layer counts (or differences a
    demonstrated router near-tie explains); a GQA cache holds the rank's
    kv heads where attention splits by heads, and MLA's latent whole."""
    jout, ranks, one, _ = tp_runs
    arch = cases.arch(tget, case)
    key = f"{case}/{shape[0]}x{shape[1]}"
    n_moe = arch.n_layers - arch.moe.first_k_dense if arch.moe else 0
    for r in ranks:
        got = r[key]
        routes = got["routes"]
        B, m = cases.BATCH // shape[0], shape[1]
        a = arch.attn
        if a.kind == "mla":
            want_shape = (B, cases.MAX_SEQ, a.mla.kv_lora_rank)
        elif got["seq_par"]:
            want_shape = (B, cases.MAX_SEQ // m, a.n_kv_heads, a.d_head)
        else:
            want_shape = (B, cases.MAX_SEQ, a.n_kv_heads // m, a.d_head)
        assert got["cache_shapes"]["blocks"][0][1:] == want_shape
        stages = ["prefill_{}"] + [f"decode_{{}}{i}" for i in range(cases.STEPS)]
        for s, what in enumerate(stages):
            counts, logits = what.format("counts"), what.format("logits")
            if n_moe:
                for ref in (jout[f"{key}/{counts}"], one[case][counts]):
                    _assert_counts(got[counts], ref, routes, s * n_moe, arch.moe.top_k, counts)
            assert_close(got[logits], jout[f"{key}/{logits}"])
            assert_close(got[logits], one[case][logits])
        for i in range(cases.STEPS):
            np.testing.assert_array_equal(got[f"tokens{i}"], jout[f"{key}/tokens{i}"])
            np.testing.assert_array_equal(got[f"tokens{i}"], one[case][f"tokens{i}"])


def test_vocab_parallel_embed_and_logits_match_one_process(tp_runs):
    """On the (1, 4) mesh: the masked local lookup summed over the group
    equals ``embed`` of the whole table exactly (one rank contributes each
    row); the gathered logits, untied and tied, equal the whole table's
    within float32 1e-5."""
    _, ranks, _, _ = tp_runs
    u = {k: t(v) for k, v in cases.unit_inputs().items()}
    want_embed = embed(u["table"], u["tokens"]).numpy()
    for r in ranks:
        got = r["units"]
        np.testing.assert_array_equal(got["embed"], want_embed)
        assert_close(got["logits"], lm_logits(u["h"], u["table"], u["w_out"]))
        assert_close(got["tied_logits"], lm_logits(u["h"], u["table"], None))


def test_row_parallel_sum_matches_one_process(tp_runs):
    """On the (1, 4) mesh: the column- then row-parallel MLP summed over the
    group within float32 1e-5 of the one-process MLP, every rank the same
    bits; bf16 partials summed in float32 and rounded once."""
    _, ranks, _, _ = tp_runs
    u = {k: t(v) for k, v in cases.unit_inputs().items()}
    want = apply_mlp({k: u[k] for k in ("w_gate", "w_up", "w_down")}, u["x"], "swiglu").numpy()
    parts = [(u["x"][..., :8] * (m + 1) / 3).to(torch.bfloat16).float() for m in range(4)]
    once = torch.stack(parts).sum(0).to(torch.bfloat16)
    for r in ranks:
        assert_close(r["units"]["mlp"], want, **F32_TOL)
        np.testing.assert_array_equal(r["units"]["mlp"], ranks[0]["units"]["mlp"])
        got = r["units"]["bf16_sum"]
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, once)


@pytest.mark.parametrize("gap,ok", [(2e-6, True), (1e-3, False)])
def test_count_check_accepts_only_a_router_near_tie(gap, ok):
    """``_assert_counts`` on one moved assignment: a token whose 2nd and 3rd
    probabilities (top-2) are ``gap`` apart relative, its 2nd choice
    expert 1 in one run and expert 2 in the other.  Within ``NEAR_TIE``
    the difference is explained; a wider gap is not."""
    top_p = np.asarray([[0.5, 0.25, 0.25 * (1 - gap)], [0.6, 0.3, 0.05]], np.float32)
    top_i = np.asarray([[0, 1, 2], [3, 0, 1]])
    got = np.asarray([[2, 2, 0, 1]])
    want = np.asarray([[2, 1, 1, 1]])
    if ok:
        _assert_counts(got, want, [(top_p, top_i)], 0, 2, "step")
    else:
        with pytest.raises(AssertionError, match="without a router near-tie"):
            _assert_counts(got, want, [(top_p, top_i)], 0, 2, "step")
    _assert_counts(want, want, [(top_p, top_i)], 0, 2, "step")  # equal counts need no evidence


def test_rank_cut_needs_the_arch_for_attention():
    """On a mesh whether a layer splits is decided from the arch
    (``sharding.tp_splits``), which a leaf's shape does not give:
    ``rank_cut`` without the arch refuses an attention or a vocabulary
    leaf, and cuts the routed expert stacks by their own count; with it,
    attention stays whole where the kv heads do not divide, the vocabulary
    is cut, and a leaf of a split layer that does not divide is refused."""
    from repro_torch.models.moe import MeshInfo
    from repro_torch.models.sharding import rank_cut

    mi = MeshInfo(model_index=1, ep_size=4)
    tree = {"embed": np.arange(8 * 2).reshape(8, 2), "blocks": {"attn": {"wq": np.zeros((2, 8))}}}
    for part in (tree, {"embed": tree["embed"]}):
        with pytest.raises(ValueError, match="pass the arch"):
            rank_cut(part, mi)
    experts = np.arange(8 * 2 * 3).reshape(8, 2, 3)
    np.testing.assert_array_equal(rank_cut({"moe": {"w_up": experts}}, mi)["moe"]["w_up"], experts[2:4])
    arch = cases.arch(tget, "qwen3-moe")  # 2 kv heads: attention stays whole on 4 ranks
    cut = rank_cut(tree, mi, arch)
    assert cut["blocks"]["attn"]["wq"].shape == (2, 8)
    np.testing.assert_array_equal(cut["embed"], tree["embed"][2:4])
    with pytest.raises(ValueError, match="does not split over 4"):
        rank_cut({"embed": np.zeros((6, 2))}, mi, arch)
