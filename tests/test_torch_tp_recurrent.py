"""Tensor parallelism of the hybrid, ssm and audio families in the port
(``repro_torch.models.sharding``'s Mamba2, RWKV6, cross-attention and
attention layers, the cross-rank gated RMSNorm, ``LM(mesh_info=...)``'s
prefill and decode) against the JAX package's GSPMD layout
(``param_pspecs``) and its mesh ``LM`` under ``jax.jit``.

Three reduced configs (``_torch_tp_cases.RECURRENT_CASES``): zamba2-7b,
rwkv6-7b and whisper-base, attention with as many kv heads as heads as
the full configs have.  One module fixture runs one JAX subprocess with
four host devices (``_torch_tp_jax.py``) and one ``run_on_mesh`` spawn of
four gloo ranks (``_torch_tp_ranks.py``) side by side, from the same numpy
inputs.  Tolerances: float32 1e-5 (``tests/test_fused_swiglu.py:49``),
the layout and the greedy tokens exact.
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
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.moe import MeshInfo  # noqa: E402
from repro_torch.models.sharding import rank_part, ssm_heads  # noqa: E402

TESTS = Path(__file__).resolve().parent
RUNS = [(case, shape) for case in cases.RECURRENT_CASES for shape in cases.MESHES]
IDS = [f"{case}-{s[0]}x{s[1]}" for case, s in RUNS]


def _one_process(arch, tree: dict, batch: dict) -> dict:
    """The port's one-process LM on the same weights and prompt."""
    lm = TLM(arch, dtype=torch.float32, device="cpu")
    p = params_from_numpy(tree, "cpu", torch.float32)
    logits, cache, _ = lm.prefill(p, {k: t(v) for k, v in batch.items()}, max_seq=cases.MAX_SEQ)
    out = {"prefill_logits": logits.numpy(), "keyed": flatten(params_to_numpy(lm.init(seed=3, keyed=True)))}
    tok = torch.argmax(logits[:, 0, : arch.vocab_size], dim=-1).to(torch.int32)
    for i in range(cases.STEPS):
        pos = torch.full((cases.BATCH,), cases.PROMPT + i, dtype=torch.int32)
        logits, cache, _ = lm.decode_step(p, {"tokens": tok[:, None], "position": pos}, cache)
        out.update({f"tokens{i}": tok.numpy(), f"decode_logits{i}": logits.numpy()})
        tok = torch.argmax(logits[:, 0, : arch.vocab_size], dim=-1).to(torch.int32)
    return out


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_recurrent")
    inputs = {}
    for i, case in enumerate(cases.RECURRENT_CASES):
        jarch = cases.arch(jget, case)
        tree = jax.tree.map(np.asarray, JLM(jarch, dtype=jnp.float32).init(jax.random.PRNGKey(10 + i)))
        inputs.update({f"{case}/params/{k}": v for k, v in cases.perturb(flatten(tree), 10 + i).items()})
        inputs[f"{case}/tokens"] = cases.tokens(case, jarch.vocab_size)
        if jarch.family == "audio":
            inputs[f"{case}/embeds"] = cases.frames(jarch.d_model)
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(TESTS.parent / "src"), str(TESTS)]))
    proc = subprocess.Popen([sys.executable, str(TESTS / "_torch_tp_jax.py"), str(tmp / "inputs.npz"),
                             str(tmp / "jax.npz"), *cases.RECURRENT_CASES], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = run_on_mesh(_torch_tp_ranks.rank_main, (2, 2), "gloo", "cpu",
                            args=(str(tmp / "inputs.npz"), cases.RECURRENT_CASES))
    finally:
        _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    one = {case: _one_process(cases.arch(tget, case), unflatten(inputs, f"{case}/params/"),
                              cases.prompt(inputs, case)) for case in cases.RECURRENT_CASES}
    return dict(np.load(tmp / "jax.npz")), ranks, one, inputs


def _at(a: np.ndarray, idx: np.ndarray) -> np.ndarray:
    return a[tuple(slice(lo, hi) for lo, hi in idx)]


def _model_index(rank: int, shape) -> int:
    return rank % shape[1]


@pytest.mark.parametrize("case,shape", RUNS, ids=IDS)
def test_rank_slices_are_param_pspecs_shards(tp_runs, case, shape):
    """Every leaf of every rank, from the bridge's cut of the JAX weights and
    from the rank's own keyed draw, is device r's shard of that tree under
    ``to_shardings(mesh, param_pspecs(...))`` exactly, except the leaves
    ``PORT_LAYOUT`` lists: those equal the port's own cut
    (``sharding.rank_part``) of the whole leaf, and on some rank that cut
    is not the reference's shard (the listing is needed)."""
    jout, ranks, one, inputs = tp_runs
    arch = cases.arch(tget, case)
    key = f"{case}/{shape[0]}x{shape[1]}"
    listed = cases.PORT_LAYOUT[case]
    full = {k[len(f"{case}/params/"):]: v for k, v in inputs.items() if k.startswith(f"{case}/params/")}
    differs = set()
    for r in ranks:
        got = r[key]
        assert got["tp"] == (arch.attn.kind != "none")  # attention split by heads
        mi = MeshInfo(model_index=_model_index(r["rank"], shape), ep_size=shape[1])
        layout, keyed = flatten(got["layout"]), flatten(got["keyed"])
        assert set(layout) == set(full) == set(keyed)
        for name, whole in full.items():
            shard = _at(whole, jout[f"{key}/idx/{name}/{r['rank']}"])
            own = [e for e in listed if name.endswith("/" + e)]
            for mine, src in ((layout[name], whole), (keyed[name], one[case]["keyed"][name])):
                if own:
                    want = rank_part(src, tuple(name.split("/")), arch, mi)
                    np.testing.assert_array_equal(mine, want, err_msg=name)
                    if mine.shape != shard.shape or not np.array_equal(mine, _at(src, jout[
                            f"{key}/idx/{name}/{r['rank']}"])):
                        differs.add(own[0])
                else:
                    np.testing.assert_array_equal(mine, _at(src, jout[f"{key}/idx/{name}/{r['rank']}"]),
                                                  err_msg=name)
    assert differs == set(listed)


def _cache_shapes(arch, shape) -> dict:
    """This rank's decode cache leaves: its rows, and its heads of every
    leaf with heads (the conv state: its heads' x channels and B/C)."""
    B, m, T = cases.BATCH // shape[0], shape[1], cases.MAX_SEQ
    a, s = arch.attn, arch.ssm
    if arch.family == "hybrid":
        nseg, per, H = arch.n_layers // arch.attn_every, arch.attn_every - 1, ssm_heads(arch) // m
        tail = arch.n_layers - nseg * arch.attn_every
        conv = (B, s.conv_width - 1, H * s.head_dim + 2 * s.n_groups * s.d_state)
        state = (B, H, s.head_dim, s.d_state)
        return {"mamba_seg": [(nseg, per) + conv, (nseg, per) + state],
                "attn": [(nseg, B, T, a.n_kv_heads // m, a.d_head)] * 2,
                "mamba_tail": [(tail,) + conv, (tail,) + state]}
    if arch.family == "ssm":
        L, H = arch.n_layers, ssm_heads(arch) // m
        return {"blocks": [(L, B, arch.d_model)] * 2 + [(L, B, H, s.head_dim, s.head_dim)]}
    L = arch.n_layers
    return {"self": [(L, B, T, a.n_kv_heads // m, a.d_head)] * 2,
            "cross": [(L, B, cases.FRAMES, a.n_heads // m, a.d_head)] * 2}


@pytest.mark.parametrize("case,shape", RUNS, ids=IDS)
def test_lm_on_mesh_matches_jax_mesh_and_one_process(tp_runs, case, shape):
    """Prefill and greedy decode steps of the port's mesh ``LM``: logits
    within float32 1e-5 of JAX's ``LM(mesh_info=...)`` on the
    ``param_pspecs``-placed weights and of the port's one-process LM, the
    same greedy tokens; the rank's cache holds its rows and its heads."""
    jout, ranks, one, _ = tp_runs
    arch = cases.arch(tget, case)
    key = f"{case}/{shape[0]}x{shape[1]}"
    for r in ranks:
        got = r[key]
        assert got["cache_shapes"] == _cache_shapes(arch, shape)
        for what in ["prefill_logits"] + [f"decode_logits{i}" for i in range(cases.STEPS)]:
            assert_close(got[what], jout[f"{key}/{what}"])
            assert_close(got[what], one[case][what])
        for i in range(cases.STEPS):
            np.testing.assert_array_equal(got[f"tokens{i}"], jout[f"{key}/tokens{i}"])
            np.testing.assert_array_equal(got[f"tokens{i}"], one[case][f"tokens{i}"])


def test_gated_norm_sums_squares_over_the_group(tp_runs):
    """Mamba2's gated RMSNorm on a rank that holds one head of four: the
    mean square of the whole ``d_inner`` from the group's sum, then the
    rank's rows of ``w_out`` summed over the group; within float32 1e-5 of
    the one-process function, every rank the same bits.  A rank that
    normalised over its own channels alone would be off by the ratio of
    the two mean squares."""
    _, ranks, _, _ = tp_runs
    u = {k: t(v) for k, v in cases.gated_norm_inputs().items()}
    params = {"norm_scale": u["norm_scale"], "w_out": u["w_out"]}
    want = ssm._gated_out(params, u["y"], u["z"], torch.float32).numpy()
    for r in ranks:
        assert_close(r["units"]["gated_norm"], want, **F32_TOL)
        np.testing.assert_array_equal(r["units"]["gated_norm"], ranks[0]["units"]["gated_norm"])
    local = {"norm_scale": u["norm_scale"][:16], "w_out": u["w_out"][:16]}
    alone = ssm._gated_out(local, u["y"][..., :16], u["z"][..., :16], torch.float32).numpy()
    assert not np.allclose(alone * 4, want, **F32_TOL)
