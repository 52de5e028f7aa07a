"""Training on a (data, model) mesh in the port (``LM.loss`` under autograd
through the collectives, the data-parallel reduce, the sharded clip and
compression, mesh checkpoints, ``launch/train.py --mesh``) against the
JAX package's mesh training: ``jax.value_and_grad(lm.loss)`` and
``make_train_step`` under ``jax.jit`` on ``param_pspecs``-placed weights.

The proxies of ``_torch_tp_cases`` and qwen2-vl reduced (every family the
port trains: dense, MoE with both expert-parallel bodies and MLA, VLM,
hybrid, ssm and audio) on (1, 4) and (2, 2) meshes
(``_torch_train_mesh_cases``).  One module fixture runs one JAX
subprocess with four host devices (``_torch_train_mesh_jax.py``) and one
``run_on_mesh`` spawn of four gloo ranks (``_torch_train_mesh_ranks.py``)
side by side, from the same numpy inputs.  A rank's gradient leaves are
joined over its model group with ``sharding.rank_join`` (the leaves the
port lays out its own way, ``REPLICATED_BY_PORT`` and ``PORT_LAYOUT``,
included) and held against the reference's whole gradient.

Tolerances: float32 ``F32_TOL`` (``tests/test_fused_swiglu.py:49``);
rwkv6's gradients ``RWKV_TOL``, as ``tests/test_torch_train_recurrent.py``
holds them and says why.  Parameters after three AdamW steps: ``F32_TOL``
relative, and an absolute 1e-4, a tenth of the learning rate.  AdamW's
first updates are ``lr * g / (|g| + eps)``, so an element whose gradient
is a float32 cancellation residue (a few 1e-8, where the two frameworks'
orders of summation differ by their whole relative error) moves by a part
of ``lr`` in one framework and another part in the other: on qwen1.5's
(1, 4) mesh one ``wq`` element of 16384 ends 1.5e-5 from the
reference's.  With int8 compression: an element of ``g / scale`` at a
rounding tie takes the neighbouring int8 value under float32 noise
(``test_int8_values_differ_only_at_rounding_ties`` holds that), and the
error feedback carries the jump on, so the steps' losses are held to rtol
1e-3 (qwen3-moe's (2, 2) third step differed by 3.1e-4 after 7 such
elements of 3.4 million in the first step) and the grad norms to rtol
1e-2 (``tests/test_torch_train.py``'s ``test_five_train_steps_track_jax``).
The residual the mesh step keeps is held against the reference's
``compress`` of the port's own mesh gradient to ``RESIDUAL_TOL``, 1e-4 of
the leaf's scale: the same quantisation of the same numbers, where only
the rounding of ``g - q * scale`` may differ (a fused multiply-add moves
it by at most an ulp of ``q * scale``, under 1e-5 of the scale).
What every rank computes alike is held bitwise: the replicated leaves
across the model group, every leaf across the data group after the
data-parallel reduce.
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

import _torch_tp_cases as tp_cases  # noqa: E402
import _torch_train_mesh_cases as cases  # noqa: E402
import _torch_train_mesh_ranks as ranks_mod  # noqa: E402
from _torch_ep_cases import flatten  # noqa: E402
from repro.configs import get_arch as jget  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro_torch.configs import get_arch as tget  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import run_on_mesh  # noqa: E402
from repro_torch.models import LM as TLM  # noqa: E402
from repro_torch.models.layers import apply_mlp, lm_logits  # noqa: E402
from repro_torch.models.moe import MeshInfo  # noqa: E402
from repro_torch.models.sharding import rank_join, rank_part, rank_slice, tp_axis  # noqa: E402
from repro_torch.train import tree as tr  # noqa: E402
from repro_torch.train.checkpoint import MeshCheckpoints, latest_step, restore_checkpoint, save_checkpoint  # noqa: E402

TESTS = Path(__file__).resolve().parent
RWKV_TOL = dict(rtol=1e-4, atol=1e-4)
PARAM_ATOL = 0.1 * cases.OPT["lr"]  # the module docstring says why
RESIDUAL_TOL = 1e-4  # of a leaf's int8 scale: the module docstring says why
RUNS = cases.runs()
IDS = [cases.key(*r).replace("/", "-") for r in RUNS]
STEP_IDS = [f"{run}-{case}-{s[0]}x{s[1]}" for run, case, s, _ in cases.STEP_RUNS]


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_mesh")
    inputs = {}
    for i, case in enumerate(cases.CASES):
        jarch = cases.run_arch(jget, case)
        tree = jax.tree.map(np.asarray, JLM(jarch, dtype=jnp.float32).init(jax.random.PRNGKey(i)))
        inputs.update({f"{case}/params/{k}": v for k, v in tp_cases.perturb(flatten(tree), i).items()})
        inputs.update(cases.make_batches(case, jarch))
    np.savez(tmp / "inputs.npz", **inputs)
    ckpt = tmp / "ckpt"
    for case in ranks_mod.CKPT_CASES:  # the one-process checkpoints the ranks restore on (2, 2)
        lm = TLM(cases.run_arch(tget, case), dtype=torch.float32, device="cpu")
        save_checkpoint(str(ckpt / case / "one"), 1, ranks_mod._state(lm, inputs, case))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(TESTS.parent / "src"), str(TESTS)]))
    proc = subprocess.Popen([sys.executable, str(TESTS / "_torch_train_mesh_jax.py"), str(tmp / "inputs.npz"),
                             str(tmp / "jax.npz")], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        ranks = run_on_mesh(ranks_mod.rank_main, (2, 2), "gloo", "cpu",
                            args=(str(tmp / "inputs.npz"), str(ckpt)), timeout_s=600)
    finally:
        _, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-3000:]
    return dict(np.load(tmp / "jax.npz")), ranks, inputs, ckpt


def _rows(ranks: list, key: str) -> dict:
    """Each data row's results of run ``key``, in model-rank order."""
    rows: dict = {}
    for r in sorted(ranks, key=lambda r: r[key]["model_index"]):
        rows.setdefault(r[key]["data_index"], []).append(r[key])
    return rows


def _joined(parts: list, name: str, shape, arch, m: int) -> np.ndarray:
    return rank_join(parts, tuple(name.split("/")), shape, arch, m)


def _tol(case: str) -> dict:
    return RWKV_TOL if case == "rwkv6" else F32_TOL


@pytest.mark.parametrize("case,shape,ep", RUNS, ids=IDS)
def test_loss_and_every_gradient_leaf_match_the_jax_mesh(mesh_runs, case, shape, ep):
    """The global loss, ``ce`` and MoE aux loss on every rank, and every
    gradient leaf (a data row's ranks' parts joined) against the
    reference's mesh ``value_and_grad``; every leaf's gradient finite.
    The all-to-all run's aux loss is its token shards' mean, which the
    replicated-dispatch body does not compute: its loss leaves it out and
    the metric goes unchecked here."""
    jout, ranks, _, _ = mesh_runs
    key = cases.key(case, shape, ep)
    arch = cases.run_arch(tget, case, ep)
    for r in ranks:
        got = r[key]
        assert_close(got["loss"], jout[f"{key}/loss"])
        assert_close(got["ce"], jout[f"{key}/ce"])
        if not ep:
            assert_close(got["moe_aux"], jout[f"{key}/moe_aux"])
    want = {k[len(f"{key}/grad/"):]: v for k, v in jout.items() if k.startswith(f"{key}/grad/")}
    rows = _rows(ranks, key)
    assert len(rows) == shape[0] and all(len(parts) == shape[1] for parts in rows.values())
    for parts in rows.values():
        assert set(parts[0]["grads"]) == set(want)
        for name, w in want.items():
            whole = _joined([p["grads"][name] for p in parts], name, w.shape, arch, shape[1])
            assert np.isfinite(whole).all(), name
            np.testing.assert_allclose(whole, w, err_msg=name, **_tol(case))


@pytest.mark.parametrize("case,shape,ep", RUNS, ids=IDS)
def test_replicated_gradients_are_bitwise_equal_across_ranks(mesh_runs, case, shape, ep):
    """A leaf every rank of a model group holds whole has the same gradient
    bits on each of them (no sum after the backward pass); after the
    data-parallel reduce every leaf has the same bits on every data rank.
    The mesh splits some leaves and keeps others whole."""
    jout, ranks, _, _ = mesh_runs
    key = cases.key(case, shape, ep)
    _assert_layout_bitwise(ranks, key, "grads", jout, f"{key}/grad/", cases.run_arch(tget, case, ep), shape[1])


def _assert_layout_bitwise(ranks: list, key: str, what: str, jout: dict, prefix: str, arch, m: int) -> None:
    """Every rank's leaves of ``r[key][what]``: a leaf ``tp_axis`` keeps
    whole (its whole shape from the JAX result under ``prefix``) has the
    same bits on every rank, a split one on every rank of its model
    index; both kinds occur."""
    kinds = set()
    for name in ranks[0][key][what]:
        split = tp_axis(tuple(name.split("/")), jout[prefix + name].shape, arch, m) is not None
        kinds.add(split)
        for r in ranks:
            for o in ranks:
                if not split or o[key]["model_index"] == r[key]["model_index"]:
                    np.testing.assert_array_equal(r[key][what][name], o[key][what][name], err_msg=name)
    assert kinds == {True, False}


@pytest.mark.parametrize("run,case,shape", [r[:3] for r in cases.STEP_RUNS], ids=STEP_IDS)
def test_train_steps_match_the_jax_mesh_train_step(mesh_runs, run, case, shape):
    """Three steps of ``make_train_step`` on the mesh (AdamW, clipped by
    the global norm; with int8 compression; with two microbatches) from
    the same weights: every step's global metrics on every rank against
    the reference's jitted mesh step, and without compression the
    parameters after the last step (joined) within ``F32_TOL``; the
    replicated parameters bitwise equal across the model group, every leaf
    across the data group."""
    jout, ranks, _, _ = mesh_runs
    key = cases.key(case, shape)
    arch = cases.run_arch(tget, case)
    compressed = run == "int8"
    loss_tol = dict(rtol=1e-3, atol=0) if compressed else F32_TOL
    norm_tol = dict(rtol=1e-2, atol=0) if compressed else F32_TOL
    for r in ranks:
        for i, m in enumerate(r[key][run]["metrics"]):
            for name, tol in (("loss", loss_tol), ("ce", loss_tol), ("moe_aux", loss_tol),
                              ("grad_norm", norm_tol), ("lr", F32_TOL)):
                assert_close(m[name], jout[f"{key}/{run}/{name}{i}"], **tol)
            assert m["dropped"] == int(jout[f"{key}/{run}/dropped{i}"])
            assert m == ranks[0][key][run]["metrics"][i]
    prefix = f"{key}/{run}/params/"
    flat = {r["rank"]: {key: {"params": r[key][run]["params"], **{k: r[key][k] for k in ("model_index",
                                                                                          "data_index")}}}
            for r in ranks}
    _assert_layout_bitwise(list(flat.values()), key, "params", jout, prefix, arch, shape[1])
    if compressed:
        return
    for parts in _rows(ranks, key).values():
        for name in parts[0][run]["params"]:
            w = jout[prefix + name]
            whole = _joined([p[run]["params"][name] for p in parts], name, w.shape, arch, shape[1])
            np.testing.assert_allclose(whole, w, err_msg=name, rtol=F32_TOL["rtol"], atol=PARAM_ATOL)


@pytest.mark.parametrize("case,shape", [("qwen3-moe", (2, 2)), ("zamba2", (1, 4))], ids=["qwen3-moe-2x2",
                                                                                          "zamba2-1x4"])
def test_int8_values_differ_only_at_rounding_ties(mesh_runs, case, shape):
    """The residual the mesh's train step keeps after its first step with
    compression (each data row's ranks' parts joined): equal, within
    ``RESIDUAL_TOL`` of the leaf's scale, to the reference's ``compress``
    of the port's mesh gradient of that step (a split leaf's scale over
    the model group, a layer stack's over its layers, each rank's part of
    the residual).  The int8 values the step took, ``(g - r) / scale``,
    equal those of the reference's ``compress`` of its own mesh gradient
    except where its ``g / scale`` sits within 1e-4 of a rounding tie
    (x.5), at most one element in 1e4 (7 of 3.4 million on qwen3-moe's
    (2, 2) mesh, 4 of 158376 on zamba2's (1, 4) mesh)."""
    from repro.train import compression as jcomp

    jout, ranks, _, _ = mesh_runs
    key = cases.key(case, shape)
    arch = cases.run_arch(tget, case)
    names = sorted(ranks[0][key]["int8"]["residual"])
    want = [jout[f"{key}/grad/{n}"] for n in names]
    zeros = [np.zeros(w.shape, np.float32) for w in want]
    jc, _ = jcomp.compress(want, zeros)
    for parts in _rows(ranks, key).values():
        mine = [_joined([p["grads"][n] for p in parts], n, w.shape, arch, shape[1]) for n, w in zip(names, want)]
        got = [_joined([p["int8"]["residual"][n] for p in parts], n, w.shape, arch, shape[1])
               for n, w in zip(names, want)]
        own, own_res = jcomp.compress(mine, zeros)
        moved = total = 0
        for n, w, g, r, s, rr, jq, js in zip(names, want, mine, got, own.scale, own_res, jc.q, jc.scale):
            np.testing.assert_allclose(r, np.asarray(rr), rtol=0, atol=RESIDUAL_TOL * float(s), err_msg=n)
            q = np.rint((g - r) / float(js))
            diff = q != np.asarray(jq)
            frac = np.abs(w[diff] / float(js)) % 1
            assert (np.abs(frac - 0.5) < 1e-4).all(), (n, frac)
            moved, total = moved + int(diff.sum()), total + diff.size
        assert moved <= total * 1e-4


@pytest.mark.parametrize("case", ["qwen3-moe", "deepseek-v2"])
@pytest.mark.parametrize("shape", [(2, 1), (2, 3)], ids=["2x1", "2x3"])
def test_moe_training_refuses_data_ranks_without_expert_parallelism(case, shape):
    """``LM.loss`` of a MoE proxy on two data ranks whose model group does
    not split the experts (one rank, or three that do not divide them)
    raises before any work: the reference routes the global batch as one
    there (``moe_local`` under GSPMD), so capacity, drops and the aux loss
    are the whole batch's, where a rank holds only its rows."""
    mi = MeshInfo(dp_size=shape[0], ep_size=shape[1])
    lm = TLM(cases.run_arch(tget, case), dtype=torch.float32, device="cpu", mesh_info=mi)
    toks = torch.zeros((cases.BATCH, cases.SEQ), dtype=torch.int64)
    with pytest.raises(ValueError, match="experts split over a model group"):
        lm.loss(lm.init(0), {"tokens": toks, "labels": toks})


def _cut_for(whole_state, like, arch, shape, rank: int):
    """Rank ``rank``'s part of a whole train state on a ``shape`` mesh, by
    the mesh checkpoints' own cut (a ``MeshInfo`` with no process group)."""
    mi = MeshInfo(model_index=rank % shape[1], data_index=rank // shape[1], ep_size=shape[1], dp_size=shape[0])
    lm = TLM(arch, dtype=torch.float32, device="cpu", mesh_info=mi)
    return [x.detach().numpy() for x in tr.leaves(MeshCheckpoints(lm).part(whole_state, like))]


def _one_state(case: str, inputs: dict):
    lm = TLM(cases.run_arch(tget, case), dtype=torch.float32, device="cpu")
    return lm.arch, ranks_mod._state(lm, inputs, case)


@pytest.mark.parametrize("case", ranks_mod.CKPT_CASES)
def test_a_2x2_checkpoint_restores_on_one_process_and_on_1x4(mesh_runs, case):
    """The state after a step on (2, 2), saved by ``MeshCheckpoints``: one
    process restores it as a whole tree (``restore_checkpoint``) whose cut
    for each (2, 2) rank is that rank's state bitwise, and each (1, 4)
    rank's restored state is its cut of that tree bitwise; the restored
    parameters require grad."""
    _, ranks, inputs, ckpt = mesh_runs
    arch, like = _one_state(case, inputs)
    assert latest_step(str(ckpt / case / "mesh")) == 1
    whole = restore_checkpoint(str(ckpt / case / "mesh"), 1, like)
    for r in ranks:
        got = r["ckpt"][case]
        step14, restored14 = got["restored14"]
        assert step14 == 1 and got["requires_grad"]
        for want_shape, mine, rank in (((2, 2), got["saved22"], r["rank"]), ((1, 4), restored14, r["rank"])):
            want = _cut_for(whole, like, arch, want_shape, rank)
            assert len(want) == len(mine)
            for a, b in zip(mine, want):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ranks_mod.CKPT_CASES)
def test_a_one_process_checkpoint_restores_on_2x2(mesh_runs, case):
    """The one-process checkpoint of the same step, restored on (2, 2):
    each rank holds its cut of the one-process state bitwise."""
    _, ranks, inputs, ckpt = mesh_runs
    arch, like = _one_state(case, inputs)
    whole = restore_checkpoint(str(ckpt / case / "one"), 1, like)
    for r in ranks:
        step, mine = r["ckpt"][case]["restored22"]
        assert step == 1
        for a, b in zip(mine, _cut_for(whole, like, arch, (2, 2), r["rank"])):
            np.testing.assert_array_equal(a, b)


def test_gradients_through_the_collectives_match_one_process(mesh_runs):
    """On the (1, 4) mesh: the column- then row-parallel MLP and the
    vocab-parallel logits under a loss every rank computes whole give each
    rank the whole input gradient (``enter``'s sum) and its slice of the
    weights' (``row_parallel_sum`` and ``gather_last`` pass the cotangent
    through, or take the rank's columns); an all-to-all's gradient is the
    reverse exchange."""
    _, ranks, _, _ = mesh_runs
    u = {k: t(v).requires_grad_(v.dtype == np.float32) for k, v in tp_cases.unit_inputs().items()}
    y = apply_mlp({k: u[k] for k in ("w_gate", "w_up", "w_down")}, u["x"], "swiglu")
    loss = (y * y).sum() + torch.logsumexp(lm_logits(u["h"], u["table"], u["w_out"]), -1).sum()
    loss.backward()
    for r in ranks:
        got, mi = r["units"], MeshInfo(model_index=r["rank"], ep_size=4)
        assert_close(got["loss"], loss.detach())
        assert_close(got["x"], u["x"].grad)
        assert_close(got["h"], u["h"].grad)
        for k, axis in (("w_gate", -1), ("w_up", -1), ("w_down", -2), ("w_out", -1)):
            assert_close(got[k], rank_slice(u[k].grad, axis, mi))
        np.testing.assert_array_equal(got["a2a"], np.full_like(got["a2a"], r["rank"] + 1))


def test_rank_join_inverts_rank_part():
    """``rank_join`` of the parts ``rank_part`` cuts for each rank of a
    model group gives the leaf back bitwise: a fused Mamba2 ``w_in``
    (split and whole parts), an expert stack, a vocabulary-split leaf and
    a leaf held whole."""
    arch = tp_cases.arch(tget, "zamba2")
    m = 4
    rng = np.random.default_rng(5)
    lm = TLM(arch, dtype=torch.float32, device="cpu")
    shapes = {"mamba_seg/mamba/w_in": tuple(lm.shapes()["mamba_seg"][0][0]["mamba"]["w_in"].shape),
              "embed": tuple(lm.shapes()["embed"].shape), "final_norm/scale": (arch.d_model,)}
    for name, shape in shapes.items():
        a = rng.standard_normal(shape).astype(np.float32)
        path = tuple(name.split("/"))
        parts = [rank_part(a, path, arch, MeshInfo(model_index=i, ep_size=m)) for i in range(m)]
        np.testing.assert_array_equal(rank_join(parts, path, shape, arch, m), a)
    experts = rng.standard_normal((8, 3, 2)).astype(np.float32)
    path = ("blocks", "moe", "w_up")
    parts = [rank_part(experts, path, None, MeshInfo(model_index=i, ep_size=m)) for i in range(m)]
    assert parts[1].shape == (2, 3, 2)
    np.testing.assert_array_equal(rank_join(parts, path, experts.shape, None, m), experts)


def test_launch_train_on_a_2x2_mesh_then_resume(tmp_path, capfd):
    """``python -m repro_torch.launch.train --mesh 2x2 --device cpu``: four
    gloo ranks train a reduced MoE arch three steps with microbatches and
    compression and checkpoint it; a second run with more steps resumes
    from the last checkpoint on the mesh, and one process resumes the
    mesh's checkpoint too."""
    argv = ["--arch", "qwen3-moe-30b-a3b", "--device", "cpu", "--seq-len", "16", "--global-batch", "4",
            "--microbatches", "2", "--grad-compression", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
            "--log-every", "1"]
    hist = launch_train.main(argv + ["--steps", "3", "--mesh", "2x2"])
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist)
    assert latest_step(str(tmp_path)) == 3
    more = launch_train.main(argv + ["--steps", "5", "--mesh", "2x2"])
    assert [h["step"] for h in more] == [3, 4]
    assert latest_step(str(tmp_path)) == 5
    one = launch_train.main(argv + ["--steps", "6"])
    assert [h["step"] for h in one] == [5]
    out = capfd.readouterr().out
    assert "mesh={'data': 2, 'model': 2}" in out and "done: 3 steps" in out and "restarts=0" in out
