"""The port's training path against the JAX reference on the CPU:
``LM.forward``, ``LM.loss`` and every gradient leaf against
``jax.value_and_grad(lm.loss)``, microbatching, one AdamW step and its
decay mask, the schedule, int8 gradient compression, five train steps,
and the bridge back to the reference's tree layout.

Weights come from the JAX ``LM.init`` and cross through
``repro_torch.bridge``; gradients and optimizer trees come back through
``params_to_numpy``.  Everything is float32 and held to ``F32_TOL``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_port import F32_TOL, assert_close, pin_threads, proxy_arch, t

pin_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget  # noqa: E402
from repro.data import DataConfig as JDataConfig, SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.train import compression as jcomp  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_loop as jloop  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.configs import get_arch as tget  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import LM as TLM  # noqa: E402
from repro_torch.train import compression as tcomp  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_loop as tloop  # noqa: E402
from repro_torch.train import tree as tr  # noqa: E402


def _archs(case: str):
    """(JAX arch, port arch) of a parity case."""
    if case.startswith("qwen3-proxy-"):
        mode = case.removeprefix("qwen3-proxy-")
        return proxy_arch(jget, mode), proxy_arch(tget, mode)
    name, kw = {"qwen1.5-0.5b": ("qwen1.5-0.5b", {}), "qwen2-vl-7b": ("qwen2-vl-7b", {}),
                "deepseek-v2-236b": ("deepseek-v2-236b", {"n_layers": 3})}[case]
    return jget(name).reduced(**kw), tget(name).reduced(**kw)


CASES = ("qwen3-proxy-dense", "qwen3-proxy-dual_path_cost", "qwen1.5-0.5b", "qwen2-vl-7b",
         "deepseek-v2-236b")


def _batch(arch, B: int = 2, S: int = 16, seed: int = 0) -> dict:
    """Seeded numpy batch: tokens and next-token labels, or for the VLM the
    vision-patch stub's embeddings with distinct t/h/w M-RoPE positions."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, arch.vocab_size, (B, S + 1)).astype(np.int32)
    if arch.family != "vlm":
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    s = np.arange(S)
    grid = np.stack([s // 4, s // 2 % 2, s % 2])  # frames of 2 x 2 patches
    return {
        "embeds": rng.standard_normal((B, S, arch.d_model)).astype(np.float32),
        "mrope_positions": np.ascontiguousarray(np.broadcast_to(grid[:, None], (3, B, S))).astype(np.int32),
        "labels": toks[:, 1:],
    }


def _models(case: str, remat: bool = False, seed: int = 0):
    ja, ta = _archs(case)
    jlm = JLM(ja, dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(seed)))
    tlm = TLM(ta, dtype=torch.float32, device="cpu", remat=remat)
    tp = tr.tree_map(lambda p: p.requires_grad_(True), params_from_numpy(tree, "cpu", torch.float32))
    return jlm, jax.tree.map(jnp.asarray, tree), tlm, tp


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: t(v) for k, v in b.items()}


def _assert_trees_close(got_port, want_jax, **tol):
    """Every leaf of a port tree (through ``params_to_numpy``) against the
    JAX tree, leaf for leaf, with the leaf's path in the message."""
    got = params_to_numpy(got_port)
    assert jax.tree.structure(got) == jax.tree.structure(want_jax)
    for (path, want), have in zip(jax.tree_util.tree_leaves_with_path(want_jax), jax.tree.leaves(got)):
        np.testing.assert_allclose(have, np.asarray(want, np.float32), err_msg=jax.tree_util.keystr(path),
                                   **(tol or F32_TOL))


@pytest.fixture(scope="module", params=CASES)
def parity(request):
    """One case's JAX forward, loss and gradients, and the port's, on the
    same weights and batch (the port with per-block remat on the proxy,
    whose blocks are MoE)."""
    case = request.param
    jlm, jp, tlm, tp = _models(case, remat=case.startswith("qwen3"))
    b = _batch(jlm.arch)
    jh, jaux = jlm.forward(jp, _jbatch(b))
    (jl, jm), jg = jax.value_and_grad(jlm.loss, has_aux=True)(jp, _jbatch(b))
    th, taux = tlm.forward(tp, _tbatch(b))
    tl, tm, tg = tloop._loss_and_grads(tlm, tp, _tbatch(b))
    return dict(case=case, jh=jh, jaux=jaux, jl=jl, jm=jm, jg=jg, th=th, taux=taux, tl=tl, tm=tm, tg=tg)


def test_forward_matches_jax(parity):
    assert_close(parity["th"], parity["jh"])
    jaux, taux = parity["jaux"], parity["taux"]
    assert_close(taux.moe_aux, jaux.moe_aux)
    assert int(taux.dropped) == int(jaux.dropped)
    if parity["case"] not in ("qwen1.5-0.5b", "qwen2-vl-7b"):  # a dense model has no counts
        np.testing.assert_array_equal(taux.counts.numpy(), np.asarray(jaux.counts))


def test_loss_and_every_gradient_leaf_match_jax(parity):
    assert_close(parity["tl"], parity["jl"])
    assert_close(parity["tm"]["ce"], parity["jm"]["ce"])
    _assert_trees_close(parity["tg"], parity["jg"])
    # the router and attention leaves get a gradient (the combine weights
    # and the aux loss reach the router)
    flat = [g for g in tr.leaves(parity["tg"])]
    assert all(torch.isfinite(g).all() for g in flat)
    assert sum(int((g != 0).any()) for g in flat) >= len(flat) - 1


def test_remat_gives_the_same_gradients():
    """Per-block recomputation changes no gradient (bitwise on the CPU)."""
    b = _tbatch(_batch(_archs("qwen3-proxy-dense")[0]))
    got = []
    for remat in (False, True):
        _, _, tlm, tp = _models("qwen3-proxy-dense", remat=remat)
        got.append(tloop._loss_and_grads(tlm, tp, b)[2])
    for a, c in zip(tr.leaves(got[0]), tr.leaves(got[1])):
        assert torch.equal(a, c)


@pytest.mark.parametrize("case", ["qwen1.5-0.5b", "qwen2-vl-7b"])
def test_microbatched_equals_full_batch(case):
    """Four microbatches (the VLM's M-RoPE positions sliced on axis 1)
    against the full batch and against the reference's microbatching."""
    jlm, jp, tlm, tp = _models(case)
    b = _batch(jlm.arch, B=4, S=8, seed=1)
    _, _, full = tloop._microbatched_grads(tlm, tp, _tbatch(b), 1)
    loss4, _, g4 = tloop._microbatched_grads(tlm, tp, _tbatch(b), 4)
    for a, c in zip(tr.leaves(full), tr.leaves(g4)):
        assert float((a - c).abs().max()) < 1e-5
    jl4, _, jg4 = jax.jit(lambda p, b: jloop._microbatched_grads(jlm, p, b, 4))(jp, _jbatch(b))
    assert_close(loss4, jl4)
    _assert_trees_close(g4, jg4)


# ---------------------------------------------------------------------------
# optimizer, schedule, compression
# ---------------------------------------------------------------------------


def _grads_like(tree, seed: int):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (0.3 * rng.standard_normal(a.shape)).astype(np.float32), tree)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(moment_dtype):
    """Two AdamW steps on deepseek-v2's reduced tree (MLA, MoE and dense
    leaf names): parameters, both moments, grad_norm and lr against the
    reference.  With float32 moments the first gradient is clipped (norm
    above grad_clip), the second not.  With bfloat16 moments neither is:
    the two packages sum the global norm in different orders, and a clip
    scale one ulp apart can move a moment across a bfloat16 rounding
    boundary, a step of 2^-8 that no float32 tolerance covers."""
    cfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=5.0,
                           moment_dtype=moment_dtype)
    tcfg = topt.AdamWConfig(**dataclasses.asdict(cfg))
    _, jp, _, _ = _models("deepseek-v2-236b")
    tree = jax.tree.map(np.asarray, jp)
    tp = params_from_numpy(tree, "cpu", torch.float32)
    jstate = jopt.init_opt_state(jp, jnp.dtype(moment_dtype))
    tstate = topt.init_opt_state(tp, moment_dtype)
    for i, scale in enumerate((1.0 if moment_dtype == "float32" else 0.01, 0.01)):
        g = jax.tree.map(lambda a: a * scale, _grads_like(tree, i))
        jp, jstate, jm = jax.jit(jopt.adamw_update, static_argnums=0)(cfg, jp, jax.tree.map(jnp.asarray, g),
                                                                       jstate)
        tp, tstate, tm = topt.adamw_update(tcfg, tp, params_from_numpy(g, "cpu", torch.float32), tstate)
        assert int(tstate.step) == int(jstate.step) == i + 1
        assert_close(tm["grad_norm"], jm["grad_norm"])
        assert_close(tm["lr"], jm["lr"])
        _assert_trees_close(tp, jp)
        for got, want in ((tstate.m, jstate.m), (tstate.v, jstate.v)):
            assert {x.dtype for x in tr.leaves(got)} == {getattr(torch, moment_dtype)}
            _assert_trees_close(got, jax.tree.map(lambda a: a.astype(jnp.float32), want))
    assert float(jm["grad_norm"]) < 5.0


@pytest.mark.parametrize("max_norm", [1.0, 1e3], ids=["clipped", "unclipped"])
def test_clip_by_global_norm_matches_jax(max_norm):
    tree = jax.tree.map(np.asarray, _models("qwen1.5-0.5b")[1])
    g = _grads_like(tree, 5)
    jg, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
    tg, tn = topt.clip_by_global_norm(params_from_numpy(g, "cpu", torch.float32), max_norm)
    assert_close(tn, jn)
    assert_close(topt.global_norm(tg), min(max_norm, float(jn)))
    _assert_trees_close(tg, jg)


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "deepseek-v2-236b", "zamba2-7b", "rwkv6-7b",
                                  "whisper-base"])
def test_decay_mask_matches_jax_leaf_for_leaf(name):
    """The port's mask on its list-of-blocks paths equals the reference's
    on its stacked tree, leaf for leaf: ``w_up``, ``w_out`` and
    ``w_router`` (which hold a ``u``) are not decayed, ``w_gate`` and
    ``w_down`` are."""
    jtree = JLM(jget(name).reduced(), dtype=jnp.float32).init(jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(p): jopt._decay_mask(p) for p, _ in jax.tree_util.tree_leaves_with_path(jtree)}
    ttree = TLM(tget(name).reduced(), dtype=torch.float32, device="cpu").init(seed=0)
    got = {}
    for path, _ in tr.leaves_with_paths(ttree):
        got["".join(f"[{k!r}]" for k in path if isinstance(k, str))] = topt.decay_mask(path)
    assert got == want
    if name == "qwen3-moe-30b-a3b":
        assert not got["['blocks']['moe']['w_up']"] and not got["['blocks']['moe']['w_router']"]
        assert not got["['w_out']"] and got["['blocks']['moe']['w_gate']"]
        assert got["['blocks']['moe']['w_down']"] and not got["['final_norm']['scale']"]


def test_lr_schedule_matches_jax():
    cfg = jopt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    tcfg = topt.AdamWConfig(**dataclasses.asdict(cfg))
    for step, want in ((0, 0.0), (5, 0.5), (10, 1.0), (55, None), (100, 0.1), (150, 0.1)):
        got = topt.lr_schedule(tcfg, torch.tensor(step, dtype=torch.int32))
        assert_close(got, jopt.lr_schedule(cfg, jnp.asarray(step)))
        if want is not None:
            assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-7)


def test_compress_matches_jax_exactly():
    """int8 values and scales equal to the reference's, over two steps of
    error feedback (the second from a non-zero residual)."""
    rng = np.random.default_rng(3)
    g = {"a": rng.standard_normal((64, 32)).astype(np.float32),
         "b": [(1e-3 * rng.standard_normal((7,))).astype(np.float32), np.zeros((3,), np.float32)]}
    jres = jcomp.init_residual(jax.tree.map(jnp.asarray, g))
    tres = tcomp.init_residual(tr.tree_map(t, g))
    for _ in range(2):
        jc, jres = jcomp.compress(jax.tree.map(jnp.asarray, g), jres)
        tc, tres = tcomp.compress(tr.tree_map(t, g), tres)
        for got, want in zip(tr.leaves(tc.q), jax.tree.leaves(jc.q)):
            assert got.dtype == torch.int8
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for got, want in zip(tr.leaves(tc.scale), jax.tree.leaves(jc.scale)):
            assert float(got) == float(want)
        for got, want in zip(tr.leaves(tres), jax.tree.leaves(jres)):
            assert_close(got, want)
        for got, want in zip(tr.leaves(tcomp.decompress(tc)), jax.tree.leaves(jcomp.decompress(jc))):
            assert_close(got, want)
    assert tcomp.compressed_bytes(tc) == jcomp.compressed_bytes(jc) == 64 * 32 + 7 + 3 + 3 * 4


@pytest.mark.parametrize("case", ["qwen3-moe", "deepseek-v2", "zamba2", "rwkv6", "whisper"])
def test_compress_takes_a_layer_stack_as_one_leaf(case):
    """A gradient tree in the reference's layout (each layer scaled
    differently, so a stack's largest element is one layer's) and the
    same tree in the port's, its stacks split into a leaf a layer: the
    port's ``compress`` with ``stack_ids`` gives every layer of a stack
    the scale of the reference's stacked leaf, and the same int8 values
    and residual."""
    import _torch_train_mesh_cases as mcases
    from _torch_ep_cases import flatten, unflatten

    lm = TLM(mcases.run_arch(tget, case), dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(7)
    g = {k: (rng.standard_normal(v.shape) * np.arange(1, v.shape[0] + 1).reshape((-1,) + (1,) * (v.ndim - 1))
             ).astype(np.float32) for k, v in flatten(params_to_numpy(lm.init(0))).items()}
    ported = params_from_numpy(unflatten(g, ""), "cpu", torch.float32)
    jc, jres = jcomp.compress(jax.tree.map(jnp.asarray, g), jcomp.init_residual(jax.tree.map(jnp.asarray, g)))
    tc, tres = tcomp.compress(ported, tcomp.init_residual(ported), tcomp.stack_ids(ported))
    want_q, want_s = flatten(jax.tree.map(np.asarray, jc.q)), flatten(jax.tree.map(np.asarray, jc.scale))
    got_q = flatten(params_to_numpy(tr.tree_map(lambda q: q.float(), tc.q)))
    assert set(got_q) == set(want_q)
    for (path, s), _ in zip(tr.leaves_with_paths(tc.scale), tr.leaves(ported)):
        assert float(s) == float(want_s["/".join(str(k) for k in path if not isinstance(k, int))]), path
    for name, q in got_q.items():
        np.testing.assert_array_equal(q, want_q[name].astype(np.float32), err_msg=name)
    want_r = flatten(jax.tree.map(np.asarray, jres))
    for name, r in flatten(params_to_numpy(tres)).items():
        assert_close(r, want_r[name])


@pytest.mark.parametrize("compression", [False, True], ids=["plain", "int8"])
def test_five_train_steps_track_jax(compression):
    """Five ``make_train_step`` steps on qwen1.5-0.5b reduced, on the
    synthetic batches: every step's loss, grad norm and lr against the
    reference's, and without compression the parameters after the last
    step, all to ``F32_TOL``.

    With compression an element whose quantised value sits at a rounding
    boundary takes the neighbouring int8 value under float32 noise, a jump
    of a whole scale step (1/127 of the leaf's largest element) that the
    next steps carry on; there the losses are held to rtol 1e-4 and the
    grad norms to rtol 1e-2, and the int8 values themselves are held
    exactly on equal inputs in ``test_compress_matches_jax_exactly``."""
    opt = jopt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    jcfg = jloop.TrainConfig(opt=opt, grad_compression=compression)
    tcfg = tloop.TrainConfig(opt=topt.AdamWConfig(**dataclasses.asdict(opt)), grad_compression=compression)
    jlm, jp, tlm, _ = _models("qwen1.5-0.5b")
    tp, tstate, tres = tloop.init_train_state(tlm, 0, tcfg)
    with torch.no_grad():  # the reference's weights into the port's fresh state
        tr.tree_map(lambda a, b: a.copy_(b), tp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                                                                   torch.float32))
    jstate = jopt.init_opt_state(jp)
    jres = jcomp.init_residual(jp) if compression else jnp.zeros(())
    jstep, tstep = jax.jit(jloop.make_train_step(jlm, jcfg)), tloop.make_train_step(tlm, tcfg)
    jdata = JSyntheticLM(JDataConfig(vocab_size=jlm.arch.vocab_size, seq_len=16, global_batch=4))
    tdata = SyntheticLM(DataConfig(vocab_size=jlm.arch.vocab_size, seq_len=16, global_batch=4))
    loss_tol = dict(rtol=1e-4, atol=0) if compression else F32_TOL
    norm_tol = dict(rtol=1e-2, atol=0) if compression else F32_TOL
    losses = []
    for i in range(5):
        jp, jstate, jres, jm = jstep(jp, jstate, _jbatch(jdata.batch(i)), jres)
        tp, tstate, tres, tm = tstep(tp, tstate, _tbatch(tdata.batch(i)), tres)
        assert_close(tm["loss"], jm["loss"], **loss_tol)
        assert_close(tm["grad_norm"], jm["grad_norm"], **norm_tol)
        assert_close(tm["lr"], jm["lr"])
        assert int(tm["dropped"]) == int(jm["dropped"]) == 0
        losses.append(float(tm["loss"]))
    assert losses[-1] < losses[0]
    assert all(p.requires_grad and p.is_leaf for p in tr.leaves(tp))
    if not compression:
        _assert_trees_close(tp, jp)
        _assert_trees_close(tstate.m, jstate.m)


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "deepseek-v2-236b", "qwen2-vl-7b", "zamba2-7b",
                                  "rwkv6-7b", "whisper-base"])
def test_params_to_numpy_round_trips_the_jax_tree(name):
    """``params_from_numpy`` then ``params_to_numpy`` gives the JAX tree
    back bit for bit (stacked blocks, the dense prefix, zamba2's doubly
    stacked segments, whisper's encoder)."""
    tree = jax.tree.map(np.asarray, JLM(jget(name).reduced(), dtype=jnp.float32).init(jax.random.PRNGKey(1)))
    back = params_to_numpy(params_from_numpy(tree, "cpu", torch.float32))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
