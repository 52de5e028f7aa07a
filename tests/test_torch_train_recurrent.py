"""Training of the hybrid, ssm and audio families in the port against the
JAX reference on the CPU: ``LM.forward``, ``LM.loss`` and every gradient
leaf against ``jax.value_and_grad(lm.loss)``, with per-block remat and
without; RWKV6's checkpointed WKV chunks; three AdamW train steps against
the reference's train step; the launcher.

Models are JAX's ``reduced()`` zamba2-7b (two segments of the shared
attention block and one Mamba2 block, then a 1-block tail: the shared
block's gradient sums two applications), rwkv6-7b (2 blocks) and
whisper-base (2 encoder and 2 decoder layers over 16 frames), in float32
with the JAX weights crossing through ``repro_torch.bridge`` and the
gradients coming back through ``params_to_numpy``.  Each family's JAX
gradients are computed once, in a module fixture.

Tolerance: float32 ``F32_TOL`` (``tests/test_fused_swiglu.py:49``), but
for rwkv6's gradients and train steps ``RWKV_TOL``.  RWKV6's ``ln_x``
normalises each head's WKV output over its 16 channels, and at the first
position, where the state is still zero, that output's variance is tiny
(1.3e-6 against ``ln_x``'s eps of 1e-5 in these weights, a median of 24
over the sequence): the backward pass through it multiplies the two
frameworks' float32 rounding by ~300.  Both packages run the same
function there; their gradient leaves differ by up to 3e-5 of the
leaf's largest element (the embedding's, one element of 16384 beyond
``F32_TOL``), the forward and the loss within ``F32_TOL``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_port import F32_TOL, assert_close, pin_threads, t

pin_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget  # noqa: E402
from repro.data import DataConfig as JDataConfig, SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_loop as jloop  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.configs import get_arch as tget  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import LM as TLM  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_loop as tloop  # noqa: E402
from repro_torch.train import tree as tr  # noqa: E402

NAMES = ("zamba2-7b", "rwkv6-7b", "whisper-base")
RWKV_TOL = dict(rtol=1e-4, atol=1e-4)  # the module docstring says why
B, S, FRAMES = 2, 16, 16  # rows, tokens (whisper: decoder tokens), encoder frames


def _batch(arch, seed: int = 0) -> dict:
    """Seeded numpy batch: tokens and next-token labels, and for whisper
    the encoder's stub frames."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, arch.vocab_size, (B, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if arch.family == "audio":
        out["embeds"] = (rng.standard_normal((B, FRAMES, arch.d_model)) * 0.1).astype(np.float32)
    return out


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: t(v) for k, v in b.items()}


def _port(name: str, tree: dict, remat: bool = False, **arch_kw):
    tlm = TLM(dataclasses.replace(tget(name).reduced(), **arch_kw), dtype=torch.float32, device="cpu",
              remat=remat)
    tp = tr.tree_map(lambda p: p.requires_grad_(True), params_from_numpy(tree, "cpu", torch.float32))
    return tlm, tp


def _tol(name: str) -> dict:
    """The tolerance of a family's gradients and train steps."""
    return RWKV_TOL if name == "rwkv6-7b" else F32_TOL


def _assert_trees_close(got_port, want_jax, tol=F32_TOL):
    """Every leaf of a port tree (through ``params_to_numpy``) against the
    JAX tree, leaf for leaf, with the leaf's path in the message."""
    got = params_to_numpy(got_port)
    assert jax.tree.structure(got) == jax.tree.structure(want_jax)
    for (path, want), have in zip(jax.tree_util.tree_leaves_with_path(want_jax), jax.tree.leaves(got)):
        np.testing.assert_allclose(have, np.asarray(want, np.float32), err_msg=jax.tree_util.keystr(path),
                                   **tol)


@pytest.fixture(scope="module", params=NAMES)
def reference(request):
    """A family's JAX weights, batch, forward and loss with its gradients."""
    name = request.param
    jlm = JLM(jget(name).reduced(), dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(3)))
    jp = jax.tree.map(jnp.asarray, tree)
    b = _batch(jlm.arch)
    jh, ((jl, jm), jg) = jax.jit(lambda p, b: (jlm.forward(p, b)[0], jax.value_and_grad(
        jlm.loss, has_aux=True)(p, b)))(jp, _jbatch(b))
    return dict(name=name, tree=tree, batch=b, h=np.asarray(jh), loss=float(jl), ce=float(jm["ce"]), grads=jg)


def test_forward_matches_jax(reference):
    tlm, tp = _port(reference["name"], reference["tree"])
    h, aux = tlm.forward(tp, _tbatch(reference["batch"]))
    assert h.shape == (B, S, tlm.arch.d_model)
    assert_close(h, reference["h"])
    assert float(aux.moe_aux) == 0 and int(aux.dropped) == 0


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_loss_and_every_gradient_leaf_match_jax(reference, remat):
    """The loss, its cross-entropy and every gradient leaf, with per-block
    recomputation and without; every leaf's gradient is finite and all but
    the padded embedding rows' reach the loss."""
    tlm, tp = _port(reference["name"], reference["tree"], remat=remat)
    loss, metrics, grads = tloop._loss_and_grads(tlm, tp, _tbatch(reference["batch"]))
    assert_close(loss, reference["loss"])
    assert_close(metrics["ce"], reference["ce"])
    _assert_trees_close(grads, reference["grads"], _tol(reference["name"]))
    flat = tr.leaves(grads)
    assert all(torch.isfinite(g).all() for g in flat)
    assert all((g != 0).any() for g in flat)


@pytest.mark.parametrize("name", NAMES)
def test_remat_gives_the_same_gradients(name):
    """Per-block recomputation (``torch.utils.checkpoint``) changes no
    gradient: bitwise on the CPU."""
    tree = jax.tree.map(np.asarray, JLM(jget(name).reduced(), dtype=jnp.float32).init(jax.random.PRNGKey(4)))
    b = _tbatch(_batch(tget(name).reduced(), seed=1))
    got = [tloop._loss_and_grads(*_port(name, tree, remat=remat), b)[2] for remat in (False, True)]
    for a, c in zip(tr.leaves(got[0]), tr.leaves(got[1])):
        assert torch.equal(a, c)


def test_wkv_chunks_give_the_gradients_of_one_chunk():
    """RWKV6's WKV recurrence in 4 chunks of 4 steps, each recomputed in the
    backward pass, against one chunk of 16: the loss and every gradient
    leaf within ``F32_TOL``, and under autograd the chunks do run under
    ``torch.utils.checkpoint`` (its recomputation is what keeps only the
    chunk boundaries' states)."""
    name = "rwkv6-7b"
    tree = jax.tree.map(np.asarray, JLM(jget(name).reduced(), dtype=jnp.float32).init(jax.random.PRNGKey(5)))
    b = _tbatch(_batch(tget(name).reduced(), seed=2))
    base = tget(name).reduced().ssm
    runs = {}
    calls = []
    scan = ssm._wkv_scan

    def counted(*args):
        calls.append(args[0].shape[1])
        return scan(*args)

    ssm._wkv_scan = counted
    try:
        for chunk in (4, S):
            calls.clear()
            lm, tp = _port(name, tree, ssm=dataclasses.replace(base, wkv_chunk=chunk))
            runs[chunk] = tloop._loss_and_grads(lm, tp, b)
            # forward, then each chunk again in the backward pass, per block
            assert calls == [chunk] * (2 * (S // chunk) * lm.arch.n_layers)
    finally:
        ssm._wkv_scan = scan
    assert_close(runs[4][0], runs[S][0])
    for a, c in zip(tr.leaves(runs[4][2]), tr.leaves(runs[S][2])):
        assert_close(a, c.numpy())


def test_mamba2_sequence_form_leaves_its_input_state_alone():
    """Under autograd the chunked SSD neither writes to the state it starts
    from nor needs it to be a leaf: the gradient reaches the input state."""
    arch = tget("zamba2-7b").reduced()
    lm = TLM(arch, dtype=torch.float32, device="cpu")
    blk = tr.tree_map(lambda p: p.requires_grad_(True), lm.init(seed=0)["mamba_seg"][0][0]["mamba"])
    x = torch.randn((B, 40, arch.d_model), generator=torch.Generator().manual_seed(0))
    st = ssm.mamba2_init_state(B, arch.d_model, arch.ssm, torch.float32, "cpu")
    st = ssm.Mamba2State(st.conv.normal_().requires_grad_(True), st.ssm.normal_().requires_grad_(True))
    versions = [s._version for s in st]
    y, new = ssm.mamba2_seq(blk, x, arch.ssm, st)
    (y.square().sum() + new.ssm.sum()).backward()
    assert [s._version for s in st] == versions
    assert st.ssm.grad is not None and st.conv.grad is not None and blk["w_in"].grad is not None


@pytest.mark.parametrize("name", ["zamba2-7b", "rwkv6-7b"])
def test_three_train_steps_track_jax(name):
    """Three ``make_train_step`` steps (AdamW, 2 warmup steps, 2
    microbatches) on the synthetic batches from the reference's weights:
    every step's loss, grad norm and lr, and the parameters and first
    moments after the last step, against the reference's jitted train
    step."""
    opt = jopt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    jcfg = jloop.TrainConfig(opt=opt, n_microbatches=2)
    tcfg = tloop.TrainConfig(opt=topt.AdamWConfig(**dataclasses.asdict(opt)), n_microbatches=2)
    jlm = JLM(jget(name).reduced(), dtype=jnp.float32)
    jp = jlm.init(jax.random.PRNGKey(6))
    tlm = TLM(tget(name).reduced(), dtype=torch.float32, device="cpu", remat=True)
    tp, tstate, tres = tloop.init_train_state(tlm, 0, tcfg)
    with torch.no_grad():  # the reference's weights into the port's fresh state
        tr.tree_map(lambda a, c: a.copy_(c), tp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                                                                   torch.float32))
    jstate, jres = jopt.init_opt_state(jp), jnp.zeros(())
    jstep, tstep = jax.jit(jloop.make_train_step(jlm, jcfg)), tloop.make_train_step(tlm, tcfg)
    jdata = JSyntheticLM(JDataConfig(vocab_size=jlm.arch.vocab_size, seq_len=S, global_batch=4))
    tdata = SyntheticLM(DataConfig(vocab_size=jlm.arch.vocab_size, seq_len=S, global_batch=4))
    for i in range(3):
        jp, jstate, jres, jm = jstep(jp, jstate, _jbatch(jdata.batch(i)), jres)
        tp, tstate, tres, tm = tstep(tp, tstate, _tbatch(tdata.batch(i)), tres)
        assert_close(tm["loss"], jm["loss"])
        assert_close(tm["lr"], jm["lr"])
        assert_close(tm["grad_norm"], jm["grad_norm"], **_tol(name))
    _assert_trees_close(tp, jp, _tol(name))
    _assert_trees_close(tstate.m, jstate.m, _tol(name))
    assert all(p.requires_grad and p.is_leaf for p in tr.leaves(tp))


def test_whisper_microbatches_slice_frames_with_tokens():
    """Two microbatches of a whisper batch (frames, decoder tokens and
    labels sliced by rows together) give the full batch's loss and
    gradients."""
    name = "whisper-base"
    tree = jax.tree.map(np.asarray, JLM(jget(name).reduced(), dtype=jnp.float32).init(jax.random.PRNGKey(7)))
    b = _tbatch(_batch(tget(name).reduced(), seed=3))
    lm, tp = _port(name, tree)
    full = tloop._microbatched_grads(lm, tp, b, 1)
    two = tloop._microbatched_grads(lm, tp, b, 2)
    assert_close(two[0], full[0].numpy())
    for a, c in zip(tr.leaves(two[2]), tr.leaves(full[2])):
        assert_close(a, c.numpy())


def test_launcher_trains_zamba2_on_the_cpu(tmp_path):
    """``python -m repro_torch.launch.train --arch zamba2-7b --device cpu``
    for three steps: three finite losses, checkpoints written."""
    from repro_torch.launch import train

    hist = train.main(["--arch", "zamba2-7b", "--device", "cpu", "--steps", "3", "--seq-len", "16",
                       "--global-batch", "2", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    losses = [h["loss"] for h in hist if "loss" in h]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert any(tmp_path.iterdir())


def test_launcher_refuses_whisper_naming_the_frames(tmp_path):
    from repro_torch.launch import train

    with pytest.raises(ValueError, match="frames"):
        train.main(["--arch", "whisper-base", "--device", "cpu", "--steps", "1", "--ckpt-dir", str(tmp_path)])
