"""The port's side of ``tests/test_torch_train_mesh.py``: the function each
of four gloo ranks runs (``repro_torch.launch.mesh.run_on_mesh``), and the
card test's rank function.  It imports no JAX; the test holds what the
ranks return against the JAX subprocess's results and one process."""

from __future__ import annotations

import os

import numpy as np
import torch

import _torch_train_mesh_cases as cases
from _torch_ep_cases import flatten, unflatten
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import get_arch
from repro_torch.launch.mesh import make_mesh, mesh_info_for
from repro_torch.models import LM
from repro_torch.models import collectives as coll
from repro_torch.models.layers import apply_mlp, lm_logits
from repro_torch.models.sharding import rank_slice
from repro_torch.train import compression, optimizer
from repro_torch.train import train_loop as tloop
from repro_torch.train import tree as tr
from repro_torch.train.checkpoint import MeshCheckpoints

# the proxies whose train state goes through the mesh checkpoints
CKPT_CASES = ("qwen3-moe", "zamba2")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _batch(inp: dict, case: str, i: int) -> dict:
    return {k: _t(v) for k, v in cases.batch(inp, case, i).items()}


def _params(inp: dict, case: str, arch, mi) -> dict:
    tree = unflatten(inp, f"{case}/params/")
    return tr.tree_map(lambda p: p.requires_grad_(True), params_from_numpy(tree, "cpu", torch.float32, mi, arch))


def _np(tree) -> dict:
    return flatten(params_to_numpy(tree))


def _run(inp: dict, case: str, shape, ep, mesh) -> dict:
    """Loss and gradients of batch 0, then the run's train steps (with
    compression, the residual after the first step too)."""
    arch = cases.run_arch(get_arch, case, ep)
    mi = mesh_info_for(mesh, cases.BATCH)
    lm = LM(arch, dtype=torch.float32, device="cpu", mesh_info=mi)
    if ep:
        os.environ["REPRO_EP_MODE"] = ep
    try:
        loss, metrics, grads = tloop.loss_and_grads(lm, _params(inp, case, arch, mi), _batch(inp, case, 0))
        out = {"loss": float(loss), "ce": float(metrics["ce"]), "moe_aux": float(metrics["aux"].moe_aux),
               "grads": _np(grads), "data_index": mi.data_index, "model_index": mi.model_index}
        for run, kw in cases.step_runs(case, shape, ep):
            tc = tloop.TrainConfig(opt=optimizer.AdamWConfig(**cases.OPT), **kw)
            p = _params(inp, case, arch, mi)
            state = optimizer.init_opt_state(p)
            res = compression.init_residual(p) if tc.grad_compression else torch.zeros(())
            step = tloop.make_train_step(lm, tc)
            metrics = []
            for i in range(cases.STEPS):
                p, state, res, m = step(p, state, _batch(inp, case, i), res)
                metrics.append({k: float(m[k]) for k in cases.METRICS})
                if i == 0 and tc.grad_compression:  # the first step's quantisation error
                    first_res = _np(tr.tree_map(torch.clone, res))
            out[run] = {"metrics": metrics, "params": _np(p)}
            if tc.grad_compression:
                out[run]["residual"] = first_res
    finally:
        os.environ.pop("REPRO_EP_MODE", None)
    return out


def _state(lm, inp: dict, case: str) -> dict:
    """The train state after one step with compression: parameters,
    moments, residual and step counter all nonzero."""
    arch, mi = lm.arch, lm.mi
    tc = tloop.TrainConfig(opt=optimizer.AdamWConfig(**cases.OPT), grad_compression=True)
    p = _params(inp, case, arch, mi)
    opt, res = optimizer.init_opt_state(p), compression.init_residual(p)
    p, opt, res, _ = tloop.make_train_step(lm, tc)(p, opt, _batch(inp, case, 0), res)
    return {"params": p, "opt": opt, "res": res}


def _ckpt(inp: dict, meshes: dict, ckpt_root: str) -> dict:
    """For each case of ``CKPT_CASES``: the state after one step on (2, 2),
    saved to ``ckpt_root/<case>/mesh`` and restored on (1, 4); and the
    one-process checkpoint the test wrote to ``ckpt_root/<case>/one``
    restored on (2, 2).  Each as this rank's numpy leaves."""
    out = {}
    for case in CKPT_CASES:
        arch = cases.run_arch(get_arch, case)
        lm22, lm14 = (LM(arch, dtype=torch.float32, device="cpu", mesh_info=mesh_info_for(meshes[s], cases.BATCH))
                      for s in ((2, 2), (1, 4)))
        state = _state(lm22, inp, case)
        MeshCheckpoints(lm22).save(os.path.join(ckpt_root, case, "mesh"), 1, state)
        like14 = _state(lm14, inp, case)
        step14, got14 = MeshCheckpoints(lm14).restore_latest(os.path.join(ckpt_root, case, "mesh"), like14)
        step22, got22 = MeshCheckpoints(lm22).restore_latest(os.path.join(ckpt_root, case, "one"), state)
        leaves = lambda s: [t.detach().numpy().copy() for t in tr.leaves(s)]  # noqa: E731
        out[case] = {"saved22": leaves(state), "restored14": (step14, leaves(got14)),
                     "restored22": (step22, leaves(got22)),
                     "requires_grad": all(t.requires_grad for t in tr.leaves(got14["params"]))}
    return out


def _units(mesh) -> dict:
    """Gradients through the collectives on this rank of the (1, 4) mesh:
    the column- then row-parallel MLP and the vocab-parallel logits under
    a loss every rank computes whole, and an all-to-all under a loss that
    weighs each received row by the rank it came from."""
    from _torch_tp_cases import unit_inputs

    u = {k: _t(v) for k, v in unit_inputs().items()}
    mi = mesh_info_for(mesh, 4)
    group = mi.model_group
    mine = {"w_gate": rank_slice(u["w_gate"], -1, mi), "w_up": rank_slice(u["w_up"], -1, mi),
            "w_down": rank_slice(u["w_down"], -2, mi), "w_out": rank_slice(u["w_out"], -1, mi)}
    mine = {k: v.clone().requires_grad_(True) for k, v in mine.items()}
    x, h = u["x"].clone().requires_grad_(True), u["h"].clone().requires_grad_(True)
    y = apply_mlp(mine, x, "swiglu", group)
    logits = lm_logits(h, u["table"], mine["w_out"], group)
    loss = (y * y).sum() + torch.logsumexp(logits, -1).sum()
    loss.backward()
    z = (u["x"][:4].clone() * (mi.model_index + 1)).requires_grad_(True)  # (4, 8, 32): a chunk a rank
    got = coll.all_to_all(z, group)
    (got * torch.arange(1.0, 5.0)[:, None, None]).sum().backward()
    return {"x": x.grad.numpy(), "h": h.grad.numpy(), "loss": float(loss.detach()),
            **{k: v.grad.numpy() for k, v in mine.items()}, "a2a": z.grad.numpy()}


def rank_main(mesh22, inputs_path: str, ckpt_root: str, names=cases.CASES) -> dict:
    """Everything the four ranks run; ``mesh22`` is the (2, 2) mesh of
    ``run_on_mesh``, and the (1, 4) mesh is built on the same ranks."""
    torch.set_num_threads(1)
    inp = dict(np.load(inputs_path))
    mesh14 = make_mesh((1, 4), ("data", "model"), backend=mesh22.backend, device=mesh22.device)
    meshes = {(1, 4): mesh14, (2, 2): mesh22}
    out = {"rank": mesh22.rank, "units": _units(mesh14)}
    for case, shape, ep in cases.runs(names):
        out[cases.key(case, shape, ep)] = _run(inp, case, shape, ep, meshes[shape])
    out["ckpt"] = _ckpt(inp, meshes, ckpt_root)
    return out


def card_case():
    """The card test's model and batch: the qwen3-moe proxy with 2 layers
    (4 heads on 2 kv heads: split by heads on the (2, 2) mesh) under
    ``expert_exec="dense"``, and a global batch of 4 x 64 tokens."""
    from _torch_port import proxy_arch

    arch = proxy_arch(get_arch, "dense")
    rng = np.random.default_rng(17)
    toks = rng.integers(0, arch.vocab_size, (4, 65)).astype(np.int64)
    return arch, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def cuda_rank_main(mesh) -> dict:
    """One of four ranks sharing one card on gloo as a (2, 2) mesh: the
    card proxy drawn keyed from seed 2 in float32, its gradients of the
    global batch after the data-parallel reduce; then in bf16 two train
    steps with int8 compression.  Returns the gradients and the bf16
    parameters after the steps (float32 on the host, with their paths) and
    the losses."""
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    arch, b = card_case()
    mi = mesh_info_for(mesh, 4)
    batch = {k: _t(v).to(mesh.device) for k, v in b.items()}
    tc = tloop.TrainConfig(opt=optimizer.AdamWConfig(**cases.OPT), grad_compression=True)
    lm32 = LM(arch, torch.float32, mesh.device, mesh_info=mi)
    _, _, grads = tloop.loss_and_grads(lm32, tloop.init_train_state(lm32, 2, tc)[0], batch)
    lm = LM(arch, torch.bfloat16, mesh.device, mesh_info=mi)
    params, opt, res = tloop.init_train_state(lm, 2, tc)
    step = tloop.make_train_step(lm, tc)
    losses = []
    for _ in range(2):
        params, opt, res, m = step(params, opt, batch, res)
        losses.append(float(m["loss"]))
    host = lambda tree: [(p, x.detach().float().cpu()) for p, x in tr.leaves_with_paths(tree)]  # noqa: E731
    return {"grads": host(grads), "params": host(params), "losses": losses,
            "model_index": mi.model_index, "data_index": mi.data_index}
