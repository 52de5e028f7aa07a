"""The port's side of ``tests/test_torch_tp.py`` and
``tests/test_torch_tp_recurrent.py``: the function each of four gloo ranks
runs (``repro_torch.launch.mesh.run_on_mesh``), and the card test's rank
function.  It imports no JAX, so the ranks start quickly; the
test holds what they return against the JAX subprocess's results and the
one-process model."""

from __future__ import annotations

import numpy as np
import torch

import _torch_tp_cases as cases
from _torch_ep_cases import unflatten
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import get_arch
from repro_torch.launch.mesh import make_mesh, mesh_info_for
from repro_torch.models import LM, moe, ssm
from repro_torch.models import collectives as coll
from repro_torch.models.layers import apply_mlp, embed, lm_logits
from repro_torch.models.sharding import rank_slice


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _record_routes(records: list):
    """Wrap ``moe.route`` so each call appends its token's k + 1 largest
    router probabilities and their experts (the evidence of a near-tie);
    returns the function that restores it."""
    route = moe.route

    def recorded(x, w, cfg):
        r = route(x, w, cfg)
        p = torch.softmax(x.float() @ w.float(), dim=-1)
        top_p, top_i = torch.sort(p, dim=-1, descending=True, stable=True)
        records.append((top_p[:, : cfg.top_k + 1].numpy(), top_i[:, : cfg.top_k + 1].numpy()))
        return r

    moe.route = recorded
    return lambda: setattr(moe, "route", route)


def _lm(inp: dict, case: str, mesh) -> dict:
    arch = cases.arch(get_arch, case)
    mi = mesh_info_for(mesh, cases.BATCH)
    tree = unflatten(inp, f"{case}/params/")
    params = params_from_numpy(tree, "cpu", torch.float32, mi, arch)
    lm = LM(arch, dtype=torch.float32, device="cpu", mesh_info=mi)
    out = {"layout": params_to_numpy(params), "keyed": params_to_numpy(lm.init(seed=3)),
           "tp": lm._tp(), "seq_par": lm._seq_par()}
    routes: list = []
    restore = _record_routes(routes)
    try:
        batch = {k: _t(v) for k, v in cases.prompt(inp, case).items()}
        logits, cache, aux = lm.prefill(params, batch, max_seq=cases.MAX_SEQ)
        out.update(prefill_logits=logits.numpy(), prefill_counts=aux.counts.numpy(),
                   cache_shapes={k: [tuple(c.shape) for c in v] for k, v in cache.items()})
        tok = torch.argmax(logits[:, 0, : arch.vocab_size], dim=-1).to(torch.int32)
        for i in range(cases.STEPS):
            pos = torch.full((cases.BATCH,), cases.PROMPT + i, dtype=torch.int32)
            logits, cache, aux = lm.decode_step(params, {"tokens": tok[:, None], "position": pos}, cache)
            out[f"tokens{i}"] = tok.numpy()
            out[f"decode_logits{i}"] = logits.numpy()
            out[f"decode_counts{i}"] = aux.counts.numpy()
            tok = torch.argmax(logits[:, 0, : arch.vocab_size], dim=-1).to(torch.int32)
    finally:
        restore()
    out["routes"] = routes
    return out


def _units(mesh) -> dict:
    """The vocab-parallel embedding and logits and the row-parallel MLP of
    this rank of the (1, 4) mesh, and the row-parallel sum of bf16
    partials."""
    u = {k: _t(v) for k, v in cases.unit_inputs().items()}
    mi = mesh_info_for(mesh, 4)
    group = mi.model_group  # 4 ranks split every unit input
    table = rank_slice(u["table"], -2, mi)
    mlp = {"w_gate": rank_slice(u["w_gate"], -1, mi), "w_up": rank_slice(u["w_up"], -1, mi),
           "w_down": rank_slice(u["w_down"], -2, mi)}
    part = (u["x"][..., :8] * (mi.model_index + 1) / 3).to(torch.bfloat16)
    return {
        "embed": embed(table, u["tokens"], group, mi.model_index * table.shape[0]).numpy(),
        "logits": lm_logits(u["h"], u["table"], rank_slice(u["w_out"], -1, mi), group).numpy(),
        "tied_logits": lm_logits(u["h"], table, None, group).numpy(),
        "mlp": apply_mlp(mlp, u["x"], "swiglu", group).numpy(),
        "bf16_sum": coll.row_parallel_sum(part, group),
    }


def _gated_norm(mesh) -> dict:
    """Mamba2's gated RMSNorm and out projection on this rank of the (1, 4)
    mesh: its head's channels of ``y``, ``z`` and ``norm_scale`` and its
    rows of ``w_out``, the mean square summed over the group."""
    u = {k: _t(v) for k, v in cases.gated_norm_inputs().items()}
    mi = mesh_info_for(mesh, 4)
    mine = {"norm_scale": rank_slice(u["norm_scale"], -1, mi), "w_out": rank_slice(u["w_out"], -2, mi)}
    return {"gated_norm": ssm._gated_out(mine, rank_slice(u["y"], -1, mi), rank_slice(u["z"], -1, mi),
                                         torch.float32, mi.model_group).numpy()}


def rank_main(mesh22, inputs_path: str, names=cases.CASES) -> dict:
    """Everything the four ranks run for the cases ``names``; ``mesh22`` is
    the (2, 2) mesh of ``run_on_mesh``, and the (1, 4) mesh is built on the
    same ranks."""
    torch.set_num_threads(1)
    inp = dict(np.load(inputs_path))
    mesh14 = make_mesh((1, 4), ("data", "model"), backend=mesh22.backend, device=mesh22.device)
    meshes = {(1, 4): mesh14, (2, 2): mesh22}
    out = {"rank": mesh22.rank, "units": {**_units(mesh14), **_gated_norm(mesh14)}}
    for case in names:
        for shape in cases.MESHES:
            out[f"{case}/{shape[0]}x{shape[1]}"] = _lm(inp, case, meshes[shape])
    return out


def cuda_rank_main(mesh) -> dict:
    """One of four ranks sharing one card on gloo as a (1, 4) mesh: a
    head-sharded GQA decode step in bfloat16 with qwen3-moe's attention
    (32 heads on 4 kv heads, dh 128: 8 heads on one kv head a rank, the
    decode-attention kernel at G 8), at a narrow d_model,
    and the same step as one process on the card, from the same weights and
    cache.  Returns both outputs, the rank's cache and the one process's,
    and the decode-attention launches of the mesh's step alone."""
    from repro_torch.kernels import ops
    from repro_torch.models.attention import gqa_decode
    from repro_torch.models.sharding import rank_attn, rank_cut

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    arch = get_arch("qwen3-moe-30b-a3b")
    cfg = arch.attn
    mi = mesh_info_for(mesh, 4)
    dev, bf = mesh.device, torch.bfloat16
    d, B, T = 256, 4, 64
    g = torch.Generator().manual_seed(0)
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    whole = {"wq": torch.randn(d, H * dh, generator=g) * d**-0.5,
             "wk": torch.randn(d, K * dh, generator=g) * d**-0.5,
             "wv": torch.randn(d, K * dh, generator=g) * d**-0.5,
             "wo": torch.randn(H * dh, d, generator=g) * (H * dh) ** -0.5}
    whole = {k: v.to(bf).to(dev) for k, v in whole.items()}
    x = torch.randn(B, 1, d, generator=g).to(bf).to(dev)
    pos = torch.as_tensor([5, 17, 63, 30], dtype=torch.int32, device=dev)
    cache = [torch.randn(B, T, K, dh, generator=g).to(bf).to(dev) for _ in range(2)]
    one_cache = [c.clone() for c in cache]
    y_one = gqa_decode(whole, x, pos, *one_cache, cfg)
    mine = slice(mi.model_index, mi.model_index + 1)
    rank_cache = [c[:, :, mine].contiguous() for c in cache]
    p = rank_cut({"attn": whole}, mi, arch)["attn"]
    ops.reset_launches()
    y = gqa_decode(p, x, pos, *rank_cache, cfg, mi=mi)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    local = rank_attn(cfg, mi)
    return {"heads": (local.n_heads, local.n_kv_heads), "launches": dict(ops.LAUNCHES),
            "mesh": y.cpu(), "one": y_one.cpu(), "rank_cache": [c.cpu() for c in rank_cache],
            "one_cache": [c[:, :, mine].cpu() for c in one_cache]}
