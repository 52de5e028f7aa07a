"""The port's side of ``tests/test_torch_ep.py``: the function each of four
gloo ranks runs (``repro_torch.launch.mesh.run_on_mesh``).  It imports no
JAX, so the ranks start quickly; the test holds what they return against
the JAX subprocess's results."""

from __future__ import annotations

import os

import numpy as np
import torch

import _torch_ep_cases as cases
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_arch
from repro_torch.configs.base import AttnConfig
from repro_torch.launch.mesh import make_mesh, mesh_info_for
from repro_torch.models import LM
from repro_torch.models.attention import gqa_decode_seqpar
from repro_torch.models import moe
from repro_torch.models.moe import moe_block
from repro_torch.models.sharding import batch_rows, rank_cut, seq_positions


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


_BODIES = {name: getattr(moe, name) for name in ("_ep_body", "_ep_a2a_body")}


def _count_bodies(calls: dict) -> None:
    """From here on, count the calls of the two EP bodies into ``calls``."""
    for name, fn in _BODIES.items():
        def counted(*args, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args, **kw)
        setattr(moe, name, counted)


def _moe(inp: dict, mesh) -> dict:
    B, S = cases.MOE_BATCH
    mi = mesh_info_for(mesh, B)
    p = rank_cut({"moe": {k: _t(v) for k, v in cases.unflatten(inp, "moe/").items() if k != "x"}},
                 mi)["moe"]
    x = _t(inp["moe/x"])[batch_rows(B, mi)]
    out = {}
    for ep in cases.EP_MODES:
        os.environ["REPRO_EP_MODE"] = ep
        for mode in cases.EXEC_MODES:
            calls = {}
            _count_bodies(calls)
            o = moe_block(p, x, cases.moe_arch(get_arch, mode), mi)
            out[f"moe/{ep}/{mode}/bodies"] = dict(calls)
            for name, v in zip(("y", "aux", "counts", "dropped"), o):
                out[f"moe/{ep}/{mode}/{name}"] = v.numpy()
    os.environ["REPRO_EP_MODE"] = "psum"
    return out


def _seqpar(inp: dict, mi) -> dict:
    cfg = cases.attn_cfg(AttnConfig)
    sp = {k: _t(inp[f"sp/{k}"]) for k in ("wq", "wk", "wv", "wo")}
    pos = seq_positions(cases.SEQPAR["T"], mi)
    x, position = _t(inp["sp/x"]), _t(inp["sp/pos"])
    ck, cv = (_t(inp[f"sp/{k}"])[:, pos].clone() for k in ("ck", "cv"))
    out = {"sp/y": gqa_decode_seqpar(sp, x, position, ck, cv, cfg, mi).numpy(),
           "sp/ck": ck.numpy(), "sp/cv": cv.numpy()}
    c8 = [_t(inp[f"sp/{k}"])[:, pos].clone() for k in ("ck8", "cv8", "ks", "vs")]
    out["sp/y8"] = gqa_decode_seqpar(sp, x, position, c8[0], c8[1], cfg, mi,
                                     kv_scales=(c8[2], c8[3])).numpy()
    out.update({f"sp/{k}": v.numpy() for k, v in zip(("ck8", "cv8", "ks", "vs"), c8)})
    # INT8_STEPS steps from empty caches, int8 against float32
    B, T, K, dh = cases.SEQPAR["B"], pos.stop - pos.start, cfg.n_kv_heads, cfg.d_head
    f32 = [torch.zeros((B, T, K, dh)) for _ in range(2)]
    i8 = [torch.zeros((B, T, K, dh), dtype=torch.int8) for _ in range(2)] + \
        [torch.zeros((B, T, K)) for _ in range(2)]
    for i, xt in enumerate(_t(inp["sp/x_steps"])):
        post = torch.full((B,), i, dtype=torch.int32)
        y_f = gqa_decode_seqpar(sp, xt, post, f32[0], f32[1], cfg, mi)
        y_q = gqa_decode_seqpar(sp, xt, post, i8[0], i8[1], cfg, mi, kv_scales=(i8[2], i8[3]))
    out["sp/int8_rel"] = float((y_f - y_q).abs().max() / (y_f.abs().max() + 1e-9))
    return out


def _lm(inp: dict, mesh, ep: str) -> dict:
    os.environ["REPRO_EP_MODE"] = ep
    arch = cases.lm_arch(get_arch)
    mi = mesh_info_for(mesh, cases.LM_BATCH)
    lm = LM(arch, dtype=torch.float32, device="cpu", mesh_info=mi)
    params = params_from_numpy(cases.unflatten(inp, "lm/params/"), "cpu", torch.float32, mi, arch)
    calls = {}
    _count_bodies(calls)
    logits, cache, aux = lm.prefill(params, {"tokens": _t(inp["lm/tokens"])},
                                    max_seq=cases.LM_MAX_SEQ)
    out = {"prefill_logits": logits.numpy(), "prefill_counts": aux.counts.numpy(),
           "cache_shape": tuple(cache["blocks"][0].shape), "seq_par": lm._seq_par()}
    tok = torch.argmax(logits[:, 0, : arch.vocab_size], dim=-1).to(torch.int32)
    for i in range(cases.LM_STEPS):
        pos = torch.full((cases.LM_BATCH,), cases.LM_PROMPT + i, dtype=torch.int32)
        logits, cache, aux = lm.decode_step(params, {"tokens": tok[:, None], "position": pos}, cache)
        out[f"tokens{i}"] = tok.numpy()
        out[f"decode_logits{i}"] = logits.numpy()
        out[f"decode_counts{i}"] = aux.counts.numpy()
        tok = torch.argmax(logits[:, 0, : arch.vocab_size], dim=-1).to(torch.int32)
    out["bodies"] = dict(calls)
    os.environ["REPRO_EP_MODE"] = "psum"
    return out


def _lm_int8(inp: dict, mi) -> list:
    """Decode steps from an empty float32 cache, then the same tokens from
    an empty int8 cache (``REPRO_KV_INT8=1``): per step, the largest
    difference of the logits relative to the largest float32 logit, and
    whether the two runs routed alike (equal per-layer counts)."""
    arch = cases.lm_arch(get_arch)
    lm = LM(arch, dtype=torch.float32, device="cpu", mesh_info=mi)
    params = params_from_numpy(cases.unflatten(inp, "lm/params/"), "cpu", torch.float32, mi, arch)
    tokens = _t(inp["lm/tokens"])
    runs = []
    for int8 in ("0", "1"):
        os.environ["REPRO_KV_INT8"] = int8
        cache = lm.init_cache(cases.LM_BATCH, cases.LM_MAX_SEQ)
        assert (cache["blocks"][0].dtype == torch.int8) == (int8 == "1")
        steps = []
        for i in range(cases.INT8_STEPS):
            pos = torch.full((cases.LM_BATCH,), i, dtype=torch.int32)
            out, cache, aux = lm.decode_step(params, {"tokens": tokens[:, i:i + 1], "position": pos},
                                             cache)
            steps.append((out[..., : arch.vocab_size], aux.counts))
        runs.append(steps)
    os.environ["REPRO_KV_INT8"] = "0"
    return [(float((lf - lq).abs().max() / (lf.abs().max() + 1e-9)), bool(torch.equal(cf, cq)))
            for (lf, cf), (lq, cq) in zip(*runs)]


def rank_main(mesh22, inputs_path: str) -> dict:
    """Everything the four ranks run; ``mesh22`` is the (2, 2) mesh of
    ``run_on_mesh``, and the (1, 4) mesh is built on the same ranks."""
    torch.set_num_threads(1)
    inp = dict(np.load(inputs_path))
    mesh14 = make_mesh((1, 4), ("data", "model"), backend=mesh22.backend, device=mesh22.device)
    out = {"rank": mesh22.rank, "coords22": mesh22.coords, "coords14": mesh14.coords}
    out.update(_moe(inp, mesh22))
    mi14 = mesh_info_for(mesh14, cases.SEQPAR["B"])
    out.update(_seqpar(inp, mi14))
    for shape, ep in cases.LM_RUNS:
        out[f"lm{shape}{ep}"] = _lm(inp, mesh14 if shape == (1, 4) else mesh22, ep)
    out["lm_int8"] = _lm_int8(inp, mi14)
    return out


def cuda_rank_main(mesh, fused: str) -> dict:
    """One of four ranks sharing one card on gloo: ``moe_block``'s two EP
    bodies at proxy size in bfloat16, on the card (the kernels) and on the
    CPU (their plain versions) with the same mesh, ``REPRO_FUSED_SWIGLU``
    set to ``fused``.  Returns both outputs and the card run's launches."""
    from repro_torch.kernels import ops

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ["REPRO_FUSED_SWIGLU"] = fused
    arch = cases.moe_arch(get_arch, "dual_path_cost")
    inp = cases.make_inputs(arch.d_model, arch.moe.d_expert, arch.moe.n_experts)
    B = cases.MOE_BATCH[0]
    mi = mesh_info_for(mesh, B)
    p = rank_cut({"moe": {k: _t(v) for k, v in cases.unflatten(inp, "moe/").items() if k != "x"}},
                 mi)["moe"]
    p = {k: v if k == "w_router" else v.to(torch.bfloat16) for k, v in p.items()}
    x = _t(inp["moe/x"])[batch_rows(B, mi)].to(torch.bfloat16)
    out = {}
    for ep in cases.EP_MODES:
        os.environ["REPRO_EP_MODE"] = ep
        ops.reset_launches()
        card = moe_block({k: v.to(mesh.device) for k, v in p.items()}, x.to(mesh.device), arch, mi)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        cpu = moe_block(p, x, arch, mi)
        out[ep] = {"card": [v.cpu() for v in card], "cpu": list(cpu), "launches": launches}
    os.environ["REPRO_EP_MODE"] = "psum"
    return out
