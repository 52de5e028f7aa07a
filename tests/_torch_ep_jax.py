"""The JAX side of ``tests/test_torch_ep.py``, run as one subprocess:
``python _torch_ep_jax.py INPUTS.npz OUT.npz``.  Four host devices stand
in for the mesh (set before JAX is imported, as ``tests/test_moe.py:117``
sets them); every result goes to ``OUT.npz``."""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_ep_cases as cases  # noqa: E402
from repro.configs import get_arch  # noqa: E402
from repro.configs.base import AttnConfig  # noqa: E402
from repro.launch.mesh import make_mesh, use_mesh  # noqa: E402
from repro.models import LM  # noqa: E402
from repro.models.attention import gqa_decode_seqpar  # noqa: E402
from repro.models.moe import MeshInfo, moe_block  # noqa: E402


def main(inputs_path: str, out_path: str) -> None:
    inp = dict(np.load(inputs_path))
    out = {}
    mesh22 = make_mesh((2, 2), ("data", "model"))
    mi22 = MeshInfo(mesh=mesh22, data_axes=("data",), model_axis="model")
    mesh14 = make_mesh((1, 4), ("data", "model"))
    mi14 = MeshInfo(mesh=mesh14, data_axes=("data",), model_axis="model")

    # moe_block on the (2, 2) mesh, each executor and each EP body
    p = {k: jnp.asarray(v) for k, v in cases.unflatten(inp, "moe/").items() if k != "x"}
    x = jnp.asarray(inp["moe/x"])
    for ep in cases.EP_MODES:
        os.environ["REPRO_EP_MODE"] = ep
        for mode in cases.EXEC_MODES:
            arch = cases.moe_arch(get_arch, mode)
            with use_mesh(mesh22):
                o = jax.jit(lambda p, x: moe_block(p, x, arch, mi22))(p, x)
            for name, v in zip(("y", "aux", "counts", "dropped"), o):
                out[f"moe/{ep}/{mode}/{name}"] = np.asarray(v)
    os.environ["REPRO_EP_MODE"] = "psum"

    # sequence-parallel decode attention on (1, 4), float32 and int8
    cfg = cases.attn_cfg(AttnConfig)
    sp = {k: jnp.asarray(inp[f"sp/{k}"]) for k in ("wq", "wk", "wv", "wo")}
    args = [jnp.asarray(inp[f"sp/{k}"]) for k in ("x", "pos", "ck", "cv")]
    with use_mesh(mesh14):
        y, (ck, cv) = jax.jit(lambda *a: gqa_decode_seqpar(sp, *a, cfg, mi14))(*args)
        out.update({"sp/y": np.asarray(y), "sp/ck": np.asarray(ck), "sp/cv": np.asarray(cv)})
        a8 = [args[0], args[1], jnp.asarray(inp["sp/ck8"]), jnp.asarray(inp["sp/cv8"])]
        sc = (jnp.asarray(inp["sp/ks"]), jnp.asarray(inp["sp/vs"]))
        y8, (ck8, cv8, ks, vs) = jax.jit(
            lambda a, b, c, d, e, f: gqa_decode_seqpar(sp, a, b, c, d, cfg, mi14, kv_scales=(e, f))
        )(*a8, *sc)
    for name, v in (("y8", y8), ("ck8", ck8), ("cv8", cv8), ("ks", ks), ("vs", vs)):
        out[f"sp/{name}"] = np.asarray(v)

    # the whole slice on one device: prefill, then greedy decode steps
    arch = cases.lm_arch(get_arch)
    lm = LM(arch, dtype=jnp.float32)
    params = jax.tree.map(jnp.asarray, cases.unflatten(inp, "lm/params/"))
    toks = jnp.asarray(inp["lm/tokens"])
    logits, cache, aux = jax.jit(lambda p, t: lm.prefill(p, {"tokens": t}))(params, toks)
    S, T = cases.LM_PROMPT, cases.LM_MAX_SEQ
    cache = {k: tuple(jnp.pad(c, ((0, 0), (0, 0), (0, T - S), (0, 0), (0, 0))) for c in v)
             for k, v in cache.items()}
    out["lm/prefill_logits"] = np.asarray(logits)
    out["lm/prefill_counts"] = np.asarray(aux.counts)
    step = jax.jit(lambda p, b, c: lm.decode_step(p, b, c))
    tok = jnp.argmax(logits[:, 0, : arch.vocab_size], axis=-1).astype(jnp.int32)
    for i in range(cases.LM_STEPS):
        pos = jnp.full((cases.LM_BATCH,), S + i, jnp.int32)
        logits, cache, aux = step(params, {"tokens": tok[:, None], "position": pos}, cache)
        out[f"lm/tokens{i}"] = np.asarray(tok)
        out[f"lm/decode_logits{i}"] = np.asarray(logits)
        out[f"lm/decode_counts{i}"] = np.asarray(aux.counts)
        tok = jnp.argmax(logits[:, 0, : arch.vocab_size], axis=-1).astype(jnp.int32)
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
