"""The JAX side of ``tests/test_torch_tp.py`` and
``tests/test_torch_tp_recurrent.py``, run as one subprocess: ``python
_torch_tp_jax.py INPUTS.npz OUT.npz [CASE ...]`` (the cases of
``_torch_tp_cases.CASES`` by default).  Four host devices stand
in for the mesh (set before JAX is imported, as ``tests/test_moe.py:117``
sets them).  For each proxy and mesh it places the parameters with
``to_shardings(mesh, param_pspecs(...))``, writes each leaf's index on
each device of the mesh (checking that device's addressable shard is the
array at that index), and runs ``LM(mesh_info=...)`` under ``jax.jit`` on
the placed parameters: prefill, then greedy decode steps."""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_tp_cases as cases  # noqa: E402
from _torch_ep_cases import unflatten  # noqa: E402
from repro.configs import get_arch  # noqa: E402
from repro.launch.mesh import make_mesh, mesh_info_for, use_mesh  # noqa: E402
from repro.models import LM  # noqa: E402
from repro.models.sharding import param_pspecs, to_shardings  # noqa: E402


def _layout(placed: dict, full: dict, mesh, key: str, out: dict) -> None:
    """Each leaf's index on device r of the mesh (row-major position r in
    ``mesh.devices``), as an (ndim, 2) array of [start, stop)."""
    position = {d.id: r for r, d in enumerate(mesh.devices.flat)}
    for name, leaf in _leaves(placed):
        whole = full[name]
        for shard in leaf.addressable_shards:
            r = position[shard.device.id]
            idx = np.asarray([s.indices(n)[:2] for s, n in zip(shard.index, whole.shape)], np.int64)
            data = np.asarray(shard.data)
            if not np.array_equal(data, whole[tuple(slice(a, b) for a, b in idx)]):
                raise AssertionError(f"{name}: device {r}'s shard is not the array at its index")
            out[f"{key}/idx/{name}/{r}"] = idx


def _leaves(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _run(case: str, shape, inp: dict, out: dict) -> None:
    arch = cases.arch(get_arch, case)
    full = {k[len(f"{case}/params/"):]: v for k, v in inp.items() if k.startswith(f"{case}/params/")}
    tree = unflatten(inp, f"{case}/params/")
    mesh = make_mesh(shape, ("data", "model"))
    mi = mesh_info_for(mesh, cases.BATCH)
    placed = jax.device_put(tree, to_shardings(mesh, param_pspecs(tree, arch, "model", shape[1])))
    key = f"{case}/{shape[0]}x{shape[1]}"
    _layout(placed, full, mesh, key, out)
    lm = LM(arch, dtype=jnp.float32, mesh_info=mi)
    batch = {k: jnp.asarray(v) for k, v in cases.prompt(inp, case).items()}
    S, T = cases.PROMPT, cases.MAX_SEQ
    with use_mesh(mesh):
        logits, cache, aux = jax.jit(lm.prefill)(placed, batch)
        # gathered to the host and the K/V padded to the decode length there
        cache = {k: jax.tree.map(lambda c: np.pad(np.asarray(c), [(0, 0), (0, 0), (0, T - S)] +
                                                  [(0, 0)] * (c.ndim - 3)) if k in cases.kv_keys(arch)
                                 else np.asarray(c), v) for k, v in cache.items()}
        out[f"{key}/prefill_logits"] = np.asarray(logits)
        out[f"{key}/prefill_counts"] = np.asarray(aux.counts)
        step = jax.jit(lambda p, b, c: lm.decode_step(p, b, c))
        tok = jnp.argmax(logits[:, 0, : arch.vocab_size], axis=-1).astype(jnp.int32)
        for i in range(cases.STEPS):
            pos = jnp.full((cases.BATCH,), S + i, jnp.int32)
            logits, cache, aux = step(placed, {"tokens": tok[:, None], "position": pos}, cache)
            out[f"{key}/tokens{i}"] = np.asarray(tok)
            out[f"{key}/decode_logits{i}"] = np.asarray(logits)
            out[f"{key}/decode_counts{i}"] = np.asarray(aux.counts)
            tok = jnp.argmax(logits[:, 0, : arch.vocab_size], axis=-1).astype(jnp.int32)


def main(inputs_path: str, out_path: str, *names: str) -> None:
    inp = dict(np.load(inputs_path))
    out = {}
    for case in names or cases.CASES:
        for shape in cases.MESHES:
            _run(case, shape, inp, out)
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(*sys.argv[1:])
