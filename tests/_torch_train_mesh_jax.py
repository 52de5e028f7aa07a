"""The JAX side of ``tests/test_torch_train_mesh.py``, run as one
subprocess: ``python _torch_train_mesh_jax.py INPUTS.npz OUT.npz [CASE
...]``.  Four host devices stand in for the mesh (set before JAX is
imported, as ``tests/test_moe.py:117`` sets them).  For each proxy and
mesh it places the parameters with ``to_shardings(mesh,
param_pspecs(...))`` and runs, under ``jax.jit``, the reference's
``value_and_grad(lm.loss)`` and, for the runs of
``_torch_train_mesh_cases.STEP_RUNS``, its train step
(``make_train_step``); every result is gathered to numpy."""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_train_mesh_cases as cases  # noqa: E402
from _torch_ep_cases import flatten, unflatten  # noqa: E402
from repro.configs import get_arch  # noqa: E402
from repro.launch.mesh import make_mesh, mesh_info_for, use_mesh  # noqa: E402
from repro.models import LM  # noqa: E402
from repro.models.sharding import param_pspecs, to_shardings  # noqa: E402
from repro.train import compression, optimizer, train_loop  # noqa: E402


def _np(tree) -> dict:
    return flatten(jax.tree.map(np.asarray, tree))


def _run(case: str, shape, ep, inp: dict, out: dict) -> None:
    """One run of ``cases.runs``: the replicated-dispatch body whatever
    ``ep`` (the module docstring of ``_torch_train_mesh_cases`` says why)."""
    arch = cases.run_arch(get_arch, case, ep)
    key = cases.key(case, shape, ep)
    tree = unflatten(inp, f"{case}/params/")
    mesh = make_mesh(shape, ("data", "model"))
    mi = mesh_info_for(mesh, cases.BATCH)
    shardings = to_shardings(mesh, param_pspecs(tree, arch, "model", shape[1]))
    lm = LM(arch, dtype=jnp.float32, mesh_info=mi)

    def batch(i):
        return {k: jnp.asarray(v) for k, v in cases.batch(inp, case, i).items()}

    with use_mesh(mesh):
        placed = jax.device_put(tree, shardings)
        (loss, metrics), grads = jax.jit(jax.value_and_grad(lm.loss, has_aux=True))(placed, batch(0))
        out[f"{key}/loss"] = np.asarray(loss)
        out[f"{key}/ce"] = np.asarray(metrics["ce"])
        out[f"{key}/moe_aux"] = np.asarray(metrics["aux"].moe_aux)
        out.update({f"{key}/grad/{k}": v for k, v in _np(grads).items()})
        for run, kw in cases.step_runs(case, shape, ep):
            tc = train_loop.TrainConfig(opt=optimizer.AdamWConfig(**cases.OPT), **kw)
            p = jax.device_put(tree, shardings)
            state = optimizer.init_opt_state(p)
            res = compression.init_residual(p) if tc.grad_compression else jnp.zeros(())
            step = jax.jit(train_loop.make_train_step(lm, tc))
            for i in range(cases.STEPS):
                p, state, res, m = step(p, state, batch(i), res)
                for name in cases.METRICS:
                    out[f"{key}/{run}/{name}{i}"] = np.asarray(m[name])
            out.update({f"{key}/{run}/params/{k}": v for k, v in _np(p).items()})


def main(inputs_path: str, out_path: str, *names: str) -> None:
    inp = dict(np.load(inputs_path))
    out = {}
    for case, shape, ep in cases.runs(names or None):
        _run(case, shape, ep, inp, out)
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(*sys.argv[1:])
