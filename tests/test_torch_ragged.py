"""The port's ``gmm_ragged`` (plain version on the CPU) against the JAX
``repro.kernels.ops.gmm_ragged``, whose Pallas kernel runs in interpret
mode as tests/test_kernels.py runs it: random group sizes with empty
groups, float32 and bfloat16, padding rows exactly zero."""

import numpy as np
import pytest
import torch

from _torch_port import assert_close, pin_threads, t

pin_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

# the repo's tolerances (tests/test_fused_swiglu.py:49): float32 sums in
# another order, bfloat16 rounds the output
_TOL = {np.float32: dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}


def _case(seed, sizes, bm, K, N, extra_tiles=0):
    """lhs in the bm-aligned ragged layout of ``sizes`` (plus
    ``extra_tiles`` bm tiles past the spans), rhs, and the mask of rows
    that hold a group's live row."""
    rng = np.random.default_rng(seed)
    spans = [-(-n // bm) * bm for n in sizes]
    M = sum(spans) + extra_tiles * bm
    lhs = rng.standard_normal((M, K)).astype(np.float32)
    rhs = (rng.standard_normal((len(sizes), K, N)) * K**-0.5).astype(np.float32)
    live = np.zeros(M, bool)
    start = 0
    for n, span in zip(sizes, spans):
        live[start:start + n] = True
        start += span
    return lhs, rhs, np.asarray(sizes, np.int32), live


def _random_sizes(seed, E, hi):
    """E group sizes in 0..hi, about a third of them empty."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, hi + 1, E)
    sizes[rng.random(E) < 0.35] = 0
    return sizes.tolist()


@pytest.mark.parametrize("dtype", [np.float32, "bf16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("seed,E,hi,bm", [(0, 6, 20, 8), (1, 9, 40, 16), (2, 4, 5, 8), (3, 12, 9, 24)])
def test_matches_jax_gmm_ragged(dtype, seed, E, hi, bm):
    sizes = _random_sizes(seed, E, hi)
    if sum(sizes) == 0:
        sizes[0] = 1
    lhs, rhs, gs, live = _case(seed, sizes, bm, 32, 32)
    if dtype == "bf16":
        want = jops.gmm_ragged(jnp.asarray(lhs, jnp.bfloat16), jnp.asarray(rhs, jnp.bfloat16),
                               jnp.asarray(gs), bm=bm, bk=32, bn=32, interpret=True)
        got = ops.gmm_ragged(t(lhs).bfloat16(), t(rhs).bfloat16(), t(gs), bm=bm)
        assert got.dtype == torch.bfloat16
    else:
        want = jops.gmm_ragged(jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(gs), bm=bm, bk=32,
                               bn=32, interpret=True)
        got = ops.gmm_ragged(t(lhs), t(rhs), t(gs), bm=bm)
    assert_close(got, np.asarray(want, np.float32), **_TOL[dtype])
    assert (got[torch.from_numpy(~live)] == 0).all()  # padding rows: exact zeros


@pytest.mark.parametrize(
    "sizes,bm,extra_tiles",
    [
        ([0, 0, 0], 8, 2),  # every group empty: only rows past the spans
        ([0, 17, 0, 0, 8], 8, 0),  # empty groups before, between and after
        ([24, 0, 1], 8, 3),  # whole spans, a one-row group, tiles past the spans
        ([5], 8, 0),  # bm clamped to M = 8
    ],
    ids=["all_empty", "empty_between", "past_spans", "one_group"],
)
def test_edges_match_jax(sizes, bm, extra_tiles):
    """Rows past the spans' sum belong to the clamped last group and are
    zeros, as the TPU wrapper's searchsorted leaves them."""
    lhs, rhs, gs, live = _case(7, sizes, bm, 32, 32, extra_tiles)
    want = jops.gmm_ragged(jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(gs), bm=bm, bk=32, bn=32,
                           interpret=True)
    got = ops.gmm_ragged(t(lhs), t(rhs), t(gs), bm=bm)
    assert_close(got, want)
    assert (got[torch.from_numpy(~live)] == 0).all()
    # the live rows are their group's products
    starts = np.concatenate([[0], np.cumsum([-(-n // bm) * bm for n in sizes])[:-1]]).astype(int)
    for g, (s, n) in enumerate(zip(starts, sizes)):
        assert_close(got[s:s + n], lhs[s:s + n] @ rhs[g], rtol=1e-4, atol=1e-4)


def test_layout_checks_and_cpu_counts():
    """bm must be a multiple of 8 and divide M (the JAX wrapper asserts
    the first); the plain version launches nothing."""
    lhs = torch.zeros((24, 8))
    rhs = torch.zeros((2, 8, 8))
    gs = torch.tensor([3, 9], dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.gmm_ragged(lhs, rhs, gs, bm=12)
    with pytest.raises(ValueError, match="not a multiple of bm"):
        ops.gmm_ragged(lhs, rhs, gs, bm=16)
    ops.reset_launches()
    out = ops.gmm_ragged(lhs, rhs, gs, bm=8)
    assert out.shape == (24, 8) and ops.LAUNCHES["gmm_ragged"] == 0
    assert torch.equal(ref.gmm_ragged_ref(lhs, rhs, gs, 8), out)
