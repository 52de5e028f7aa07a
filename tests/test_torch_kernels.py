"""The port's kernel wrappers and plain versions against the JAX Pallas
kernels run in interpret mode (as tests/test_kernels.py runs them).

On the CPU each wrapper runs its kernel's plain version, so these tests
hold the plain versions to the TPU kernels, edge cases included.  The
CUDA kernels themselves run only on the card (the ``cuda`` tests below,
and chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from _torch_port import assert_close, pin_threads, t

pin_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


def _weights(rng, E, K, F, N):
    return (
        (rng.standard_normal((E, K, F)) * 0.1).astype(np.float32),
        (rng.standard_normal((E, K, F)) * 0.1).astype(np.float32),
        (rng.standard_normal((E, F, N)) * 0.1).astype(np.float32),
    )


class TestSwigluGmmCapacity:
    @pytest.mark.parametrize(
        "sizes",
        [
            [12, 0, 5, 1],  # ragged groups
            [0, 0, 0, 0],  # every group dead
            [12, 12, 12, 12],  # every row live
        ],
    )
    def test_matches_pallas_interpret(self, sizes):
        E, C, K, F, N = 4, 12, 64, 64, 64
        rng = np.random.default_rng(0)
        buf = rng.standard_normal((E, C, K)).astype(np.float32)
        wg, wu, wd = _weights(rng, E, K, F, N)
        gs = np.asarray(sizes, np.int32)
        want = jops.swiglu_gmm_capacity(
            jnp.asarray(buf), jnp.asarray(wg), jnp.asarray(wu), jnp.asarray(wd),
            jnp.asarray(gs), bm=8, bk=32, bf=32, interpret=True,
        )
        got = ops.swiglu_gmm_capacity(t(buf), t(wg), t(wu), t(wd), t(gs))
        assert_close(got, want)
        dead = np.arange(C)[None, :] >= gs[:, None]
        assert (got.numpy()[dead] == 0).all()  # exact zeros past the size

    def test_rhs_of_group_matches_pallas(self):
        E, G, C, K, F, N = 3, 4, 8, 32, 32, 32
        rng = np.random.default_rng(1)
        buf = rng.standard_normal((G, C, K)).astype(np.float32)
        wg, wu, wd = _weights(rng, E, K, F, N)
        gs = np.asarray([8, 3, 0, 6], np.int32)
        rhs = np.asarray([2, 0, 1, 2], np.int32)
        want = jops.swiglu_gmm_capacity(
            jnp.asarray(buf), jnp.asarray(wg), jnp.asarray(wu), jnp.asarray(wd),
            jnp.asarray(gs), rhs_of_group=jnp.asarray(rhs), bm=8, bk=32, bf=32,
            interpret=True,
        )
        got = ops.swiglu_gmm_capacity(t(buf), t(wg), t(wu), t(wd), t(gs), t(rhs))
        assert_close(got, want)

    def test_bf16_casts_silu_product_like_the_tpu_kernel(self):
        """In bf16 the SiLU product is rounded to bf16 before the down
        product (repro/kernels/fused_swiglu.py:117); the plain version must
        match the Pallas kernel at the repo's bf16 tolerance."""
        E, C, K, F, N = 2, 8, 64, 64, 64
        rng = np.random.default_rng(2)
        buf = rng.standard_normal((E, C, K)).astype(np.float32)
        wg, wu, wd = _weights(rng, E, K, F, N)
        gs = np.asarray([8, 3], np.int32)
        bf = jnp.bfloat16
        want = jops.swiglu_gmm_capacity(
            jnp.asarray(buf, bf), jnp.asarray(wg, bf), jnp.asarray(wu, bf),
            jnp.asarray(wd, bf), jnp.asarray(gs), bm=8, bk=32, bf=32, interpret=True,
        )
        tb = torch.bfloat16
        got = ops.swiglu_gmm_capacity(
            t(buf).to(tb), t(wg).to(tb), t(wu).to(tb), t(wd).to(tb), t(gs)
        )
        assert got.dtype == tb
        # the repo's bf16 tolerance (tests/test_fused_swiglu.py:50): both sides
        # round the SiLU product to bf16 but sum in other orders first
        assert_close(got, np.asarray(want, np.float32), rtol=2e-2, atol=2e-2)


class TestSwigluGemv:
    @pytest.mark.parametrize(
        "valid", [[1, 0, 1, 1, 0, 1], [0] * 6, [1] * 6], ids=["mixed", "all_dead", "all_live"]
    )
    def test_matches_pallas_interpret(self, valid):
        E, S, K, F, N = 4, 6, 64, 64, 32
        rng = np.random.default_rng(3)
        toks = rng.standard_normal((S, K)).astype(np.float32)
        wg, wu, wd = _weights(rng, E, K, F, N)
        eids = np.asarray([3, 0, 1, 3, 2, 2], np.int32)
        v = np.asarray(valid, np.int32)
        want = jops.swiglu_gemv(
            jnp.asarray(toks), jnp.asarray(wg), jnp.asarray(wu), jnp.asarray(wd),
            jnp.asarray(eids), jnp.asarray(v), bk=32, bf=32, interpret=True,
        )
        got = ops.swiglu_gemv(t(toks), t(wg), t(wu), t(wd), t(eids), t(v))
        assert_close(got, want)
        assert (got.numpy()[v == 0] == 0).all()  # exact zeros on dead rows

    def test_valid_defaults_to_all_rows(self):
        E, S, K, F, N = 2, 3, 32, 32, 32
        rng = np.random.default_rng(4)
        toks = rng.standard_normal((S, K)).astype(np.float32)
        wg, wu, wd = _weights(rng, E, K, F, N)
        eids = np.asarray([1, 0, 1], np.int32)
        want = jops.swiglu_gemv(
            jnp.asarray(toks), jnp.asarray(wg), jnp.asarray(wu), jnp.asarray(wd),
            jnp.asarray(eids), None, bk=32, bf=32, interpret=True,
        )
        assert_close(ops.swiglu_gemv(t(toks), t(wg), t(wu), t(wd), t(eids)), want)

    def test_strided_rows(self):
        """The tail path passes ``buf[:, :1]`` rows of the capacity slab."""
        E, C, K, F, N = 3, 4, 32, 32, 32
        rng = np.random.default_rng(5)
        slab = t(rng.standard_normal((E, C, K)).astype(np.float32))
        wg, wu, wd = (t(w) for w in _weights(rng, E, K, F, N))
        eids = torch.arange(E, dtype=torch.int32)
        valid = torch.tensor([1, 0, 1], dtype=torch.int32)
        got = ops.swiglu_gemv(slab[:, :1].reshape(E, K), wg, wu, wd, eids, valid)
        want = ops.swiglu_gemv(slab[:, 0].contiguous(), wg, wu, wd, eids, valid)
        assert torch.equal(got, want)


class TestDecodeAttention:
    @pytest.mark.parametrize(
        "T,bt,lens",
        [
            (32, 8, [32, 17, 1, 9]),  # full, mid-tile, single position
            (30, 8, [30, 29, 0, 7]),  # ragged T % bt tail and a length-0 row
            (16, 16, [0, 0, 0, 0]),  # every row empty
        ],
    )
    def test_matches_pallas_interpret(self, T, bt, lens):
        B, Kv, G, dh = 4, 2, 4, 32
        rng = np.random.default_rng(6)
        q = rng.standard_normal((B, Kv * G, dh)).astype(np.float32)
        ck = rng.standard_normal((B, T, Kv, dh)).astype(np.float32)
        cv = rng.standard_normal((B, T, Kv, dh)).astype(np.float32)
        L = np.asarray(lens, np.int32)
        want = jops.decode_attention(
            jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(L),
            bt=bt, interpret=True,
        )
        got = ops.decode_attention(t(q), t(ck), t(cv), t(L))
        assert_close(got, want)
        assert (got.numpy()[L == 0] == 0).all()  # exact zeros, not a uniform mean


class TestWrapperDispatch:
    def test_launch_counters_untouched_on_cpu(self):
        ops.reset_launches()
        rng = np.random.default_rng(8)
        q = t(rng.standard_normal((1, 2, 8)).astype(np.float32))
        ck = t(rng.standard_normal((1, 4, 1, 8)).astype(np.float32))
        ops.decode_attention(q, ck, ck, torch.tensor([3], dtype=torch.int32))
        assert ops.LAUNCHES == {
            "swiglu_gmm_capacity": 0, "swiglu_gemv": 0, "decode_attention": 0,
        }

    def test_mixed_devices_raise(self):
        q = torch.zeros((1, 2, 8))
        with pytest.raises(ValueError, match="mixed or unsupported"):
            ops.decode_attention(q, torch.zeros((1, 4, 1, 8), device="meta"),
                                 torch.zeros((1, 4, 1, 8)), torch.ones(1, dtype=torch.int32))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
class TestKernelsOnCard:
    """Each CUDA kernel against its plain version on the card, at the
    proxy's widths.  bf16 tolerance 2e-2 as tests/test_fused_swiglu.py:50:
    the kernels sum in another order than the plain float32 einsums and
    round the output to bf16."""

    def test_swiglu_gmm_capacity(self, cuda):
        g = torch.Generator(device=cuda).manual_seed(0)
        E, C, K, F, N = 8, 20, 128, 64, 128
        bf = torch.bfloat16
        buf = torch.randn((E, C, K), generator=g, device=cuda).to(bf)
        wg, wu = (torch.randn((E, K, F), generator=g, device=cuda).mul(K**-0.5).to(bf) for _ in range(2))
        wd = torch.randn((E, F, N), generator=g, device=cuda).mul(F**-0.5).to(bf)
        gs = torch.tensor([20, 0, 1, 16, 17, 0, 5, 20], dtype=torch.int32, device=cuda)
        got = ops.swiglu_gmm_capacity(buf, wg, wu, wd, gs)
        want = ref.fused_swiglu_gmm_ref(buf, wg, wu, wd, gs)
        assert torch.allclose(got.float(), want.float(), rtol=2e-2, atol=2e-2)

    def test_swiglu_gemv(self, cuda):
        g = torch.Generator(device=cuda).manual_seed(1)
        E, K, F, N = 8, 128, 64, 128
        bf = torch.bfloat16
        toks = torch.randn((E, K), generator=g, device=cuda).to(bf)
        wg, wu = (torch.randn((E, K, F), generator=g, device=cuda).mul(K**-0.5).to(bf) for _ in range(2))
        wd = torch.randn((E, F, N), generator=g, device=cuda).mul(F**-0.5).to(bf)
        eids = torch.arange(E, dtype=torch.int32, device=cuda)
        valid = torch.tensor([1, 0, 1, 1, 0, 0, 1, 1], dtype=torch.int32, device=cuda)
        got = ops.swiglu_gemv(toks, wg, wu, wd, eids, valid)
        want = ref.fused_swiglu_gemv_ref(toks, wg, wu, wd, eids, valid)
        assert torch.allclose(got.float(), want.float(), rtol=2e-2, atol=2e-2)

    def test_decode_attention(self, cuda):
        g = torch.Generator(device=cuda).manual_seed(2)
        B, T, Kv, G, dh = 4, 100, 2, 8, 128
        bf = torch.bfloat16
        q = torch.randn((B, Kv * G, dh), generator=g, device=cuda).to(bf)
        ck, cv = (torch.randn((B, T, Kv, dh), generator=g, device=cuda).to(bf) for _ in range(2))
        L = torch.tensor([100, 0, 65, 1], dtype=torch.int32, device=cuda)
        got = ops.decode_attention(q, ck, cv, L)
        want = ref.decode_attention_ref(q, ck, cv, L)
        assert torch.allclose(got.float(), want.float(), rtol=2e-2, atol=2e-2)
        assert (got[1] == 0).all()
