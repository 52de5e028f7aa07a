"""The port's data pipeline, checkpoints, fault-tolerant driver and
training launcher on the CPU: the synthetic batches against the JAX
package's, and the cases of ``tests/test_checkpoint.py`` on the port's
trees (nested dicts and lists of float32, bfloat16 and int32 tensors,
and the optimizer state)."""

import os
import warnings

import numpy as np
import pytest
import torch

from _torch_port import pin_threads

pin_threads()
jax = pytest.importorskip("jax")

from repro.data import DataConfig as JDataConfig, SyntheticLM as JSyntheticLM  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import DataConfig, Prefetcher, SyntheticLM, to_device  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.train import (  # noqa: E402
    DriverConfig,
    FaultTolerantDriver,
    StragglerMonitor,
    TrainConfig,
    TrainingAborted,
    elastic_plan,
    init_train_state,
    latest_step,
    restore_checkpoint,
    restore_latest,
    save_checkpoint,
    wait_for_async_saves,
)
from repro_torch.train import tree as tr  # noqa: E402
from repro_torch.train.checkpoint import step_dir  # noqa: E402
from repro_torch.train.optimizer import init_opt_state  # noqa: E402


def cfg(**kw):
    base = dict(vocab_size=1000, seq_len=64, global_batch=8, seed=3)
    base.update(kw)
    return base


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shard_id,n_shards", [(0, 1), (0, 2), (1, 2), (3, 4)])
def test_batches_equal_the_reference(shard_id, n_shards):
    got = SyntheticLM(DataConfig(**cfg()), shard_id, n_shards)
    want = JSyntheticLM(JDataConfig(**cfg()), shard_id, n_shards)
    for step in (0, 1, 7):
        b, w = got.batch(step), want.batch(step)
        assert b["tokens"].shape == (8 // n_shards, 64)
        np.testing.assert_array_equal(b["tokens"], w["tokens"])
        np.testing.assert_array_equal(b["labels"], w["labels"])
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_packing_where_the_reference_fails():
    """With fewer than 8 tokens of room left the reference asks for an
    8-token document and fails (``repro/data/pipeline.py:79``, step 12 of
    examples/train_moe.py's data); the port cuts the document to the room
    left, and gives the reference's batch at every other step."""
    kw = dict(vocab_size=8192, seq_len=256, global_batch=8)
    got, want = SyntheticLM(DataConfig(**kw)), JSyntheticLM(JDataConfig(**kw))
    with pytest.raises(ValueError):
        want.batch(12)
    b = got.batch(12)
    assert b["tokens"].shape == (8, 256) and b["tokens"].max() < 8192
    np.testing.assert_array_equal(got.batch(11)["tokens"], want.batch(11)["tokens"])
    np.testing.assert_array_equal(got.batch(13)["tokens"], want.batch(13)["tokens"])


def test_host_shards_are_distinct_and_sized():
    s0 = SyntheticLM(DataConfig(**cfg()), shard_id=0, n_shards=2)
    s1 = SyntheticLM(DataConfig(**cfg()), shard_id=1, n_shards=2)
    assert s0.batch(0)["tokens"].shape[0] == s1.batch(0)["tokens"].shape[0] == 4
    assert not np.array_equal(s0.batch(0)["tokens"], s1.batch(0)["tokens"])
    with pytest.raises(ValueError):
        SyntheticLM(DataConfig(**cfg()), n_shards=3)


def test_prefetcher_keeps_order_and_moves_to_the_device():
    d = SyntheticLM(DataConfig(**cfg()))
    pf = Prefetcher(iter(d), put_fn=lambda b: to_device(b, "cpu"), depth=2)
    try:
        for i in range(4):
            got = next(pf)
            assert got["tokens"].dtype == torch.int32 and got["tokens"].device.type == "cpu"
            np.testing.assert_array_equal(got["tokens"].numpy(), d.batch(i)["tokens"])
    finally:
        pf.close()


def test_prefetcher_raises_the_source_failure():
    def source():
        yield {"tokens": np.zeros((1, 2), np.int32)}
        raise RuntimeError("disk gone")

    pf = Prefetcher(source())
    next(pf)
    with pytest.raises(RuntimeError, match="disk gone"):
        next(pf)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def tree():
    g = torch.Generator().manual_seed(0)
    return {
        "a": torch.arange(12.0).reshape(3, 4),
        "b": {"c": torch.ones((5,), dtype=torch.int32),
              "d": torch.randn((2, 2), generator=g).to(torch.bfloat16)},
        "blocks": [{"w": torch.randn((3,), generator=g)}, {"w": torch.randn((3,), generator=g)}],
    }


def _equal(a, b):
    la, lb = tr.leaves(a), tr.leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


class TestCheckpoint:
    def test_roundtrip_bitexact(self, tmp_path):
        t = tree()
        save_checkpoint(str(tmp_path), 3, t)
        assert _equal(restore_checkpoint(str(tmp_path), 3, t), t)
        # onto a given device, from a tree of shapes on the meta device
        like = tr.tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"), t)
        r = restore_checkpoint(str(tmp_path), 3, like, device="cpu")
        assert _equal(r, t)

    def test_optimizer_state_and_requires_grad_survive(self, tmp_path):
        params = tr.tree_map(lambda x: x.float().requires_grad_(True), {"w": torch.ones(3), "norm": torch.ones(2)})
        state = {"params": params, "opt": init_opt_state(params, "bfloat16")}
        save_checkpoint(str(tmp_path), 4, state)
        r = restore_checkpoint(str(tmp_path), 4, state)
        assert type(r["opt"]).__name__ == "OptState" and r["opt"].m["w"].dtype == torch.bfloat16
        assert all(p.requires_grad and p.is_leaf for p in tr.leaves(r["params"]))
        assert not r["opt"].step.requires_grad

    def test_latest_step_ignores_uncommitted(self, tmp_path):
        t = tree()
        save_checkpoint(str(tmp_path), 1, t)
        save_checkpoint(str(tmp_path), 2, t, _fault_injection=1)  # a crash mid-write
        assert latest_step(str(tmp_path)) == 1
        with pytest.raises(FileNotFoundError):
            restore_checkpoint(str(tmp_path), 2, t)

    def test_integrity_verification(self, tmp_path):
        t = tree()
        d = save_checkpoint(str(tmp_path), 5, t)
        leaf = os.path.join(d, "leaf_00000.npy")
        arr = np.load(leaf)
        arr.ravel()[0] += 1
        np.save(leaf, arr)
        with pytest.raises(IOError):
            restore_checkpoint(str(tmp_path), 5, t)

    def test_corrupt_newest_falls_back_to_the_previous_step(self, tmp_path):
        t = tree()
        save_checkpoint(str(tmp_path), 10, t)
        newer = tr.tree_map(lambda x: x + 1, t)
        d = save_checkpoint(str(tmp_path), 20, newer)
        arr = np.load(os.path.join(d, "leaf_00001.npy"))
        np.save(os.path.join(d, "leaf_00001.npy"), arr[:-1])  # truncated
        with pytest.warns(UserWarning, match="falling back"):
            step, r = restore_latest(str(tmp_path), t)
        assert step == 10 and _equal(r, t)
        os.remove(os.path.join(step_dir(str(tmp_path), 10), "leaf_00000.npy"))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert restore_latest(str(tmp_path), t) is None

    def test_async_save_copies_before_returning(self, tmp_path):
        t = tree()
        want = tr.tree_map(lambda x: x.clone(), t)
        save_checkpoint(str(tmp_path), 7, t, async_write=True)
        t["a"].add_(100)  # the train step updates in place right after
        wait_for_async_saves()
        assert latest_step(str(tmp_path)) == 7
        assert _equal(restore_checkpoint(str(tmp_path), 7, t), want)

    def test_shape_mismatch_rejected(self, tmp_path):
        save_checkpoint(str(tmp_path), 1, {"a": torch.ones((3,))})
        with pytest.raises(ValueError):
            restore_checkpoint(str(tmp_path), 1, {"a": torch.ones((4,))})
        with pytest.raises(ValueError):
            restore_checkpoint(str(tmp_path), 1, {"b": torch.ones((3,))})


# ---------------------------------------------------------------------------
# driver, straggler monitor, elastic plan
# ---------------------------------------------------------------------------


class TestFaultTolerantDriver:
    @staticmethod
    def _step_fn(state, step):
        return {"x": state["x"] + 1}, {"loss": float(step)}

    def test_restart_from_latest(self, tmp_path):
        drv = FaultTolerantDriver(self._step_fn, DriverConfig(ckpt_dir=str(tmp_path), ckpt_every=2,
                                                              max_restarts=3))
        state, hist = drv.run({"x": torch.zeros(())}, 10, inject_failure_at={5: RuntimeError("node failure")})
        assert float(state["x"]) == 10.0
        assert drv.restarts == 1
        assert [h["step"] for h in hist if h.get("event") == "restart"] == [4]
        assert latest_step(str(tmp_path)) == 10

    def test_bounded_restarts(self, tmp_path):
        def bad_step(state, step):
            raise RuntimeError("always fails")

        drv = FaultTolerantDriver(bad_step, DriverConfig(ckpt_dir=str(tmp_path), ckpt_every=100,
                                                         max_restarts=1))
        with pytest.raises(TrainingAborted):
            drv.run({"x": torch.zeros(())}, 5)

    def test_async_checkpoints_restart_from_the_newest(self, tmp_path):
        """With asynchronous saves the restore waits for the save in flight
        and resumes from it, not from the step before."""
        drv = FaultTolerantDriver(self._step_fn, DriverConfig(ckpt_dir=str(tmp_path), ckpt_every=2,
                                                              async_ckpt=True))
        state, hist = drv.run({"x": torch.zeros(())}, 8, inject_failure_at={5: RuntimeError("lost host")})
        assert float(state["x"]) == 8.0 and drv.restarts == 1
        assert [h["step"] for h in hist if h.get("event") == "restart"] == [4]
        assert latest_step(str(tmp_path)) == 8

    def test_in_place_step_restarts_from_the_true_initial_state(self, tmp_path):
        """A step function that updates the state in place (as the port's
        train step does) and fails before the first periodic checkpoint
        restarts from the initial state, not from its own partial work."""
        def step_fn(state, step):
            state["x"].add_(1)
            return state, {}

        drv = FaultTolerantDriver(step_fn, DriverConfig(ckpt_dir=str(tmp_path), ckpt_every=100))
        state, _ = drv.run({"x": torch.zeros(())}, 6, inject_failure_at={3: RuntimeError("preempted")})
        assert drv.restarts == 1 and float(state["x"]) == 6.0


def test_straggler_monitor_detects_spikes():
    mon = StragglerMonitor(alpha=0.5, threshold=2.0, warmup=2)
    assert not any(mon.observe(i, 0.1) for i in range(5))
    assert mon.observe(5, 0.5)
    assert not mon.observe(6, 0.1)  # the spike did not pollute the EMA


def test_elastic_plan_shapes():
    assert elastic_plan(512, model_parallel=16, prefer_pods=2)["mesh_shape"] == (2, 16, 16)
    assert elastic_plan(256, model_parallel=16)["mesh_shape"] == (16, 16)
    assert elastic_plan(240, model_parallel=16)["mesh_shape"] == (15, 16)
    with pytest.raises(ValueError):
        elastic_plan(250, model_parallel=16)


# ---------------------------------------------------------------------------
# the launcher and the train state
# ---------------------------------------------------------------------------


def test_launch_train_on_the_cpu(tmp_path, capsys):
    """Three steps of a reduced MoE arch through the launcher on the CPU,
    with microbatches, compression and a checkpoint; a second run resumes
    from the last checkpoint and runs no step."""
    argv = ["--arch", "qwen3-moe-30b-a3b", "--device", "cpu", "--steps", "3", "--seq-len", "16",
            "--global-batch", "4", "--microbatches", "2", "--grad-compression", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "2", "--log-every", "1"]
    hist = launch_train.main(argv)
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist)
    assert latest_step(str(tmp_path)) == 3
    out = capsys.readouterr().out
    assert "device=cpu" in out and "done: 3 steps" in out and "restarts=0" in out
    assert launch_train.main(argv) == []


def test_train_state_defaults_to_the_card():
    lm_cpu = LM(get_arch("qwen1.5-0.5b").reduced(), dtype=torch.float32, device="cpu")
    params, opt, res = init_train_state(lm_cpu, 0, TrainConfig())
    assert all(p.requires_grad and p.is_leaf for p in tr.leaves(params))
    assert opt.m["embed"].dtype == torch.float32 and res.shape == ()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LM(get_arch("qwen1.5-0.5b").reduced())
