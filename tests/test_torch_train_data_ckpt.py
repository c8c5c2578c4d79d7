"""The port's data stream and checkpoints against the reference on the CPU.

``make_batch`` is a copy of the reference's numpy code, so batches must be
equal bit for bit for any (seed, step, config, shape).  Checkpoints use the
reference's on-disk format and key paths, so a checkpoint written by either
package restores in the other, leaf for leaf (int8 ``Q8`` moments and the
int32 step included).  The durability cases mirror tests/test_checkpoint.py:
a torn ``.tmp`` directory, pruning to ``keep``, a double save, async saves and
a write error raised on ``wait()``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JaxCheckpointer
from repro.configs import get_config as jax_config
from repro.configs.base import ShapeConfig as JaxShape
from repro.data import make_batch as jax_make_batch
from repro.optim import AdamWConfig as JaxAdamW
from repro.optim import init_opt_state as jax_init_opt
from repro_torch import tree as tu
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config as port_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import DataConfig, Prefetcher, batch_to, make_batch
from repro_torch.optim import AdamWConfig, Q8, init_opt_state

SHAPE = ShapeConfig("tiny", 64, 4, "train")


@pytest.mark.parametrize("arch", ["granite-3-8b", "musicgen-large", "llama-3.2-vision-11b", "llama4-scout-17b-a16e"])
@pytest.mark.parametrize("step,seed", [(0, 1234), (7, 1234), (3, 99)])
def test_make_batch_equals_reference_bit_for_bit(arch, step, seed):
    from repro.data.pipeline import DataConfig as JaxDataConfig

    jcfg, tcfg = jax_config(arch).reduced(), port_config(arch).reduced()
    want = jax_make_batch(jcfg, JaxShape("tiny", 64, 4, "train"), step, JaxDataConfig(seed=seed), batch_override=2,
                          seq_override=40)
    got = make_batch(tcfg, SHAPE, step, DataConfig(seed=seed), batch_override=2, seq_override=40)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k


def test_batch_to_device_types():
    b = batch_to(make_batch(port_config("llama-3.2-vision-11b").reduced(), SHAPE, 0), "cpu")
    assert b["tokens"].dtype == b["labels"].dtype == torch.int64 and b["vision"].dtype == torch.float32


def test_prefetcher_resumes_in_order():
    cfg = port_config("granite-3-8b").reduced()
    pf = Prefetcher(cfg, SHAPE, start_step=5, depth=2, device="cpu", seq_override=16)
    try:
        got = [next(pf) for _ in range(4)]
    finally:
        pf.close()
    assert [s for s, _ in got] == [5, 6, 7, 8]
    for s, b in got:
        want = make_batch(cfg, SHAPE, s, seq_override=16)
        assert b["tokens"].device.type == "cpu" and np.array_equal(b["tokens"].numpy(), want["tokens"])


# --------------------------------------------------------------------------- #
# checkpoints
# --------------------------------------------------------------------------- #


def _numpy_state(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((16, 300)).astype(np.float32), "b": np.zeros((16,), np.float32),
            "layers": {"wq": rng.standard_normal((2, 8, 4)).astype(np.float32)}}


def _port_state(seed: int = 0) -> dict:
    params = tu.tree_map(torch.from_numpy, _numpy_state(seed))
    opt = init_opt_state(params, AdamWConfig(int8_states=True))
    opt["m"]["w"] = Q8(torch.arange(16 * 300, dtype=torch.int64).reshape(16, 300).remainder(255).sub(127).to(torch.int8),
                       torch.linspace(0.5, 2.0, 32).reshape(16, 2))
    opt["step"].fill_(3)
    return {"params": params, "opt": opt, "step": torch.tensor(7, dtype=torch.int32)}


def _jax_state(seed: int = 0) -> dict:
    params = jax.tree.map(jnp.asarray, _numpy_state(seed))
    opt = jax_init_opt(params, JaxAdamW(int8_states=True))
    return {"params": params, "opt": opt, "step": jnp.int32(7)}


def _like() -> dict:
    return tu.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), _port_state())


def _assert_equal(port_tree, jax_tree):
    jl = dict(tu.leaves_with_path(jax.tree.map(np.asarray, jax_tree)))
    pl = dict(tu.leaves_with_path(port_tree))
    assert set(pl) == set(jl)
    for path, t in pl.items():
        assert str(t.dtype).removeprefix("torch.") == jl[path].dtype.name, path
        assert np.array_equal(t.numpy(), jl[path]), path


def test_key_paths_are_the_reference_key_strings():
    want = [jax.tree_util.keystr(kp) for kp, _ in jax.tree_util.tree_flatten_with_path(_jax_state())[0]]
    assert [p for p, _ in tu.leaves_with_path(_port_state())] == want
    assert "['opt']['m']['layers']['wq'].codes" in want and "['step']" in want


@pytest.mark.parametrize("async_save", [False, True])
def test_port_roundtrip_exact(tmp_path, async_save):
    state = _port_state()
    ck = Checkpointer(str(tmp_path), async_save=async_save)
    ck.save(7, state, extra={"data_step": 7})
    state["params"]["w"].add_(1.0)  # the saved copy is a snapshot
    ck.wait()
    restored, extra = ck.restore(None, _like(), device="cpu")
    assert extra == {"data_step": 7} and isinstance(restored["opt"]["m"]["w"], Q8)
    want = _port_state()
    for (p, a), (_, b) in zip(tu.leaves_with_path(restored), tu.leaves_with_path(want)):
        assert a.dtype == b.dtype and torch.equal(a, b), p


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jstate = _jax_state()
    JaxCheckpointer(str(tmp_path), async_save=False).save(4, jstate, extra={"data_step": 4})
    restored, extra = Checkpointer(str(tmp_path)).restore(None, _like(), device="cpu")
    assert extra == {"data_step": 4}
    _assert_equal(restored, jstate)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    state = _port_state()
    Checkpointer(str(tmp_path), async_save=False).save(4, state, extra={"data_step": 4})
    like = jax.eval_shape(_jax_state)
    restored, extra = JaxCheckpointer(str(tmp_path)).restore(None, like)
    assert extra == {"data_step": 4}
    _assert_equal(state, restored)


def test_bf16_leaves_round_trip_through_float32(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    x = torch.linspace(-3, 3, 10).to(torch.bfloat16)
    ck.save(1, {"w": x})
    restored, _ = ck.restore(1, {"w": torch.empty(10, dtype=torch.bfloat16, device="meta")}, device="cpu")
    assert restored["w"].dtype == torch.bfloat16 and torch.equal(restored["w"], x)


def test_torn_tmp_dir_ignored(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(1, _port_state())
    os.makedirs(tmp_path / "step_0000000002.tmp")
    (tmp_path / "step_0000000002.tmp" / "leaf_00000.npy").write_bytes(b"garbage")
    assert ck.latest_step() == 1
    restored, _ = ck.restore(None, _like(), device="cpu")
    assert torch.equal(restored["params"]["w"], _port_state()["params"]["w"])
    ck.save(2, _port_state(1))  # the next save overwrites the torn directory
    assert ck.latest_step() == 2 and not (tmp_path / "step_0000000002.tmp").exists()


def test_keep_k_pruning_and_double_save(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        ck.save(s, _port_state())
    assert sorted(d for d in os.listdir(tmp_path) if d.startswith("step_")) == ["step_0000000003",
                                                                                 "step_0000000004"]
    ck.save(4, _port_state(1))  # a second save of a step is a no-op
    restored, _ = ck.restore(4, _like(), device="cpu")
    assert torch.equal(restored["params"]["w"], _port_state(0)["params"]["w"]) and ck.latest_step() == 4


def test_missing_checkpoint_and_missing_leaf_raise(tmp_path):
    ck = Checkpointer(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        ck.restore(None, _like(), device="cpu")
    ck.save(1, {"w": torch.zeros(3)})
    ck.wait()
    with pytest.raises(KeyError, match=r"\['v'\]"):
        ck.restore(1, {"v": torch.zeros(3)}, device="cpu")
    # shardings: a None leaf restores a plain tensor; a tree that does not fit like raises
    restored, _ = ck.restore(1, {"w": torch.zeros(3)}, device="cpu", shardings={"w": None})
    assert torch.equal(restored["w"], torch.zeros(3))
    with pytest.raises(ValueError, match="shardings has 2 leaves"):
        ck.restore(1, {"w": torch.zeros(3)}, device="cpu", shardings={"a": None, "b": None})


def test_async_write_error_raised_on_wait(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=True)
    (tmp_path / "step_0000000002.tmp").write_bytes(b"")  # a file where the write makes its directory
    ck.save(2, {"w": torch.zeros(3)})
    with pytest.raises(NotADirectoryError):
        ck.wait()
    ck.wait()  # raised once
    assert ck.latest_step() is None
