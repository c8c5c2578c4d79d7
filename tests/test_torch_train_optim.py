"""The port's optimizer against the reference on the CPU: AdamW with fp32
and int8 (``Q8``) moment states, the schedules, ``global_norm``, the int8
block quantizer and error-feedback gradient compression.

Both packages get identical params, grads and state.  Tolerances: fp32
params and moments within rtol 1e-6 (the first moment changes sign between
steps, so an entry near 0 is held within 1e-6 of its leaf's largest entry:
XLA contracts ``b1*m + (1-b1)*g`` into an FMA, torch does not); ``Q8`` scales within rtol 1e-6 and
codes off by at most 1 in at most 0.1% of entries (a float32 rounding at a
code boundary); schedules, norms and dequantized values within rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jax_adamw
from repro.optim import grad_compress as jax_gc
from repro.optim import schedule as jax_sched
from repro_torch import tree as tu
from repro_torch.optim import adamw as port_adamw
from repro_torch.optim import grad_compress as port_gc
from repro_torch.optim import schedule as port_sched

# shapes: a matrix whose last axis is not a multiple of 256, a stacked leaf,
# a vector and a scalar
SHAPES = {"w": (7, 300), "layers": {"wq": (2, 16, 512), "ln": (2, 40)}, "b": (5,), "s": ()}


def _tree(seed: int, scale: float = 1.0) -> dict:
    rng = np.random.default_rng(seed)

    def draw(s):
        return (scale * rng.standard_normal(s)).astype(np.float32)

    return {"w": draw(SHAPES["w"]), "layers": {k: draw(s) for k, s in SHAPES["layers"].items()},
            "b": draw(SHAPES["b"]), "s": draw(SHAPES["s"])}


def _t(tree):
    return tu.tree_map(lambda x: torch.from_numpy(np.array(x, copy=True)), tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _codes_close(got: np.ndarray, want: np.ndarray, what: str):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max(initial=0) <= 1, (what, diff.max())
    assert np.count_nonzero(diff) <= 1e-3 * max(diff.size, 1), (what, np.count_nonzero(diff), diff.size)


def _state_close(port_state, jax_state, int8: bool):
    pm = dict(tu.leaves_with_path(port_state, port_adamw.is_q8))
    jm = dict(tu.leaves_with_path(jax.tree.map(np.asarray, jax_state), lambda x: isinstance(x, jax_adamw.Q8)))
    assert set(pm) == set(jm)
    for path, got in pm.items():
        want = jm[path]
        if int8 and isinstance(got, port_adamw.Q8):
            _codes_close(got.codes.numpy(), np.asarray(want.codes), path)
            np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale), rtol=1e-6, atol=1e-30, err_msg=path)
        else:
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * float(np.max(np.abs(want))),
                                       err_msg=path)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("schedule", [None, "warmup_cosine"])
def test_adamw_steps_match_reference(int8, schedule):
    """Three steps from one state; the second grads are large enough to
    clip.  The port updates params and state in place."""
    kw = dict(lr=1e-2, int8_states=int8)
    jcfg = jax_adamw.AdamWConfig(schedule=jax_sched.warmup_cosine(2, 10) if schedule else None, **kw)
    tcfg = port_adamw.AdamWConfig(schedule=port_sched.warmup_cosine(2, 10) if schedule else None, **kw)
    params = _tree(0)
    jp, tp = _j(params), _t(params)
    js, ts = jax_adamw.init_opt_state(jp, jcfg), port_adamw.init_opt_state(tp, tcfg)
    for step, scale in enumerate((0.01, 3.0, 0.1)):
        grads = _tree(10 + step, scale)
        jp, js, jmet = jax_adamw.adamw_update(jp, _j(grads), js, jcfg)
        before = [id(x) for x in tu.leaves(tp)]
        tp2, ts2, tmet = port_adamw.adamw_update(tp, _t(grads), ts, tcfg)
        assert tp2 is tp and ts2 is ts and [id(x) for x in tu.leaves(tp)] == before  # in place
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]), rtol=1e-6)
        for path, got in tu.leaves_with_path(tp):
            want = dict(tu.leaves_with_path(jax.tree.map(np.asarray, jp)))[path]
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7, err_msg=f"step {step} {path}")
        _state_close({"m": ts["m"], "v": ts["v"]}, {"m": js["m"], "v": js["v"]}, int8)
        assert int(ts["step"]) == int(js["step"]) == step + 1 and ts["step"].dtype == torch.int32


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_adamw_updates_strided_leaves_in_place(int8):
    """Leaves that are transposed views (params, grads and moments) update in
    place through the view, to the same values as contiguous leaves."""
    cfg = port_adamw.AdamWConfig(int8_states=int8)
    params, grads = _tree(1), _tree(2)
    flat = _t(params)
    st = port_adamw.init_opt_state(flat, cfg)
    for _ in range(2):
        port_adamw.adamw_update(flat, _t(grads), st, cfg)
    base = {"w": torch.from_numpy(np.ascontiguousarray(params["w"].T))}
    strided = {"w": base["w"].T}
    sst = port_adamw.init_opt_state(strided, cfg)
    if not int8:  # the moments as views too
        sst["m"]["w"], sst["v"]["w"] = (torch.zeros(base["w"].shape).T for _ in range(2))
    for _ in range(2):
        port_adamw.adamw_update(strided, {"w": torch.from_numpy(np.ascontiguousarray(grads["w"].T)).T}, sst, cfg)
    assert not strided["w"].is_contiguous()
    # the whole tree's clip differs from this one leaf's, so compare with a
    # one-leaf run of contiguous tensors
    one = {"w": torch.from_numpy(np.array(params["w"], copy=True))}
    ost = port_adamw.init_opt_state(one, cfg)
    for _ in range(2):
        port_adamw.adamw_update(one, {"w": torch.from_numpy(np.array(grads["w"], copy=True))}, ost, cfg)
    assert torch.equal(strided["w"], one["w"]) and torch.equal(base["w"].T, one["w"])
    for a, b in zip(tu.leaves({"m": sst["m"], "v": sst["v"]}), tu.leaves({"m": ost["m"], "v": ost["v"]})):
        assert torch.equal(a, b)


def test_init_opt_state_shapes():
    tp = _t(_tree(0))
    st = port_adamw.init_opt_state(tp, port_adamw.AdamWConfig(int8_states=True))
    for path, q in tu.leaves_with_path(st["m"], port_adamw.is_q8):
        p = dict(tu.leaves_with_path(tp))[path]
        assert q.codes.dtype == torch.int8 and q.shape == p.shape
        assert tuple(q.scale.shape) == port_adamw.q8_scale_shape(tuple(p.shape)) == \
            jax_adamw.q8_scale_shape(tuple(p.shape))


@pytest.mark.parametrize("nonlinear", [False, True])
@pytest.mark.parametrize("shape", [(3, 300), (2, 5, 256), (7,), ()])
def test_q8_roundtrip_matches_reference(shape, nonlinear):
    mag = np.logspace(-4, 1, max(1, int(np.prod(shape)))).reshape(shape)
    x = np.asarray(np.random.default_rng(len(shape)).standard_normal(shape) * mag, np.float32)
    jq = jax_adamw.q8_quantize(jnp.asarray(x), nonlinear=nonlinear)
    tq = port_adamw.q8_quantize(torch.from_numpy(x), nonlinear=nonlinear)
    assert tq.codes.dtype == torch.int8 and tuple(tq.codes.shape) == jq.codes.shape
    _codes_close(tq.codes.numpy(), np.asarray(jq.codes), "codes")
    np.testing.assert_allclose(tq.scale.numpy(), np.asarray(jq.scale), rtol=1e-6)
    same = port_adamw.Q8(torch.from_numpy(np.array(jq.codes)), torch.from_numpy(np.array(jq.scale)))
    np.testing.assert_allclose(port_adamw.q8_dequantize(same, nonlinear=nonlinear).numpy(),
                               np.asarray(jax_adamw.q8_dequantize(jq, nonlinear=nonlinear)), rtol=1e-6, atol=1e-30)


def test_global_norm_matches_reference():
    tree = _tree(5)
    np.testing.assert_allclose(float(port_adamw.global_norm(_t(tree))), float(jax_adamw.global_norm(_j(tree))),
                               rtol=1e-6)


@pytest.mark.parametrize("name,args", [("warmup_cosine", (10, 100)), ("warmup_cosine", (0, 50, 0.0)),
                                       ("inverse_sqrt", (16,)), ("constant", ())])
def test_schedules_match_reference(name, args):
    jf, tf = getattr(jax_sched, name)(*args), getattr(port_sched, name)(*args)
    for step in (0, 1, 5, 10, 11, 49, 50, 99, 100, 250):
        np.testing.assert_allclose(float(tf(step)), float(jf(step)), rtol=1e-6, err_msg=f"{name} step {step}")
        np.testing.assert_allclose(float(tf(torch.tensor(step, dtype=torch.int32))), float(jf(step)), rtol=1e-6)


def test_ef_compress_tree_matches_reference():
    grads, err = _tree(7), _tree(8, 0.01)
    jg, je = jax_gc.ef_compress_tree(_j(grads), _j(err))
    tg, te = port_gc.ef_compress_tree(_t(grads), _t(err))
    for a, b in ((tg, jg), (te, je)):
        for path, got in tu.leaves_with_path(a):
            want = dict(tu.leaves_with_path(jax.tree.map(np.asarray, b)))[path]
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7, err_msg=path)
    zeros = port_gc.init_error_buffer(_t(grads))
    assert all(float(z.abs().sum()) == 0 and z.dtype == torch.float32 for z in tu.leaves(zeros))
