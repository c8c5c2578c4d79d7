"""The port's SSM-family models against the reference package on the CPU.

Both packages get the same weights (``Model.init_numpy``, numpy from a seed,
carried into the port by ``params_from_numpy``) and the same tokens.

Tolerances: float32 logits and caches within atol 2e-4 (the reference holds
decode against forward at 5e-4, tests/test_models.py); bfloat16 within atol
0.2 + rtol 0.05: the two packages round activations to bf16 at the same points
but sum in other orders, and a bf16 step (0.4% relative) at one layer moves
the next ones (observed at most 0.13 on k/v caches of |value| up to ~8 over
five layers).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model as jax_model_mod
from repro.models import ssm_models as jax_ssm
from repro.models.model import build_model as jax_build
from repro_torch.configs import get_config as port_config
from repro_torch.models import defs as D
from repro_torch.models import model as port_model_mod
from repro_torch.models import ssm_models as port_ssm
from repro_torch.models.model import build_model as port_build
from repro_torch.models.model import params_from_numpy

TOL = {"float32": dict(atol=2e-4, rtol=0.0), "bfloat16": dict(atol=0.2, rtol=0.05)}
CONFIGS = [("falcon-mamba-7b", 2), ("zamba2-1.2b", 2), ("zamba2-1.2b", 5)]  # (arch, reduced n_layers)


def _np(x) -> np.ndarray:
    return x.float().numpy().copy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _pair_cfgs(arch: str, n_layers: int, dtype: str):
    kw = dict(dtype=dtype, n_layers=n_layers)
    return (dataclasses.replace(jax_config(arch).reduced(), **kw),
            dataclasses.replace(port_config(arch).reduced(), **kw))


class TestParamDefs:
    @pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-1.2b"])
    def test_trees_match_reference_at_full_size(self, arch):
        jdefs = jax_build(jax_config(arch)).param_defs()
        tmodel = port_build(port_config(arch))
        leaves = list(D.leaves(tmodel.param_defs()))
        assert len(leaves) == len(jax.tree.leaves(jdefs, is_leaf=lambda x: hasattr(x, "axes")))
        for path, d in leaves:
            j = jdefs
            for k in path:
                j = j[k]
            assert (d.shape, d.axes, d.init, d.scale) == (j.shape, j.axes, j.init, j.scale), path
            assert str(d.dtype).removeprefix("torch.") == jnp.dtype(j.dtype).name, path
        assert tmodel.param_count() == jax_build(jax_config(arch)).param_count() == port_config(arch).param_count()

    def test_numpy_init_is_seeded_and_follows_the_init_kinds(self):
        cfg = port_config("zamba2-1.2b").reduced()
        a, b = port_build(cfg).init_numpy(7), port_build(cfg).init_numpy(7)
        flat_a = {p: v for p, v in _leaf_arrays(a)}
        flat_b = {p: v for p, v in _leaf_arrays(b)}
        assert flat_a.keys() == flat_b.keys()
        for p in flat_a:
            np.testing.assert_array_equal(flat_a[p], flat_b[p])
            assert flat_a[p].dtype == np.float32
        assert np.all(flat_a[("layers", "conv_b")] == 0) and np.all(flat_a[("final_norm",)] == 1)
        np.testing.assert_allclose(flat_a[("layers", "A_log")][0], np.log(np.arange(1, 9)), rtol=1e-6)
        assert abs(float(flat_a[("embed",)].std()) - 0.02) < 2e-3
        assert not np.array_equal(flat_a[("layers", "in_proj")], port_build(cfg).init_numpy(8)["layers"]["in_proj"])


def _leaf_arrays(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_arrays(tree[k], path + (k,))
    else:
        yield path, tree


@pytest.fixture(scope="module", params=[(a, n, dt) for a, n in CONFIGS for dt in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-L{p[1]}-{p[2]}")
def runs(request):
    """Forward, prefill and two decode steps in both packages on one set of
    numpy weights and tokens."""
    arch, n_layers, dtype = request.param
    jcfg, tcfg = _pair_cfgs(arch, n_layers, dtype)
    jm, tm = jax_build(jcfg), port_build(tcfg)
    weights = tm.init_numpy(3)
    jp, tp = jax.tree.map(jnp.asarray, weights), params_from_numpy(tcfg, weights, "cpu")
    tokens = np.random.default_rng(0).integers(0, tcfg.vocab_size, (2, 13))
    t0, max_len = 9, 16
    out = {"dtype": dtype, "cfg": tcfg, "tm": tm, "tp": tp, "tokens": tokens}
    jl, _, _ = jm.forward(jp, jnp.asarray(tokens))
    tl, _, _ = tm.forward(tp, torch.as_tensor(tokens))
    out["forward"] = (jl, tl)
    jlast, jcache = jm.prefill(jp, jnp.asarray(tokens[:, :t0]), max_len=max_len)
    tlast, tcache = tm.prefill(tp, torch.as_tensor(tokens[:, :t0]), max_len=max_len)
    out["prefill"] = (jlast, tlast)
    out["prefill_cache"] = ({k: np.asarray(v, np.float32) for k, v in jcache.items()},
                            {k: _np(v) for k, v in tcache.items()})
    steps = []
    for t in (t0, t0 + 1):
        jl2, jcache = jm.decode_step(jp, jnp.asarray(tokens[:, t:t + 1]), jcache)
        tl2, tcache = tm.decode_step(tp, torch.as_tensor(tokens[:, t:t + 1]), tcache)
        steps.append((jl2, tl2))
    out["decode"] = steps
    out["decode_cache"] = (jcache, tcache)
    return out


class TestModelAgainstReference:
    def test_forward(self, runs):
        jl, tl = runs["forward"]
        assert tl.dtype == torch.float32 and tuple(tl.shape) == tuple(jl.shape)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL[runs["dtype"]])

    def test_prefill_logits_and_cache(self, runs):
        jl, tl = runs["prefill"]
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL[runs["dtype"]])
        jc, tc = runs["prefill_cache"]
        assert jc.keys() == tc.keys()
        for k in jc:
            assert jc[k].shape == tc[k].shape, k
            np.testing.assert_allclose(tc[k], jc[k], **TOL[runs["dtype"]], err_msg=k)

    def test_decode_steps(self, runs):
        for i, (jl, tl) in enumerate(runs["decode"]):
            np.testing.assert_allclose(_np(tl), _np(jl), **TOL[runs["dtype"]], err_msg=f"step {i}")
        jc, tc = runs["decode_cache"]
        for k in jc:
            np.testing.assert_allclose(_np(tc[k]), _np(jc[k]), **TOL[runs["dtype"]], err_msg=k)
        assert tc["len"].tolist() == [11, 11]


class TestLayersAgainstReference:
    """Single layers at reduced size in float32, on the same numpy weights."""

    @pytest.fixture(scope="class")
    def setups(self):
        out = {}
        for arch in ("falcon-mamba-7b", "zamba2-1.2b"):
            jcfg, tcfg = _pair_cfgs(arch, 2, "float32")
            weights = port_build(tcfg).init_numpy(5)
            h = np.random.default_rng(1).standard_normal((2, 11, tcfg.d_model), np.float32)
            out[arch] = (jcfg, tcfg, jax.tree.map(jnp.asarray, weights), params_from_numpy(tcfg, weights, "cpu"), h)
        return out

    def test_mamba1_layer_and_decode(self, setups):
        jcfg, tcfg, jp, tp, h = setups["falcon-mamba-7b"]
        jlp = jax.tree.map(lambda x: x[1], jp["layers"])
        tlp = {k: v[1] for k, v in tp["layers"].items()}
        want = jax_ssm.mamba1_layer(jcfg, jlp, jnp.asarray(h), chunk=11)
        got, (conv, state) = port_ssm.mamba1_layer(tcfg, tlp, torch.from_numpy(h))
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-4)
        assert tuple(conv.shape) == (2, 3, tcfg.d_inner) and tuple(state.shape) == (2, tcfg.d_inner, 8)
        # one decode step from the full-sequence state equals the layer on one more token
        h2 = np.random.default_rng(2).standard_normal((2, 1, tcfg.d_model), np.float32)
        jd, _, _ = jax_ssm.mamba1_decode(jcfg, jlp, jnp.asarray(h2), jnp.asarray(_np(conv)), jnp.asarray(_np(state)))
        td, _, _ = port_ssm.mamba1_decode(tcfg, tlp, torch.from_numpy(h2), conv, state)
        np.testing.assert_allclose(_np(td), _np(jd), atol=2e-4)
        full, _ = port_ssm.mamba1_layer(tcfg, tlp, torch.from_numpy(np.concatenate([h, h2], 1)))
        np.testing.assert_allclose(_np(td[:, 0]), _np(full[:, -1]), atol=2e-4)

    def test_mamba2_layer_and_decode(self, setups):
        jcfg, tcfg, jp, tp, h = setups["zamba2-1.2b"]
        jlp = jax.tree.map(lambda x: x[0], jp["layers"])
        tlp = {k: v[0] for k, v in tp["layers"].items()}
        want = jax_ssm.mamba2_layer(jcfg, jlp, jnp.asarray(h), chunk=11)
        got, (conv, state) = port_ssm.mamba2_layer(tcfg, tlp, torch.from_numpy(h))
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-4)
        h2 = np.random.default_rng(2).standard_normal((2, 1, tcfg.d_model), np.float32)
        jd, _, _ = jax_ssm.mamba2_decode(jcfg, jlp, jnp.asarray(h2), jnp.asarray(_np(conv)), jnp.asarray(_np(state)))
        td, _, _ = port_ssm.mamba2_decode(tcfg, tlp, torch.from_numpy(h2), conv, state)
        np.testing.assert_allclose(_np(td), _np(jd), atol=2e-4)
        full, _ = port_ssm.mamba2_layer(tcfg, tlp, torch.from_numpy(np.concatenate([h, h2], 1)))
        np.testing.assert_allclose(_np(td[:, 0]), _np(full[:, -1]), atol=2e-4)

    def test_shared_block(self, setups):
        jcfg, tcfg, jp, tp, h = setups["zamba2-1.2b"]
        h0 = np.random.default_rng(3).standard_normal(h.shape, np.float32)
        pos = np.broadcast_to(np.arange(h.shape[1]), h.shape[:2])
        want, (jk, jv) = jax_model_mod._shared_block(jcfg, jp["shared"], jnp.asarray(h), jnp.asarray(h0),
                                                    jnp.asarray(pos), None)
        got, (tk, tv) = port_model_mod._shared_block(tcfg, tp["shared"], torch.from_numpy(h), torch.from_numpy(h0),
                                                     torch.from_numpy(pos.copy()))
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-4)
        np.testing.assert_allclose(_np(tk), _np(jk), atol=2e-4)
        np.testing.assert_allclose(_np(tv), _np(jv), atol=2e-4)


class TestWithinPort:
    @pytest.mark.parametrize("arch,n_layers", CONFIGS)
    def test_decode_matches_forward(self, arch, n_layers):
        """As tests/test_models.py holds the reference: decode after a prefill
        of t0 tokens gives the full forward's logits at each later position."""
        cfg = dataclasses.replace(port_config(arch).reduced(), dtype="float32", n_layers=n_layers)
        m = port_build(cfg)
        params = m.init(seed=1, device="cpu")
        tokens = torch.as_tensor(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 12)))
        full, _, _ = m.forward(params, tokens)
        _, cache = m.prefill(params, tokens[:, :8], max_len=16)
        for t in range(8, 12):
            lg, cache = m.decode_step(params, tokens[:, t:t + 1], cache)
            torch.testing.assert_close(lg, full[:, t], atol=5e-4, rtol=0)

    def test_decode_past_max_len_drops_the_write(self):
        cfg = dataclasses.replace(port_config("zamba2-1.2b").reduced(), dtype="float32")
        m = port_build(cfg)
        params = m.init(seed=2, device="cpu")
        _, cache = m.prefill(params, torch.zeros(1, 6, dtype=torch.int64), max_len=6)
        k_before = cache["k"].clone()
        lg, cache = m.decode_step(params, torch.zeros(1, 1, dtype=torch.int64), cache)  # len 6 == max_len
        assert bool(torch.isfinite(lg).all())
        torch.testing.assert_close(cache["k"], k_before, rtol=0, atol=0)
        assert cache["len"].tolist() == [7]

    def test_short_prompt_conv_window_is_left_padded(self):
        cfg = dataclasses.replace(port_config("falcon-mamba-7b").reduced(), dtype="float32")
        m = port_build(cfg)
        params = m.init(seed=3, device="cpu")
        tokens = torch.as_tensor([[5, 9]])  # shorter than d_conv - 1 = 3
        _, cache = m.prefill(params, tokens, max_len=8)
        assert bool(torch.all(cache["conv"][:, :, 0] == 0))  # the pad row before the first token

    def test_init_uses_the_device_generator(self):
        cfg = port_config("falcon-mamba-7b").reduced()
        a, b = port_build(cfg).init(seed=4, device="cpu"), port_build(cfg).init(seed=4, device="cpu")
        torch.testing.assert_close(a["layers"]["in_proj"], b["layers"]["in_proj"], rtol=0, atol=0)
        assert a["layers"]["A_log"].dtype == torch.float32

    def test_precast_keeps_numerics_leaves_in_float32(self):
        cfg = port_config("zamba2-1.2b").reduced()
        m = port_build(cfg)
        p = m.precast(m.init(seed=0, device="cpu"))
        assert p["layers"]["in_proj"].dtype == torch.bfloat16 and p["lm_head"].dtype == torch.bfloat16
        assert p["layers"]["A_log"].dtype == torch.float32 and p["shared"]["ln1"].dtype == torch.float32
        assert p["embed"].dtype == torch.float32
        again = m.precast(p)
        assert again["layers"]["in_proj"] is p["layers"]["in_proj"]  # a second cast copies nothing
