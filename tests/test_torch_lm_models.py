"""The port's transformer families (dense, MoE, vision, audio) against the
reference package on the CPU.

Both packages get the same weights (``Model.init_numpy``, numpy from a seed,
carried into the port by ``params_from_numpy``) and the same tokens.  Two
leaves start at a value that would hide a fault, so both packages get them
changed alike: the vision cross layers' ``attn_gate`` and ``mlp_gate`` start at
0 (``tanh(0)`` zeroes the cross path) and are set to seeded values in
[0.3, 0.9], and the ``qkv_bias`` biases start at 0 and are set to seeded
normals (std 0.1).  The vision input is a seeded normal array, not zeros.

Tolerances: float32 within atol 2e-4, as tests/test_torch_ssm_models.py.
bfloat16 within that file's atol 0.2 + rtol 0.05, at one layer (the vlm: one
group, a self and a cross layer).  The two packages round to bf16 at the same
points, but float32 sin, cos and pow differ by an ulp between XLA and torch,
which now and then moves a bf16 rounding by one step; with the reference's
initializer (std over the second-last dim, so k and v reach |20| in these
reduced configs) the next layer's near-one-hot softmax amplifies such a step
several-fold.  At two layers the reference's own bf16 run is 1.2-5.5x that
tolerance away from its float32 run, and the port's bf16 run as far (qwen2.5:
2.5x and 2.7x on the logits), so bf16 is held where it measures the rounding
points.  The MoE family is held in bf16 at ``moe_ffn`` on identical inputs:
a bf16 step upstream can flip a router choice.

kimi-k2 stores its weight matrices in bf16 (``param_dtype``): the port rounds
the numpy weights to bf16 where ``params_from_numpy`` loads them, while the
reference keeps float32 arrays it is handed as they are.  Both packages get
the bf16-rounded values (``as_stored``), and each computes in float32 on them;
kimi-k2 also runs at its real head width, 112, on the reduced config.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import layers as jax_layers
from repro.models import moe as jax_moe
from repro.models import transformer as jax_T
from repro.models.model import build_model as jax_build
from repro_torch.configs import get_config as port_config
from repro_torch.models import defs as D
from repro_torch.models import layers as port_layers
from repro_torch.models import moe as port_moe
from repro_torch.models import transformer as port_T
from repro_torch.models.model import build_model as port_build
from repro_torch.models.model import params_from_numpy
from tools.make_torch_lm_ref import as_stored

TOL = {"float32": dict(atol=2e-4, rtol=0.0), "bfloat16": dict(atol=0.2, rtol=0.05)}
LM_CONFIGS = ["granite-3-8b", "qwen2.5-32b", "minitron-8b", "phi4-mini-3.8b", "musicgen-large",
              "llama-3.2-vision-11b", "llama4-scout-17b-a16e", "kimi-k2-1t-a32b"]
# (arch, reduced n_layers in float32, in bfloat16 or None[, config overrides])
MODELS = [("granite-3-8b", 2, 1), ("qwen2.5-32b", 2, 1), ("minitron-8b", 2, 1), ("musicgen-large", 2, 1),
          ("llama-3.2-vision-11b", 4, 2), ("llama4-scout-17b-a16e", 2, None), ("kimi-k2-1t-a32b", 2, None),
          ("kimi-k2-1t-a32b", 2, None, {"head_dim": 112})]


def _model_id(arch: str, overrides: dict) -> str:
    return arch + "".join(f"-{k}{v}" for k, v in sorted(overrides.items()))


def _np(x) -> np.ndarray:
    return x.float().numpy().copy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _pair_cfgs(arch: str, n_layers: int, dtype: str, **overrides):
    kw = dict(dtype=dtype, n_layers=n_layers, **overrides)
    return (dataclasses.replace(jax_config(arch).reduced(), **kw),
            dataclasses.replace(port_config(arch).reduced(), **kw))


def _weights(model, seed: int) -> dict:
    """``init_numpy(seed)`` with the cross gates and the qkv biases moved off 0."""
    w = model.init_numpy(seed)
    rng = np.random.default_rng(seed + 100)
    if "cross_layers" in w:
        for g in ("attn_gate", "mlp_gate"):
            w["cross_layers"][g] = rng.uniform(0.3, 0.9, w["cross_layers"][g].shape).astype(np.float32)
    for tree in (w["layers"], w.get("cross_layers", {})):
        for b in ("bq", "bk", "bv"):
            if b in tree:
                tree[b] = (0.1 * rng.standard_normal(tree[b].shape)).astype(np.float32)
    return w


def _tokens(cfg, shape, seed: int) -> np.ndarray:
    shape = tuple(shape) + ((cfg.audio.n_codebooks,) if cfg.audio else ())
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _vision(cfg, B: int, seed: int):
    if not cfg.vision:
        return None
    return np.random.default_rng(seed).standard_normal((B, cfg.vision.n_patches, cfg.vision.d_vision)).astype(
        np.float32)


# --------------------------------------------------------------------------- #
# parameter trees
# --------------------------------------------------------------------------- #


class TestParamDefs:
    @pytest.mark.parametrize("arch", LM_CONFIGS)
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

    def test_params_from_numpy_takes_the_new_trees(self):
        """cross_layers, patch_proj, biases, and bf16 weights (kimi-k2's param_dtype)."""
        for arch in ("llama-3.2-vision-11b", "qwen2.5-32b", "kimi-k2-1t-a32b"):
            cfg = port_config(arch).reduced()
            if arch == "kimi-k2-1t-a32b":
                assert cfg.param_dtype == "bfloat16"
            m = port_build(cfg)
            w = _weights(m, 0)
            p = params_from_numpy(cfg, w, "cpu")
            for path, d in D.leaves(m.param_defs()):
                t, a = p, w
                for k in path:
                    t, a = t[k], a[k]
                assert t.dtype == d.dtype and tuple(t.shape) == d.shape, path
                torch.testing.assert_close(t.float(), torch.from_numpy(a).to(d.dtype).float(), rtol=0, atol=0)
        bad = port_build(port_config("llama-3.2-vision-11b").reduced()).init_numpy(0)
        del bad["patch_proj"]
        with pytest.raises(ValueError, match="keys"):
            params_from_numpy(port_config("llama-3.2-vision-11b").reduced(), bad, "cpu")

    def test_precast_casts_the_cross_layers(self):
        cfg = port_config("llama-3.2-vision-11b").reduced()
        m = port_build(cfg)
        p = m.precast(m.init(seed=0, device="cpu"))
        assert p["cross_layers"]["wq"].dtype == torch.bfloat16 and p["layers"]["w_gate"].dtype == torch.bfloat16
        assert p["cross_layers"]["attn_gate"].dtype == torch.float32 and p["cross_layers"]["ln1"].dtype == torch.float32
        assert p["patch_proj"].dtype == torch.float32  # cast at its product, as in the reference


# --------------------------------------------------------------------------- #
# functions
# --------------------------------------------------------------------------- #


class TestFunctions:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("kind", ["swiglu", "gelu", "relu2"])
    def test_mlp_act(self, kind, dtype):
        rng = np.random.default_rng(0)
        g, u = (3 * rng.standard_normal((4, 7, 33))).astype(np.float32), rng.standard_normal((4, 7, 33)).astype(
            np.float32)
        jd, td = jnp.dtype(dtype), getattr(torch, dtype)
        want = jax_layers.mlp_act(jnp.asarray(g).astype(jd), jnp.asarray(u).astype(jd), kind)
        got = port_layers.mlp_act(torch.from_numpy(g).to(td), torch.from_numpy(u).to(td), kind)
        assert got.dtype == td
        tol = dict(atol=1e-6, rtol=1e-6) if dtype == "float32" else dict(atol=1e-2, rtol=1e-2)
        np.testing.assert_allclose(_np(got), _np(want), **tol)

    def test_mlp_act_rejects_other_kinds(self):
        with pytest.raises(ValueError, match="geglu"):
            port_layers.mlp_act(torch.zeros(2), None, "geglu")

    @pytest.fixture(scope="class")
    def audio(self):
        jcfg, tcfg = _pair_cfgs("musicgen-large", 2, "float32")
        jcfg = dataclasses.replace(jcfg, audio=dataclasses.replace(jcfg.audio, n_codebooks=3))
        tcfg = dataclasses.replace(tcfg, audio=dataclasses.replace(tcfg.audio, n_codebooks=3))
        w = port_build(tcfg).init_numpy(1)
        return jcfg, tcfg, jax.tree.map(jnp.asarray, w), params_from_numpy(tcfg, w, "cpu")

    def test_embed_and_head_with_codebooks(self, audio):
        jcfg, tcfg, jp, tp = audio
        tokens = _tokens(tcfg, (2, 5), 2)
        want = jax_T.embed_tokens(jcfg, jp, jnp.asarray(tokens), jnp.float32)
        got = port_T.embed_tokens(tcfg, tp, torch.as_tensor(tokens), torch.float32)
        np.testing.assert_array_equal(_np(got), _np(want))  # the same sums in the same order
        h = np.random.default_rng(3).standard_normal((2, 5, tcfg.d_model)).astype(np.float32)
        want = jax_T.lm_logits(jcfg, jp, jnp.asarray(h))
        got = port_T.lm_logits(tcfg, tp, torch.from_numpy(h))
        assert tuple(got.shape) == (2, 5, 3, tcfg.vocab_size) == tuple(want.shape) and got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)
        dense_cfg = port_config("granite-3-8b").reduced()
        dense = params_from_numpy(dense_cfg, port_build(dense_cfg).init_numpy(1), "cpu")
        assert tuple(port_T.lm_logits(dense_cfg, dense, torch.from_numpy(h)).shape) == (2, 5, dense_cfg.vocab_size)

    @pytest.fixture(scope="class")
    def qwen(self):
        jcfg, tcfg = _pair_cfgs("qwen2.5-32b", 2, "float32")  # qkv_bias
        w = _weights(port_build(tcfg), 4)
        h = np.random.default_rng(5).standard_normal((2, 11, tcfg.d_model)).astype(np.float32)
        return (jcfg, tcfg, jax.tree.map(lambda x: jnp.asarray(x)[1], w["layers"]),
                {k: v[1] for k, v in params_from_numpy(tcfg, w, "cpu")["layers"].items()}, h)

    def test_self_attention_block_and_decode(self, qwen):
        jcfg, tcfg, jlp, tlp, h = qwen
        pos = np.broadcast_to(np.arange(h.shape[1]), h.shape[:2])
        want, (jk, jv) = jax_T.self_attn_block(jcfg, jlp, jnp.asarray(h), jnp.asarray(pos))
        got, (tk, tv) = port_T.self_attn_block(tcfg, tlp, torch.from_numpy(h), torch.from_numpy(pos.copy()))
        for a, b in ((got, want), (tk, jk), (tv, jv)):
            np.testing.assert_allclose(_np(a), _np(b), atol=2e-4)
        # one token per slot against caches of ragged lengths (3 and 9 of 16)
        lens = np.array([3, 9])
        kc = np.zeros((2, 16) + tuple(tk.shape[2:]), np.float32)
        vc = np.zeros_like(kc)
        for b, n in enumerate(lens):
            kc[b, :n], vc[b, :n] = _np(tk)[b, :n], _np(tv)[b, :n]
        h1 = np.random.default_rng(6).standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
        want, jkc, jvc = jax_T.self_attn_decode(jcfg, jlp, jnp.asarray(h1), jnp.asarray(kc), jnp.asarray(vc),
                                                jnp.asarray(lens))
        tkc, tvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
        got, rk, rv = port_T.self_attn_decode(tcfg, tlp, torch.from_numpy(h1), tkc, tvc, torch.from_numpy(lens))
        assert rk is tkc and rv is tvc  # written in place
        for a, b in ((got, want), (tkc, jkc), (tvc, jvc)):
            np.testing.assert_allclose(_np(a), _np(b), atol=2e-4)

    def test_cross_attention_with_vision_kv(self):
        jcfg, tcfg = _pair_cfgs("llama-3.2-vision-11b", 2, "float32")
        w = _weights(port_build(tcfg), 7)
        jlp = jax.tree.map(lambda x: jnp.asarray(x)[0], w["cross_layers"])
        tlp = {k: v[0] for k, v in params_from_numpy(tcfg, w, "cpu")["cross_layers"].items()}
        rng = np.random.default_rng(8)
        vis = rng.standard_normal((2, tcfg.vision.n_patches, tcfg.d_model)).astype(np.float32)
        jk, jv = jax_T.vision_kv(jcfg, jlp, jnp.asarray(vis))
        tk, tv = port_T.vision_kv(tcfg, tlp, torch.from_numpy(vis))
        np.testing.assert_allclose(_np(tk), _np(jk), atol=2e-5)
        np.testing.assert_allclose(_np(tv), _np(jv), atol=2e-5)
        for S in (1, 11):  # a decode step and a prompt
            h = rng.standard_normal((2, S, tcfg.d_model)).astype(np.float32)
            want = jax_T.cross_attn_block(jcfg, jlp, jnp.asarray(h), jk, jv)
            got = port_T.cross_attn_block(tcfg, tlp, torch.from_numpy(h), tk, tv)
            assert float(np.abs(_np(got)).max()) > 0.1
            np.testing.assert_allclose(_np(got), _np(want), atol=2e-4)

    @pytest.mark.parametrize("arch", ["granite-3-8b", "minitron-8b", "musicgen-large"])
    def test_mlp_block(self, arch):
        jcfg, tcfg = _pair_cfgs(arch, 2, "float32")
        w = port_build(tcfg).init_numpy(9)
        h = np.random.default_rng(10).standard_normal((2, 7, tcfg.d_model)).astype(np.float32)
        want = jax_T.mlp_block(jcfg, jax.tree.map(lambda x: jnp.asarray(x)[0], w["layers"]), jnp.asarray(h))
        got = port_T.mlp_block(tcfg, {k: v[0] for k, v in params_from_numpy(tcfg, w, "cpu")["layers"].items()},
                               torch.from_numpy(h))
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-4)


# --------------------------------------------------------------------------- #
# MoE
# --------------------------------------------------------------------------- #


def _moe_inputs(T: int, d: int, E: int, f: int, seed: int, skew: float = 0.0, hot: int = 1):
    """x [T, d] and the weights; ``skew`` tilts every token toward the first
    ``hot`` experts."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, d)).astype(np.float32) + np.float32(skew > 0)
    rw = (rng.standard_normal((d, E)) * 0.3).astype(np.float32)
    rw[:, :hot] += skew
    wg, wu = ((rng.standard_normal((E, d, f)) / np.sqrt(d)).astype(np.float32) for _ in range(2))
    wd = (rng.standard_normal((E, f, d)) / np.sqrt(f)).astype(np.float32)
    return x, rw, wg, wu, wd


class TestMoE:
    @pytest.mark.parametrize("case", ["balanced-top2", "skewed-top2", "two-hot-top2", "skewed-top1-gelu"])
    def test_moe_ffn_against_reference(self, case):
        """"two-hot": experts 0 and 1 are every token's pair, in either slot,
        and both overflow: which tokens drop depends on counting positions
        token-major, slot-minor."""
        skew = 0.0 if case.startswith("balanced") else 0.5
        top_k = 1 if "top1" in case else 2
        kind = "gelu" if "gelu" in case else "swiglu"
        arrays = _moe_inputs(300, 32, 4, 48, 11, skew, hot=2 if case.startswith("two-hot") else 1)
        want = jax_moe.moe_ffn(*map(jnp.asarray, arrays), top_k=top_k, mlp_kind=kind)
        got = port_moe.moe_ffn(*map(torch.from_numpy, arrays), top_k=top_k, mlp_kind=kind)
        np.testing.assert_allclose(_np(got.y), _np(want.y), atol=2e-5)
        for name in ("aux_loss", "z_loss", "dropped_frac"):
            np.testing.assert_allclose(float(getattr(got, name)), float(getattr(want, name)), rtol=1e-5, err_msg=name)
        if skew:  # expert 0 overflows its capacity of 256 (or 128 at top-1)
            assert float(got.dropped_frac) > 0.05
        else:
            assert float(got.dropped_frac) == 0.0

    def test_moe_ffn_matches_the_dense_oracle_when_nothing_drops(self):
        arrays = _moe_inputs(64, 32, 4, 48, 12)
        t = [torch.from_numpy(a) for a in arrays]
        out = port_moe.moe_ffn(*t, top_k=2, capacity_factor=8.0, cumsum_blocks=4)
        assert float(out.dropped_frac) == 0.0
        dense = port_moe.moe_ffn_dense_ref(*t, top_k=2)
        torch.testing.assert_close(out.y, dense, atol=1e-5, rtol=1e-5)
        want = jax_moe.moe_ffn_dense_ref(*map(jnp.asarray, arrays), top_k=2)
        np.testing.assert_allclose(_np(dense), _np(want), atol=2e-5)

    def test_moe_ffn_bf16_on_identical_inputs(self):
        arrays = _moe_inputs(300, 32, 4, 48, 13, 0.5)
        jx = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays]
        tx = [torch.from_numpy(a).bfloat16() for a in arrays]
        want = jax_moe.moe_ffn(*jx, top_k=2)
        got = port_moe.moe_ffn(*tx, top_k=2)
        assert got.y.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got.y), _np(want.y), **TOL["bfloat16"])
        assert float(got.dropped_frac) == pytest.approx(float(want.dropped_frac))

    def test_capacity_and_cumsum(self):
        assert port_moe.moe_capacity(1024, 8, 2, 1.25) == jax_moe.moe_capacity(1024, 8, 2, 1.25) == 384
        assert port_moe.moe_capacity(2, 16, 1, 1.25) == 128
        x = np.random.default_rng(14).integers(0, 3, (24, 5)).astype(np.float32)
        for blocks in (1, 4, 8):
            got = port_moe.distributed_cumsum(torch.from_numpy(x), blocks)
            np.testing.assert_array_equal(_np(got), np.cumsum(x, 0) - x)


# --------------------------------------------------------------------------- #
# whole models
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module", params=[(m[0], m[1], "float32", *m[3:]) for m in MODELS]
                + [(m[0], m[2], "bfloat16", *m[3:]) for m in MODELS if m[2]],
                ids=lambda p: f"{_model_id(p[0], p[3] if len(p) > 3 else {})}-L{p[1]}-{p[2]}")
def runs(request):
    """Forward, prefill (exact, and bucketed: right-padded to 16 with
    ``length=``) and two decode steps after each, in both packages."""
    arch, n_layers, dtype, *overrides = request.param
    jcfg, tcfg = _pair_cfgs(arch, n_layers, dtype, **(overrides[0] if overrides else {}))
    jm, tm = jax_build(jcfg), port_build(tcfg)
    weights = as_stored(tm, _weights(tm, 3))
    jp, tp = jax.tree.map(jnp.asarray, weights), params_from_numpy(tcfg, weights, "cpu")
    tokens = _tokens(tcfg, (2, 13), 0)
    vis = _vision(tcfg, 2, 1)
    jvis, tvis = (None, None) if vis is None else (jnp.asarray(vis), torch.from_numpy(vis))
    t0, max_len, bucket = 9, 24, 16
    out = {"dtype": dtype, "cfg": tcfg}
    jl, _, _ = jm.forward(jp, jnp.asarray(tokens), vision=jvis)
    tl, _, _ = tm.forward(tp, torch.as_tensor(tokens), vision=tvis)
    out["forward"] = (jl, tl)
    padded = np.concatenate([tokens[:, :t0], np.zeros_like(tokens[:, :bucket - t0])], 1)
    for name, prompt, length in (("exact", tokens[:, :t0], None), ("bucketed", padded, t0)):
        jlast, jcache = jm.prefill(jp, jnp.asarray(prompt), max_len=max_len, vision=jvis, length=length)
        tlast, tcache = tm.prefill(tp, torch.as_tensor(prompt), max_len=max_len, vision=tvis, length=length)
        out[name] = {"prefill": (jlast, tlast),
                     "cache": ({k: np.asarray(v, np.float32) for k, v in jcache.items()},
                               {k: _np(v) for k, v in tcache.items()})}
        steps = []
        for t in (t0, t0 + 1):
            jl2, jcache = jm.decode_step(jp, jnp.asarray(tokens[:, t:t + 1]), jcache)
            tl2, tcache = tm.decode_step(tp, torch.as_tensor(tokens[:, t:t + 1]), tcache)
            steps.append((jl2, tl2))
        out[name]["decode"] = steps
        out[name]["decode_cache"] = (jcache, tcache)
    return out


class TestModelAgainstReference:
    def test_forward(self, runs):
        jl, tl = runs["forward"]
        assert tl.dtype == torch.float32 and tuple(tl.shape) == tuple(jl.shape)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL[runs["dtype"]])

    @pytest.mark.parametrize("mode", ["exact", "bucketed"])
    def test_prefill_logits_and_cache(self, runs, mode):
        jl, tl = runs[mode]["prefill"]
        assert tuple(tl.shape) == tuple(jl.shape)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL[runs["dtype"]])
        jc, tc = runs[mode]["cache"]
        assert jc.keys() == tc.keys()
        for k in jc:
            assert jc[k].shape == tc[k].shape, k
            np.testing.assert_allclose(tc[k], jc[k], **TOL[runs["dtype"]], err_msg=k)
        assert tc["len"].tolist() == [9, 9]

    @pytest.mark.parametrize("mode", ["exact", "bucketed"])
    def test_decode_steps(self, runs, mode):
        for i, (jl, tl) in enumerate(runs[mode]["decode"]):
            np.testing.assert_allclose(_np(tl), _np(jl), **TOL[runs["dtype"]], err_msg=f"step {i}")
        jc, tc = runs[mode]["decode_cache"]
        for k in jc:
            np.testing.assert_allclose(_np(tc[k]), _np(jc[k]), **TOL[runs["dtype"]], err_msg=k)
        assert tc["len"].tolist() == [11, 11]

    def test_bucketed_decode_equals_exact(self, runs):
        """Padding the prompt changes nothing that decode reads."""
        ex, bu = runs["exact"]["decode"], runs["bucketed"]["decode"]
        tol = dict(atol=2e-5, rtol=0) if runs["dtype"] == "float32" else TOL["bfloat16"]
        for (_, a), (_, b) in zip(ex, bu):
            np.testing.assert_allclose(_np(b), _np(a), **tol)


class TestWithinPort:
    @pytest.mark.parametrize("arch,n_layers,overrides", [(m[0], m[1], (m[3:] or ({},))[0]) for m in MODELS],
                             ids=[f"{_model_id(m[0], (m[3:] or ({},))[0])}-{m[1]}" for m in MODELS])
    def test_decode_matches_forward(self, arch, n_layers, overrides):
        """As tests/test_models.py holds the reference: decode after a prefill
        of t0 tokens gives the full forward's logits at each later position."""
        cfg = dataclasses.replace(port_config(arch).reduced(), dtype="float32", n_layers=n_layers, **overrides)
        m = port_build(cfg)
        params = params_from_numpy(cfg, _weights(m, 1), "cpu")
        tokens = torch.as_tensor(_tokens(cfg, (2, 12), 4))
        vis = _vision(cfg, 2, 5)
        vis = None if vis is None else torch.from_numpy(vis)
        full, _, _ = m.forward(params, tokens, vision=vis)
        _, cache = m.prefill(params, tokens[:, :8], max_len=16, vision=vis)
        for t in range(8, 12):
            lg, cache = m.decode_step(params, tokens[:, t:t + 1], cache)
            torch.testing.assert_close(lg, full[:, t], atol=5e-4, rtol=0)

    def test_recurrent_families_refuse_a_bucketed_prefill(self):
        cfg = dataclasses.replace(port_config("falcon-mamba-7b").reduced(), dtype="float32")
        m = port_build(cfg)
        with pytest.raises(ValueError, match="recurrent state"):
            m.prefill(m.init(seed=0, device="cpu"), torch.zeros(1, 8, dtype=torch.int64), max_len=8, length=5)

    def test_cache_layouts(self):
        for arch, kind in (("granite-3-8b", "kv"), ("musicgen-large", "kv"), ("llama4-scout-17b-a16e", "kv"),
                           ("llama-3.2-vision-11b", "kv+x")):
            cfg = port_config(arch)
            m = port_build(cfg)
            dims, struct = m.cache_dims(), m.cache_struct(2, 4608)
            assert dims["kind"] == kind
            assert struct["k"] == ((dims["n_kv_layers"], 2, 4608, cfg.n_kv_heads, cfg.hd), torch.bfloat16)
            if kind == "kv+x":
                assert dims == {"kind": "kv+x", "n_kv_layers": 32, "n_cross": 8}
                assert struct["xk"] == ((8, 2, 1601, 8, 128), torch.bfloat16)
            else:
                assert "xk" not in struct and dims["n_kv_layers"] == cfg.n_layers
