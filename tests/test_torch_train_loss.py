"""The port's training loss against the reference on the CPU: ``xent_loss``
and ``chunked_xent`` (values and grads, audio labels, ``ignore``), the MoE
aux terms that ``forward`` now returns, and ``Model.loss`` with its
gradients for the four transformer families in float32.

Both packages get the same numpy weights (``Model.init_numpy``, the vision
cross gates moved off 0, which would zero the cross path) and the same
batches.  Tolerances: the loss within rtol 1e-5; each leaf's gradient within
1e-4 of that leaf's norm; the cross-entropy helpers' values and grads within
rtol 1e-5 (atol 1e-7 for grads near zero).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import transformer as jax_T
from repro.models.model import build_model as jax_build
from repro_torch import tree as tu
from repro_torch.configs import get_config as port_config
from repro_torch.models import transformer as port_T
from repro_torch.models.model import build_model as port_build
from repro_torch.models.model import params_from_numpy

# (arch, reduced layer count): the vlm at 2 layers is one group, a self and a cross layer
ARCHS = [("granite-3-8b", 2), ("musicgen-large", 2), ("llama-3.2-vision-11b", 2), ("llama4-scout-17b-a16e", 1)]


def _cfgs(arch: str, n_layers: int, **kw):
    kw = dict(dtype="float32", n_layers=n_layers, **kw)
    return (dataclasses.replace(jax_config(arch).reduced(), **kw),
            dataclasses.replace(port_config(arch).reduced(), **kw))


def _weights(model, seed: int = 0) -> dict:
    w = model.init_numpy(seed)
    if "cross_layers" in w:
        rng = np.random.default_rng(seed + 100)
        for g in ("attn_gate", "mlp_gate"):
            w["cross_layers"][g] = rng.uniform(0.3, 0.9, w["cross_layers"][g].shape).astype(np.float32)
    return w


def _batch(cfg, B: int = 2, S: int = 32, seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    shape = (B, S) + ((cfg.audio.n_codebooks,) if cfg.audio else ())
    labels = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    labels[0, :3] = -1  # ignored tokens
    batch = {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(np.int32), "labels": labels}
    if cfg.vision:
        batch["vision"] = rng.standard_normal((B, cfg.vision.n_patches, cfg.vision.d_vision)).astype(np.float32)
    return batch


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype != np.float32 else torch.from_numpy(v) for k, v in batch.items()}


# --------------------------------------------------------------------------- #
# cross-entropy
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("audio", [False, True], ids=["tokens", "codebooks"])
def test_xent_loss_value_and_grad(audio):
    rng = np.random.default_rng(3)
    shape = (2, 12, 3) if audio else (2, 12)
    logits = (4 * rng.standard_normal(shape + (50,))).astype(np.float32)
    labels = rng.integers(0, 50, shape).astype(np.int32)
    labels[1, 2:5] = -1
    jv, jg = jax.value_and_grad(lambda x: jax_T.xent_loss(x, jnp.asarray(labels)))(jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_(True)
    tv = port_T.xent_loss(t, torch.from_numpy(labels))
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-7)


def test_xent_loss_all_ignored_is_zero():
    logits = torch.randn(2, 4, 7, generator=torch.Generator().manual_seed(0))
    assert float(port_T.xent_loss(logits, torch.full((2, 4), -1))) == 0.0


@pytest.mark.parametrize("arch,chunk", [("granite-3-8b", 8), ("granite-3-8b", 7), ("musicgen-large", 16)])
def test_chunked_xent_matches_reference_and_full_logits(arch, chunk):
    """Value and grads (h, the head, the final norm) against the reference's
    ``chunked_xent``, and equal to ``xent_loss`` on full logits.  A chunk of
    7 does not divide S = 32 and falls to 4, as the reference's does."""
    jcfg, tcfg = _cfgs(arch, 1)
    w = _weights(port_build(tcfg))
    head = {k: w[k] for k in ("lm_head", "final_norm")}
    batch = _batch(tcfg)
    h = np.random.default_rng(4).standard_normal((2, 32, tcfg.d_model)).astype(np.float32)

    def jloss(hh, p):
        return jax_T.chunked_xent(jcfg, p, hh, jnp.asarray(batch["labels"]), chunk=chunk)

    jv, (jgh, jgp) = jax.value_and_grad(jloss, (0, 1))(jnp.asarray(h), jax.tree.map(jnp.asarray, head))
    th = torch.from_numpy(h).requires_grad_(True)
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in head.items()}
    labels = torch.from_numpy(batch["labels"])
    tv = port_T.chunked_xent(tcfg, tp, th, labels, chunk=chunk)
    tv.backward()
    full = port_T.xent_loss(port_T.lm_logits(tcfg, tp, th), labels)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    np.testing.assert_allclose(float(tv.detach()), float(full.detach()), rtol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh), rtol=1e-5, atol=1e-7)
    for k in head:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jgp[k]), rtol=1e-5, atol=1e-7, err_msg=k)


# --------------------------------------------------------------------------- #
# Model.loss and its gradients
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def reference_losses():
    """{arch: (weights, batch, loss, metrics, grads)} from the reference, once."""
    out = {}
    for arch, n_layers in ARCHS:
        jcfg, tcfg = _cfgs(arch, n_layers)
        w = _weights(port_build(tcfg))
        batch = _batch(tcfg)
        jm = jax_build(jcfg)
        (loss, metrics), grads = jax.value_and_grad(
            lambda p: jm.loss(p, jax.tree.map(jnp.asarray, batch)), has_aux=True)(jax.tree.map(jnp.asarray, w))
        out[arch] = (w, batch, float(loss), {k: float(v) for k, v in metrics.items()},
                     dict(tu.leaves_with_path(jax.tree.map(np.asarray, grads))))
    return out


def _port_loss(arch: str, n_layers: int, w: dict, batch: dict, remat: str = "none"):
    _, tcfg = _cfgs(arch, n_layers, remat=remat)
    live = tu.tree_map(lambda p: p.requires_grad_(True), params_from_numpy(tcfg, w, "cpu"))
    total, metrics = port_build(tcfg).loss(live, _torch_batch(batch))
    grads = torch.autograd.grad(total, tu.leaves(live))
    return float(total.detach()), {k: float(v) for k, v in metrics.items()}, dict(zip((p for p, _ in tu.leaves_with_path(live)),
                                                                              grads))


@pytest.mark.parametrize("arch,n_layers", ARCHS)
def test_model_loss_and_grads_match_reference(arch, n_layers, reference_losses):
    w, batch, jloss, jmetrics, jgrads = reference_losses[arch]
    loss, metrics, grads = _port_loss(arch, n_layers, w, batch)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert set(metrics) == set(jmetrics) == {"loss", "moe_aux", "moe_z", "tokens"}
    for k in metrics:
        np.testing.assert_allclose(metrics[k], jmetrics[k], rtol=1e-5, err_msg=k)
    if arch.startswith("llama4"):
        assert metrics["moe_aux"] > 0 and metrics["moe_z"] > 0
    assert set(grads) == set(jgrads)
    for path, g in grads.items():
        want = jgrads[path]
        err = float(np.max(np.abs(g.numpy() - want)))
        assert err <= 1e-4 * max(float(np.linalg.norm(want)), 1e-12), (path, err, float(np.linalg.norm(want)))


@pytest.mark.parametrize("arch,n_layers", ARCHS)
def test_remat_modes_give_equal_grads(arch, n_layers, reference_losses):
    w, batch, _, _, _ = reference_losses[arch]
    loss0, _, g0 = _port_loss(arch, n_layers, w, batch, "none")
    for mode in ("full", "dots"):
        loss, _, g = _port_loss(arch, n_layers, w, batch, mode)
        assert loss == loss0, mode
        for path in g0:
            np.testing.assert_allclose(g[path].numpy(), g0[path].numpy(), rtol=1e-6, atol=1e-9, err_msg=f"{mode} {path}")


def test_remat_recomputes_attention_in_the_backward(monkeypatch):
    """"full" runs each layer's forward again in the backward (the attention
    op once more a layer); "none" does not."""
    from repro_torch.kernels import flash_attention as fa

    calls = []
    real = fa.reference_attention
    monkeypatch.setattr(fa, "reference_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    _, tcfg = _cfgs("granite-3-8b", 2)
    w = _weights(port_build(tcfg))
    batch = _batch(tcfg)
    for mode, want in (("none", 2), ("full", 4)):
        calls.clear()
        _port_loss("granite-3-8b", 2, w, batch, mode)
        assert len(calls) == want, mode


def test_forward_returns_the_moe_aux_means():
    jcfg, tcfg = _cfgs("llama4-scout-17b-a16e", 2)
    w = _weights(port_build(tcfg))
    tokens = _batch(tcfg)["tokens"]
    _, jaux, _ = jax_build(jcfg).forward(jax.tree.map(jnp.asarray, w), jnp.asarray(tokens))
    with torch.no_grad():
        _, taux, _ = port_build(tcfg).forward(params_from_numpy(tcfg, w, "cpu"), torch.from_numpy(tokens).long())
    for k in ("moe_aux", "moe_z"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-5, err_msg=k)
    _, dense_cfg = _cfgs("granite-3-8b", 1)
    with torch.no_grad():
        _, aux, _ = port_build(dense_cfg).forward(params_from_numpy(dense_cfg, _weights(port_build(dense_cfg)), "cpu"),
                                                  torch.from_numpy(tokens).long())
    assert float(aux["moe_aux"]) == float(aux["moe_z"]) == 0.0
