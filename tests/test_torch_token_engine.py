"""The port's token engine against the reference package's, on the CPU.

Both engines serve the same requests (3 prompts of mixed length over 2
slots, so a slot is reused) on the same numpy weights, in float32, and must
return the same greedy tokens: argmax is exact wherever the top-2 logits
differ by more than the packages' ~1e-5 disagreement (tests/test_torch_ssm_models.py,
tests/test_torch_lm_models.py).  The prompts (7 and 11 tokens) are not powers
of two, so the kv-cache families prefill them right-padded to buckets of 8
and 16; the recurrent families prefill them at their length.  An audio
request's prompt is [S, ncb] and each step gives one token a codebook.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models.model import build_model as jax_build
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch.configs import get_config as port_config
from repro_torch.models.model import build_model as port_build
from repro_torch.models.model import params_from_numpy
from repro_torch.serving import Engine, Request

RECURRENT_FAMILIES = ("ssm", "hybrid")

RECURRENT = ["falcon-mamba-7b", "zamba2-1.2b"]
ARCHS = RECURRENT + ["granite-3-8b", "musicgen-large", "llama-3.2-vision-11b", "llama4-scout-17b-a16e"]
PROMPTS = [(7, 6), (11, 4), (7, 5)]  # (prompt length, max_tokens)


def _requests(cls, cfg, **kw):
    rng = np.random.default_rng(11)
    tail = (cfg.audio.n_codebooks,) if cfg.audio else ()
    return [cls(rid=i, prompt=rng.integers(0, cfg.vocab_size, (n,) + tail).astype(np.int32), max_tokens=m, **kw)
            for i, (n, m) in enumerate(PROMPTS)]


def _tokens(generated) -> list:
    """Generated tokens as ints, or lists of ints (one a codebook)."""
    return [np.asarray(t).tolist() for t in generated]


def _weights(model, seed: int) -> dict:
    """``init_numpy(seed)``, with the vision cross layers' gates off 0."""
    w = model.init_numpy(seed)
    if "cross_layers" in w:
        for g in ("attn_gate", "mlp_gate"):
            w["cross_layers"][g] = np.full(w["cross_layers"][g].shape, 0.5, np.float32)
    return w


@pytest.fixture(scope="module", params=ARCHS)
def engines(request):
    arch = request.param
    jcfg = dataclasses.replace(jax_config(arch).reduced(), dtype="float32")
    tcfg = dataclasses.replace(port_config(arch).reduced(), dtype="float32")
    tm = port_build(tcfg)
    weights = _weights(tm, 21)
    jeng = JaxEngine(jax_build(jcfg), jax.tree.map(jnp.asarray, weights), slots=2, max_len=32)
    teng = Engine(tm, params_from_numpy(tcfg, weights, "cpu"), slots=2, max_len=32, device="cpu")
    prefills = []  # (prompt tokens the model saw, length=) of each port prefill
    prefill = tm.prefill

    def spy(params, tokens, **kw):
        prefills.append((tokens.shape[1], kw.get("length")))
        return prefill(params, tokens, **kw)

    teng.model = dataclasses.replace(tm)
    teng.model.prefill = spy
    for r in _requests(JaxRequest, jcfg):
        jeng.submit(r)
    for r in _requests(Request, tcfg):
        teng.submit(r)
    jdone = {r.rid: _tokens(r.generated) for r in jeng.run()}
    tdone = {r.rid: _tokens(r.generated) for r in teng.run()}
    return tcfg, tm, weights, jdone, tdone, prefills


class TestEngine:
    def test_greedy_tokens_match_the_reference_engine(self, engines):
        tcfg, _, _, jdone, tdone, _ = engines
        assert sorted(tdone) == [0, 1, 2]
        assert tdone == jdone
        assert [len(tdone[i]) for i in range(3)] == [m for _, m in PROMPTS]
        if tcfg.audio:
            assert all(len(t) == tcfg.audio.n_codebooks for t in tdone[0])

    def test_recurrent_families_keep_exact_prefill(self, engines):
        tcfg, tm, weights, _, _, prefills = engines
        eng = Engine(tm, params_from_numpy(tcfg, weights, "cpu"), slots=1, max_len=16, device="cpu")
        if tcfg.family in RECURRENT_FAMILIES:
            assert not eng._bucket_prompts  # the SSM state would absorb padding
            assert prefills == [(7, None), (11, None), (7, None)]
        else:  # the kv-cache families: right-padded to the next power of two, at least 8
            assert eng._bucket_prompts
            assert prefills == [(8, 7), (16, 11), (8, 7)]

    def test_bucket_is_capped_at_max_len(self):
        cfg = dataclasses.replace(port_config("granite-3-8b").reduced(), dtype="float32")
        m = port_build(cfg)
        params = m.init(seed=2, device="cpu")
        eng = Engine(m, params, slots=1, max_len=12, device="cpu")
        seen = []
        prefill = m.prefill
        eng.model = dataclasses.replace(m)
        eng.model.prefill = lambda p, t, **kw: seen.append(t.shape[1]) or prefill(p, t, **kw)
        eng.submit(Request(rid=0, prompt=np.arange(9), max_tokens=2))
        (req,) = eng.run()
        assert seen == [12] and len(req.generated) == 2
        full, _, _ = m.forward(params, torch.arange(9)[None])
        assert req.generated[0] == int(full[0, -1].argmax())

    def test_audio_eos_is_all_codebooks(self):
        """With the final norm at 0 every logit is 0, so every token is 0 in
        each codebook: eos 0 stops a request at its first decoded token."""
        cfg = dataclasses.replace(port_config("musicgen-large").reduced(), dtype="float32")
        m = port_build(cfg)
        params = m.init(seed=3, device="cpu")
        params["final_norm"] = torch.zeros_like(params["final_norm"])
        eng = Engine(m, params, slots=1, max_len=32, device="cpu")
        eng.submit(Request(rid=0, prompt=np.zeros((5, 2), np.int64), max_tokens=6, eos=0))
        eng.submit(Request(rid=1, prompt=np.zeros((5, 2), np.int64), max_tokens=4, eos=1))
        done = {r.rid: _tokens(r.generated) for r in eng.run()}
        assert done == {0: [[0, 0], [0, 0]], 1: [[0, 0]] * 4}

    def test_engine_weights_are_cast_once(self):
        cfg = port_config("zamba2-1.2b").reduced()  # bf16 activations, fp32 weights
        m = port_build(cfg)
        eng = Engine(m, m.init(seed=0, device="cpu"), slots=1, max_len=16, device="cpu")
        assert eng.params["layers"]["in_proj"].dtype == torch.bfloat16
        assert eng.params["layers"]["A_log"].dtype == torch.float32
        eng.submit(Request(rid=0, prompt=np.arange(5), max_tokens=3))
        (req,) = eng.run()
        assert len(req.generated) == 3 and all(0 <= t < cfg.vocab_size for t in req.generated)
        assert req.t_admit <= req.t_first <= req.t_done

    def test_sampling_is_seeded_per_request_and_position(self):
        cfg = dataclasses.replace(port_config("falcon-mamba-7b").reduced(), dtype="float32")
        m = port_build(cfg)
        params = m.init(seed=1, device="cpu")

        def serve():
            eng = Engine(m, params, slots=2, max_len=32, device="cpu")
            for rid in range(3):
                eng.submit(Request(rid=rid, prompt=np.arange(6), max_tokens=8, temperature=5.0, seed=3))
            return {r.rid: r.generated for r in eng.run()}

        a, b = serve(), serve()
        assert a == b  # deterministic replay
        assert len({tuple(v) for v in a.values()}) == 3  # same seed, different rid: different streams

    def test_eos_frees_the_slot(self):
        cfg = dataclasses.replace(port_config("falcon-mamba-7b").reduced(), dtype="float32")
        m = port_build(cfg)
        params = m.init(seed=1, device="cpu")
        eng = Engine(m, params, slots=1, max_len=32, device="cpu")
        eng.submit(Request(rid=0, prompt=np.arange(4), max_tokens=6))
        first = eng.run()[0].generated
        eng = Engine(m, params, slots=1, max_len=32, device="cpu")
        eng.submit(Request(rid=0, prompt=np.arange(4), max_tokens=6, eos=first[2]))
        eng.submit(Request(rid=1, prompt=np.arange(4), max_tokens=2))
        done = {r.rid: r.generated for r in eng.run()}
        # as in the reference engine, eos is looked for in decoded tokens (not the prefill's)
        stop = next(i for i in range(1, len(first)) if first[i] == first[2])
        assert done[0] == first[:stop + 1] and len(done[1]) == 2

    def test_engine_needs_a_device_without_cuda(self):
        cfg = port_config("falcon-mamba-7b").reduced()
        m = port_build(cfg)
        params = m.init(seed=0, device="cpu")
        if torch.cuda.is_available():
            return
        for call in (lambda: Engine(m, params), lambda: m.init(seed=0), lambda: m.init_cache(1, 8),
                     lambda: params_from_numpy(cfg, m.init_numpy(0))):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
