"""The port's token engine against the reference package's, on the CPU.

Both engines serve the same requests (3 prompts of mixed length over 2
slots, so a slot is reused) on the same numpy weights, in float32, and must
return the same greedy tokens: argmax is exact wherever the top-2 logits
differ by more than the packages' ~1e-5 disagreement (tests/test_torch_ssm_models.py).
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

ARCHS = ["falcon-mamba-7b", "zamba2-1.2b"]
PROMPTS = [(7, 6), (11, 4), (7, 5)]  # (prompt length, max_tokens)


def _requests(cls, vocab: int, **kw):
    rng = np.random.default_rng(11)
    return [cls(rid=i, prompt=rng.integers(0, vocab, n).astype(np.int32), max_tokens=m, **kw)
            for i, (n, m) in enumerate(PROMPTS)]


@pytest.fixture(scope="module", params=ARCHS)
def engines(request):
    arch = request.param
    jcfg = dataclasses.replace(jax_config(arch).reduced(), dtype="float32")
    tcfg = dataclasses.replace(port_config(arch).reduced(), dtype="float32")
    tm = port_build(tcfg)
    weights = tm.init_numpy(21)
    jeng = JaxEngine(jax_build(jcfg), jax.tree.map(jnp.asarray, weights), slots=2, max_len=32)
    teng = Engine(tm, params_from_numpy(tcfg, weights, "cpu"), slots=2, max_len=32, device="cpu")
    for r in _requests(JaxRequest, jcfg.vocab_size):
        jeng.submit(r)
    for r in _requests(Request, tcfg.vocab_size):
        teng.submit(r)
    jdone = {r.rid: [int(t) for t in r.generated] for r in jeng.run()}
    tdone = {r.rid: list(r.generated) for r in teng.run()}
    return tcfg, tm, weights, jdone, tdone


class TestEngine:
    def test_greedy_tokens_match_the_reference_engine(self, engines):
        _, _, _, jdone, tdone = engines
        assert sorted(tdone) == [0, 1, 2]
        assert tdone == jdone
        assert [len(tdone[i]) for i in range(3)] == [m for _, m in PROMPTS]

    def test_recurrent_families_keep_exact_prefill(self, engines):
        tcfg, tm, weights, _, _ = engines
        eng = Engine(tm, params_from_numpy(tcfg, weights, "cpu"), slots=1, max_len=16, device="cpu")
        assert not eng._bucket_prompts  # the SSM state would absorb padding

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
