"""The Model API: ``build_model(cfg) -> Model`` with ``forward`` / ``prefill``
/ ``decode_step`` over a dict of stacked ``[L, ...]`` parameter tensors, for
every family of the zoo: dense, audio (codebooks), moe, vlm (cross-attention
to vision patches), ssm (falcon-mamba, Mamba1) and hybrid (zamba2, Mamba2 with
a shared attention block).

Against the reference's structure:
  * the scan over layers is a Python loop over views of the stacked tensors;
  * the vlm stack runs, per group, its ``cross_attn_every - 1`` self layers and
    then its cross layer, whose residuals are scaled by ``tanh`` of its gates;
  * the zamba2 shared block runs after every ``attn_every``-th Mamba2 layer,
    and layers past the last multiple (zamba2's 2 of 38) form a tail with no
    block after them;
  * the scan kernels return their final state, so :meth:`Model.prefill`
    collects the conv windows and states in the forward itself, with no second
    pass over the prompt;
  * :meth:`Model.forward` returns (out, aux, caches) as the reference does,
    ``aux`` holding the MoE layers' mean load-balance and z losses (0 for the
    other families); with gradients on, each layer body runs under
    ``cfg.remat`` (:func:`_remat`: ``torch.utils.checkpoint``): every self
    layer and every SSM layer, not the vlm's cross layers nor the hybrid's
    shared block, as in the reference;
  * :meth:`Model.loss` is every family's training loss;
  * weights are cast to the compute dtype by :meth:`Model.precast`, once at
    load (the serving engine calls it); the functions below cast only leaves
    still in float32, which a precast tree no longer has;
  * :meth:`Model.decode_step` updates the cache it is given in place, which
    keeps one copy of the multi-GB cache;
  * ``mesh=`` (a ``DeviceMesh``) runs a method on DTensors: the parameters,
    inputs and caches laid out by :meth:`Model.specs`,
    ``launch.specs.batch_specs`` and :meth:`Model.cache_specs`, with the
    reference's ``constrain`` points as redistributions and plain tensors
    (positions, masks) taken as replicated.  Without a mesh nothing changes.

Cache layouts are the reference's: ``k``/``v [n_kv_layers, B, max_len, KV, hd]``,
``xk``/``xv [n_cross, B, n_patches, KV, hd]`` (vlm), ``conv [L, B, K-1, C]``,
``state [L, B, ...]`` fp32, ``len [B]``.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.configs.base import ModelConfig
from repro_torch.instrument import note_loop
from repro_torch.kernels import runtime
from repro_torch.models import defs as D
from repro_torch.models import ssm_models as S
from repro_torch.models import transformer as T
from repro_torch.models.layers import apply_rope, attention, decode_attention, mlp_act, mm, rms_norm, write_at
from repro_torch.models.sharding import axis_names, constrain, fsdp_axes_for, logical_to_spec, param_specs, \
    repair_spec, reshape
from repro_torch.models.sharding import pad as pad_zeros

# numerics-sensitive leaves stay fp32; everything else is cast to the compute dtype
_KEEP_F32 = {"norm", "ln1", "ln2", "norm_g", "final_norm", "A_log", "dt_bias",
             "D", "conv_b", "conv_w", "attn_gate", "mlp_gate", "router"}


# the products whose outputs "dots" keeps (everything else is recomputed)
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.baddbmm.default}


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def _remat(fn, mode: str):
    """``fn`` checkpointed as ``cfg.remat`` says: "full" saves only its
    inputs and recomputes the body in the backward, "dots" also saves the
    outputs of its matrix products, "none" saves everything."""
    if mode == "none":
        return fn
    if mode not in ("full", "dots"):
        raise ValueError(f"remat {mode!r}: expected full, dots or none")
    kw = dict(context_fn=_dots_context) if mode == "dots" else {}
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, **kw)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def cast_layer_params(cfg: ModelConfig, tree: dict) -> dict:
    dt = _dtype(cfg)
    return {k: v if k in _KEEP_F32 or v.dtype != torch.float32 else v.to(dt) for k, v in tree.items()}


def _precast(cfg: ModelConfig, params: dict) -> dict:
    out = dict(params)
    for key in ("layers", "shared", "cross_layers"):
        if key in params:
            out[key] = cast_layer_params(cfg, params[key])
    if params["lm_head"].dtype == torch.float32:
        out["lm_head"] = params["lm_head"].to(_dtype(cfg))
    return out


def _layer(layers: dict, i: int) -> dict:
    return {k: v[i] for k, v in layers.items()}


@contextlib.contextmanager
def on_mesh(mesh):
    """The context a method runs in: on a mesh, plain tensors (positions,
    masks, constants) mix with DTensors as replicated ones (DTensor's
    ``implicit_replication``, here reentrant: a nested exit restores the
    outer setting)."""
    if mesh is None:
        yield
        return
    from torch.distributed.tensor import DTensor

    disp = DTensor._op_dispatcher
    prev = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = prev


_BATCH_D = (("pod", "data"), None, "model")  # the residual stream's constrain point


# --------------------------------------------------------------------------- #
# zamba2 shared attention block (full sequence + decode)
# --------------------------------------------------------------------------- #


def _shared_mlp(cfg: ModelConfig, sp: dict, h: torch.Tensor) -> torch.Tensor:
    x2 = rms_norm(h, sp["ln2"], cfg.norm_eps)
    g = mm("bsd,df->bsf", x2, sp["w_gate"])
    u = mm("bsd,df->bsf", x2, sp["w_up"])
    return h + mm("bsf,fd->bsd", mlp_act(g, u, "swiglu"), sp["w_down"])


def _shared_qkv(cfg: ModelConfig, sp: dict, h, h0, positions):
    x = rms_norm(torch.cat([h, h0], -1), sp["ln1"], cfg.norm_eps)
    q = apply_rope(mm("bsd,dhk->bshk", x, sp["wq"]), positions, cfg.rope_theta)
    k = apply_rope(mm("bsd,dhk->bshk", x, sp["wk"]), positions, cfg.rope_theta)
    return q, k, mm("bsd,dhk->bshk", x, sp["wv"])


def _shared_block(cfg: ModelConfig, sp: dict, h, h0, positions, mesh=None):
    """Full-sequence shared block on concat(h, h0).  Returns (h_new, (k, v))."""
    q, k, v = _shared_qkv(cfg, sp, h, h0, positions)
    q = constrain(q, mesh, ("pod", "data"), None, "model", None)
    o = attention(q, k, v, causal=True)
    h = h + mm("bshk,hkd->bsd", o, reshape(sp["wo"], cfg.n_heads, cfg.hd, -1))
    return _shared_mlp(cfg, sp, h), (k, v)


def _shared_block_decode(cfg: ModelConfig, sp: dict, h, h0, k_cache, v_cache, lens, mesh=None, seq_shard=False):
    """One token at position ``lens``; writes its k, v into the caches
    ([B, max_len, KV, hd] views) in place."""
    B = h.shape[0]
    q, k, v = _shared_qkv(cfg, sp, h, h0, lens.reshape(B, 1))
    write_at(k_cache, lens, k[:, 0])
    write_at(v_cache, lens, v[:, 0])
    cache_axes = (None, ("pod", "data"), "model", None) if seq_shard else (("pod", "data"), None, "model", None)
    k_cache = constrain(k_cache, mesh, *cache_axes)
    v_cache = constrain(v_cache, mesh, *cache_axes)
    o = decode_attention(q.transpose(1, 2), k_cache.transpose(1, 2).to(q.dtype),
                         v_cache.transpose(1, 2).to(q.dtype), lens + 1)
    h = h + mm("bshk,hkd->bsd", o.transpose(1, 2), reshape(sp["wo"], cfg.n_heads, cfg.hd, -1))
    return _shared_mlp(cfg, sp, h)


# --------------------------------------------------------------------------- #
# Model
# --------------------------------------------------------------------------- #


@dataclass
class Model:
    cfg: ModelConfig

    # ------------------------------------------------------------- params --
    def param_defs(self) -> dict:
        cfg = self.cfg
        if cfg.family in ("dense", "audio", "vlm", "moe"):
            defs = T.transformer_defs(cfg)
        elif cfg.family in ("ssm", "hybrid"):
            defs = {
                "embed": D.ParamDef((1, cfg.vocab_size, cfg.d_model), (None, "vocab", "embed"), "embed", 0.02),
                "final_norm": D.ParamDef((cfg.d_model,), (None,), "ones"),
                "lm_head": D.ParamDef((1, cfg.d_model, cfg.vocab_size), (None, "embed", "vocab")),
            }
            if cfg.family == "ssm":
                defs["layers"] = S.mamba1_defs(cfg)
            else:
                defs["layers"] = S.mamba2_defs(cfg, cfg.n_layers)
                defs["shared"] = S.shared_block_defs(cfg)
        else:
            raise ValueError(cfg.family)
        if cfg.param_dtype != "float32":
            # weight matrices stored reduced-precision; norms, biases and SSM
            # constants stay fp32
            pd = getattr(torch, cfg.param_dtype)
            defs = D.map_defs(lambda d: D.ParamDef(d.shape, d.axes, d.init, d.scale, pd)
                              if d.init in ("normal", "embed") else d, defs)
        return defs

    def init(self, seed: int = 0, device=None) -> dict:
        """Random weights drawn on ``device`` (None: the card) from
        ``torch.Generator(device).manual_seed(seed)``."""
        dev = runtime.resolve_device(device)
        return D.init_params(self.param_defs(), torch.Generator(device=dev).manual_seed(seed), dev)

    def init_numpy(self, seed: int = 0) -> dict:
        """Random weights as numpy arrays from ``np.random.default_rng(seed)``
        (the same arrays can be fed to the reference package)."""
        return D.init_numpy(self.param_defs(), seed)

    def param_count(self) -> int:
        return D.param_count(self.param_defs())

    def abstract_params(self) -> dict:
        """The parameter tree as tensors on the ``meta`` device: shapes and
        dtypes, nothing drawn or allocated."""
        return D.map_defs(lambda d: torch.empty(d.shape, dtype=d.dtype, device="meta"), self.param_defs())

    def specs(self, mesh, fsdp_axes=None):
        """The Spec tree of the parameters on ``mesh`` (``sharding.param_specs``)."""
        if fsdp_axes is None:
            fsdp_axes = self.fsdp_axes()
        return param_specs(self.param_defs(), mesh, fsdp_axes)

    def fsdp_axes(self) -> tuple:
        return fsdp_axes_for(self.cfg)

    def precast(self, params: dict) -> dict:
        """The tree with every leaf outside ``_KEEP_F32``, and the LM head, in
        the compute dtype.  Call once at load; the other methods then cast
        nothing."""
        return _precast(self.cfg, params)

    # ------------------------------------------------------------ forward --
    def forward(self, params: dict, tokens: torch.Tensor, *, vision: Optional[torch.Tensor] = None, mesh=None,
                collect_cache: bool = False, head: bool = True):
        """Full-sequence forward.  tokens [B, S], or [B, S, ncb] for audio;
        ``vision`` [B, n_patches, d_vision] for the vlm family.  Returns
        (logits [B, S, (ncb,) V], aux, caches) or, with ``head=False``, (hidden
        [B, S, d], aux, caches).  ``aux`` is {"moe_aux", "moe_z"}: the mean
        over the MoE layers of their load-balance and z losses, 0 for the other
        families.  With ``collect_cache`` the caches hold each attention
        layer's k and v [L, B, S, KV, hd], the vlm's cross layers' vision k and
        v (``xk``, ``xv``), and each SSM layer's conv window and final state
        (``conv``, ``state``).  With gradients on and no cache collected, each
        layer body runs under ``cfg.remat`` (the vlm's cross layers and the
        hybrid's shared block do not, as in the reference)."""
        with on_mesh(mesh):
            return self._forward(params, tokens, vision, mesh, collect_cache, head)

    def _forward(self, params, tokens, vision, mesh, collect_cache, head):
        cfg = self.cfg
        dt = _dtype(cfg)
        B, Sq = tokens.shape[:2]
        params = _precast(cfg, params)
        h = T.embed_tokens(cfg, params, tokens, dt)
        h = constrain(h, mesh, *_BATCH_D)
        positions = torch.arange(Sq, device=h.device).expand(B, Sq)
        convs, states, ks, vs, xks, xvs, las, lzs = [], [], [], [], [], [], [], []
        remat = cfg.remat if torch.is_grad_enabled() and not collect_cache else "none"

        def self_body(lp, h):
            a, (k, v) = T.self_attn_block(cfg, lp, h, positions, mesh)
            h = h + a
            if cfg.family == "moe":
                m, la, lz = T.moe_block(cfg, lp, h, mesh)
                return constrain(h + m, mesh, *_BATCH_D), k, v, la, lz
            h = h + T.mlp_block(cfg, lp, h, mesh)
            return (h if cfg.family == "vlm" else constrain(h, mesh, *_BATCH_D)), k, v

        body = _remat(self_body, remat)

        def self_layer(lp, h):
            out = body(lp, h)
            if cfg.family == "moe":
                las.append(out[3])
                lzs.append(out[4])
            if collect_cache:
                ks.append(out[1])
                vs.append(out[2])
            return out[0]

        if cfg.family in ("dense", "audio", "moe"):
            note_loop("layers", cfg.n_layers)
            for i in range(cfg.n_layers):
                h = self_layer(_layer(params["layers"], i), h)
        elif cfg.family == "vlm":
            every = cfg.vision.cross_attn_every
            vis = mm("bpe,ed->bpd", vision.to(dt), params["patch_proj"])
            note_loop("groups", cfg.n_layers // every)
            note_loop("self_layers", every - 1)
            for g in range(cfg.n_layers // every):
                for j in range(every - 1):
                    h = self_layer(_layer(params["layers"], g * (every - 1) + j), h)
                clp = _layer(params["cross_layers"], g)
                kv_k, kv_v = T.vision_kv(cfg, clp, vis)
                h = constrain(_cross_layer(cfg, clp, h, kv_k, kv_v, mesh), mesh, *_BATCH_D)
                if collect_cache:
                    xks.append(kv_k)
                    xvs.append(kv_v)
        elif cfg.family in ("ssm", "hybrid"):
            ssm_layer = S.mamba1_layer if cfg.family == "ssm" else S.mamba2_layer
            ssm_body = _remat(lambda lp, h: ssm_layer(cfg, lp, h, cache=False, mesh=mesh), remat)
            h0 = h
            if cfg.family == "hybrid":
                k_every = cfg.hybrid.attn_every
                note_loop("groups", cfg.n_layers // k_every)
                note_loop("ssm_layers", k_every)
                if cfg.n_layers % k_every:
                    note_loop("tail", cfg.n_layers % k_every)
            else:
                note_loop("layers", cfg.n_layers)
            for i in range(cfg.n_layers):
                lp = _layer(params["layers"], i)
                if collect_cache:
                    h, (cb, st) = ssm_layer(cfg, lp, h, mesh=mesh)
                    convs.append(cb)
                    states.append(st)
                else:
                    h = ssm_body(lp, h)
                # the hybrid's shared block (outside remat), none after the tail past the last multiple
                if cfg.family == "hybrid" and (i + 1) % cfg.hybrid.attn_every == 0:
                    h, (k, v) = _shared_block(cfg, params["shared"], h, h0, positions, mesh)
                    h = constrain(h, mesh, *_BATCH_D)
                    if collect_cache:
                        ks.append(k)
                        vs.append(v)
        else:
            raise ValueError(cfg.family)
        caches = {}
        if collect_cache:
            for key, xs in (("conv", convs), ("state", states), ("k", ks), ("v", vs), ("xk", xks), ("xv", xvs)):
                if xs:
                    caches[key] = torch.stack(xs)
        zero = h.new_zeros((), dtype=torch.float32)  # on a mesh a replicated DTensor, as the loss is
        aux = {"moe_aux": torch.stack(las).mean() if las else zero, "moe_z": torch.stack(lzs).mean() if lzs else zero}
        if not head:
            return h, aux, caches
        return T.lm_logits(cfg, params, h, mesh), aux, caches

    # --------------------------------------------------------------- loss --
    def loss(self, params: dict, batch: dict, *, mesh=None):
        """The training loss of a batch {"tokens", "labels"[, "vision"]} of
        tensors: the mean token cross-entropy (``chunked_xent``, chunks of
        ``max(256, S // 4)``) plus 0.01 x the MoE load-balance loss and 1e-3 x
        its z-loss.  ``params`` are the float32 masters; the cast to the
        compute dtype happens inside, so gradients reach the float32 leaves.
        Returns (total, {"loss", "moe_aux", "moe_z", "tokens"})."""
        cfg = self.cfg
        h, aux, _ = self.forward(params, batch["tokens"], vision=batch.get("vision"), mesh=mesh, head=False)
        with on_mesh(mesh):
            chunk = max(256, h.shape[1] // 4)
            note_loop("xent_chunks", -(-h.shape[1] // min(chunk, h.shape[1])))
            loss = T.chunked_xent(cfg, params, h, batch["labels"], chunk=chunk, mesh=mesh)
            total = loss + 0.01 * aux["moe_aux"] + 1e-3 * aux["moe_z"]
            metrics = {"loss": loss, "moe_aux": aux["moe_aux"], "moe_z": aux["moe_z"],
                       "tokens": torch.tensor(float(np.prod(batch["labels"].shape)), device=h.device)}
        return total, metrics

    # ------------------------------------------------------------ caching --
    def cache_dims(self) -> dict:
        cfg = self.cfg
        if cfg.family in ("dense", "audio", "moe"):
            return {"kind": "kv", "n_kv_layers": cfg.n_layers}
        if cfg.family == "vlm":
            k = cfg.vision.cross_attn_every
            return {"kind": "kv+x", "n_kv_layers": cfg.n_layers - cfg.n_layers // k, "n_cross": cfg.n_layers // k}
        if cfg.family == "ssm":
            return {"kind": "ssm", "n_ssm_layers": cfg.n_layers}
        return {"kind": "hybrid", "n_ssm_layers": cfg.n_layers,
                "n_kv_layers": cfg.n_layers // cfg.hybrid.attn_every}

    def cache_struct(self, B: int, max_len: int) -> dict:
        """name -> (shape, dtype) of the decode cache."""
        cfg = self.cfg
        dt = _dtype(cfg)
        KV, hd = cfg.n_kv_heads, cfg.hd
        dims = self.cache_dims()
        out = {"len": ((B,), torch.int64)}
        if "n_kv_layers" in dims:
            kv = (dims["n_kv_layers"], B, max_len, KV, hd)
            out["k"], out["v"] = (kv, dt), (kv, dt)
        if dims["kind"] == "kv+x":
            x = (dims["n_cross"], B, cfg.vision.n_patches, KV, hd)
            out["xk"], out["xv"] = (x, dt), (x, dt)
        if dims["kind"] in ("ssm", "hybrid"):
            L, s, di = dims["n_ssm_layers"], cfg.ssm, cfg.d_inner
            if cfg.family == "ssm":
                out["conv"] = ((L, B, s.d_conv - 1, di), dt)
                out["state"] = ((L, B, di, s.d_state), torch.float32)
            else:
                out["conv"] = ((L, B, s.d_conv - 1, di + 2 * s.d_state), dt)
                out["state"] = ((L, B, di // s.head_dim, s.d_state, s.head_dim), torch.float32)
        return out

    def init_cache(self, B: int, max_len: int, device=None) -> dict:
        dev = runtime.resolve_device(device)
        return {k: torch.zeros(shape, dtype=dt, device=dev) for k, (shape, dt) in self.cache_struct(B, max_len).items()}

    def abstract_cache(self, B: int, max_len: int) -> dict:
        """The decode cache as ``meta`` tensors."""
        return {k: torch.empty(shape, dtype=dt, device="meta") for k, (shape, dt) in self.cache_struct(B, max_len).items()}

    def cache_specs(self, mesh, B: int, max_len: int, seq_shard: bool = False) -> dict:
        """Spec tree matching :meth:`cache_struct` (divisibility-repaired);
        ``seq_shard`` splits the kv caches' sequence dim instead of the batch
        (the long-context decode, whose batch is too small)."""
        ax = axis_names(mesh)

        def spec(*names):
            return logical_to_spec(tuple(names), ax, ())

        dims = self.cache_dims()
        out = {"len": spec("batch")}
        kv_axes = (None, None, "batch", "kv_heads", None) if seq_shard else (None, "batch", None, "kv_heads", None)
        if "n_kv_layers" in dims:
            out["k"] = spec(*kv_axes)
            out["v"] = spec(*kv_axes)
        if dims["kind"] == "kv+x":
            out["xk"] = spec(None, "batch", None, "kv_heads", None)
            out["xv"] = spec(None, "batch", None, "kv_heads", None)
        if dims["kind"] in ("ssm", "hybrid"):
            out["conv"] = spec(None, "batch", None, "d_inner")
            if self.cfg.family == "ssm":
                out["state"] = spec(None, "batch", "d_inner", None)
            else:
                out["state"] = spec(None, "batch", "d_inner", None, None)
        struct = self.cache_struct(B, max_len)
        return {k: repair_spec(s, struct[k][0], mesh) for k, s in out.items()}

    # ------------------------------------------------------------ prefill --
    def prefill(self, params: dict, tokens: torch.Tensor, *, max_len: int, vision: Optional[torch.Tensor] = None,
                mesh=None, length: Optional[int] = None):
        """Process the prompt.  Returns (last-position logits [B, (ncb,) V], cache).

        ``length`` is the true prompt length when ``tokens`` is right-padded to
        a bucket: the head runs at position ``length - 1`` and ``cache["len"]``
        is ``length``, so decode's length-masked attention never reads the
        padding's k/v rows.  That is exact for the causal kv-cache families
        only: an SSM or hybrid prefill folds every position into its recurrent
        state, so those raise on ``length=`` and take the exact prompt."""
        cfg = self.cfg
        if length is not None and cfg.family in ("ssm", "hybrid"):
            raise ValueError(f"bucketed prefill (length=) is invalid for family {cfg.family!r}: "
                             "recurrent state absorbs padded positions")
        B, Sq = tokens.shape[:2]
        if Sq > max_len:
            raise ValueError(f"prompt of {Sq} tokens exceeds max_len={max_len}")
        true_len = Sq if length is None else int(length)
        params = _precast(cfg, params)
        h, _, caches = self.forward(params, tokens, vision=vision, mesh=mesh, collect_cache=True, head=False)
        with on_mesh(mesh):
            # the head at the last true position only (causal: it never sees the padding)
            logits = T.lm_logits(cfg, params, h[:, true_len - 1:true_len], mesh)
            cache = {"len": torch.full((B,), true_len, dtype=torch.int64, device=h.device)}
            for key in ("conv", "state", "xk", "xv"):
                if key in caches:
                    cache[key] = caches[key]
            if "k" in caches:
                pad = (0, 0, 0, 0, 0, max_len - Sq)
                cache["k"], cache["v"] = pad_zeros(caches["k"], pad), pad_zeros(caches["v"], pad)
            return logits[:, -1], cache

    # -------------------------------------------------------------- decode --
    def decode_step(self, params: dict, tokens: torch.Tensor, cache: dict, *, mesh=None, seq_shard: bool = False):
        """tokens [B, 1], or [B, 1, ncb] for audio.  Returns (logits
        [B, (ncb,) V], cache), the cache updated in place.  ``seq_shard``: the
        kv caches are split over their sequence dim (``cache_specs``)."""
        with on_mesh(mesh):
            return self._decode_step(params, tokens, cache, mesh, seq_shard)

    def _decode_step(self, params, tokens, cache, mesh, seq_shard):
        cfg = self.cfg
        params = _precast(cfg, params)
        lens = cache["len"]
        h = T.embed_tokens(cfg, params, tokens, _dtype(cfg))
        h = constrain(h, mesh, *_BATCH_D)

        def self_layer(lp, h, i):
            a, _, _ = T.self_attn_decode(cfg, lp, h, cache["k"][i], cache["v"][i], lens, mesh)
            h = h + a
            m = T.moe_block(cfg, lp, h, mesh)[0] if cfg.family == "moe" else T.mlp_block(cfg, lp, h, mesh)
            return h + m

        if cfg.family in ("dense", "audio", "moe"):
            note_loop("layers", cfg.n_layers)
            for i in range(cfg.n_layers):
                h = self_layer(_layer(params["layers"], i), h, i)
        elif cfg.family == "vlm":
            every = cfg.vision.cross_attn_every
            note_loop("groups", cfg.n_layers // every)
            note_loop("self_layers", every - 1)
            for g in range(cfg.n_layers // every):
                for j in range(every - 1):
                    i = g * (every - 1) + j
                    h = self_layer(_layer(params["layers"], i), h, i)
                h = _cross_layer(cfg, _layer(params["cross_layers"], g), h, cache["xk"][g], cache["xv"][g], mesh)
        else:
            h0 = h
            step = S.mamba1_decode if cfg.family == "ssm" else S.mamba2_decode
            note_loop("layers", cfg.n_layers)
            for i in range(cfg.n_layers):
                h, cb, st = step(cfg, _layer(params["layers"], i), h, cache["conv"][i], cache["state"][i], mesh)
                _set_layer(cache["conv"], i, cb)
                _set_layer(cache["state"], i, st)
                if cfg.family == "hybrid" and (i + 1) % cfg.hybrid.attn_every == 0:
                    g = (i + 1) // cfg.hybrid.attn_every - 1
                    h = _shared_block_decode(cfg, params["shared"], h, h0, cache["k"][g], cache["v"][g], lens, mesh,
                                             seq_shard)
        logits = T.lm_logits(cfg, params, h, mesh)
        cache["len"] = lens + 1
        return logits[:, -1], cache


def _set_layer(stack: torch.Tensor, i: int, x: torch.Tensor) -> None:
    """``stack[i] = x`` in place; on a DTensor stack each rank copies its shard."""
    from repro_torch.models.sharding import is_dtensor

    if is_dtensor(stack):
        dst = stack[i]
        src = x if is_dtensor(x) else type(dst).from_local(x, dst.device_mesh, dst.placements, run_check=False)
        dst.to_local().copy_(src.redistribute(dst.device_mesh, dst.placements).to_local())
    else:
        stack[i] = x


def _cross_layer(cfg: ModelConfig, clp: dict, h: torch.Tensor, kv_k, kv_v, mesh=None) -> torch.Tensor:
    """A vlm cross layer: cross-attention, then the MLP, each residual scaled
    by ``tanh`` of the layer's gate."""
    dt = h.dtype
    h = h + T.cross_attn_block(cfg, clp, h, kv_k, kv_v, mesh) * torch.tanh(clp["attn_gate"]).to(dt)
    return h + T.mlp_block(cfg, clp, h, mesh) * torch.tanh(clp["mlp_gate"]).to(dt)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)


def params_from_numpy(cfg: ModelConfig, tree: dict, device=None) -> dict:
    """The reference's parameter tree as numpy arrays
    (``jax.tree.map(np.asarray, params)``) -> this package's tree on ``device``
    (None: the card), each leaf a copy checked against its ParamDef."""
    dev = runtime.resolve_device(device)

    def walk(defs, sub, path):
        if D.is_def(defs):
            arr = np.asarray(sub)
            if tuple(arr.shape) != defs.shape:
                raise ValueError(f"{'/'.join(path)}: shape {tuple(arr.shape)}, expected {defs.shape}")
            if arr.dtype != np.float32:
                arr = arr.astype(np.float32)
            elif not arr.flags.writeable:  # torch.from_numpy wants a writable buffer
                arr = arr.copy()
            # a copy: the train step updates params in place, which must not reach the caller's arrays
            return torch.from_numpy(arr).to(device=dev, dtype=defs.dtype, copy=True)
        if set(sub) != set(defs):
            raise ValueError(f"{'/'.join(path) or 'params'}: keys {sorted(sub)}, expected {sorted(defs)}")
        return {k: walk(defs[k], sub[k], path + (k,)) for k in sorted(defs)}

    return walk(Model(cfg).param_defs(), tree, ())
