"""Frozen copies of the workload DFG builders, in numpy.

The benchmark makes its own workload graphs and hands the same arrays to the
program (through ``Graph.from_numpy``) and to the plain reference.  These are
copies of the simulator's builders as they stood when the benchmark was
defined: the paper's evaluation set (CNNs, LSTM, DLRM, BERT, GNNs, non-AI
kernels) and the LM tracer, each building per-vertex arrays with numpy only.
The LM tracer keeps the dense, MoE, SSM and hybrid families (the five LM
graphs of ``lm_models.json``); the vision and audio branches of the original
are left out.  ``chipbench/tests/test_chipbench_inputs.py`` holds every graph
equal to the program's builders.

A graph is a dict of float32/int32 arrays keyed as the simulator's ``Graph``
(``n_comp`` [V, 4], ``n_read``/``n_write``/``n_alloc`` [V, 3], ``dims`` [V, 3],
``op_kind`` [V], ``edges`` [E, 2]); :func:`stack` pads a list of them to one
vertex bucket and stacks them on a leading workload axis.
"""
from __future__ import annotations

import json
import pathlib

import numpy as np

DATA_FIELDS = ("n_comp", "n_read", "n_write", "n_alloc", "dims", "op_kind", "edges")
MEM_IDX = {"localMem": 0, "globalBuf": 1, "mainMem": 2}
N_MEM = 3
MATMUL, ELEMWISE, REDUCTION, SCAN, GATHER, SOFTMAX, CONV, MISC = range(8)
# fractions of an op kind's FLOPs routed to (systolicArray, vector, macTree, fpu)
_KIND_ROUTE = np.array(
    [
        [1.00, 0.00, 0.00, 0.00],
        [0.00, 1.00, 0.00, 0.00],
        [0.00, 0.20, 0.80, 0.00],
        [0.00, 0.90, 0.00, 0.10],
        [0.00, 0.50, 0.00, 0.50],
        [0.00, 0.60, 0.40, 0.00],
        [1.00, 0.00, 0.00, 0.00],
        [0.00, 0.00, 0.00, 1.00],
    ],
    np.float32,
)
LM_MODELS = pathlib.Path(__file__).resolve().parent / "lm_models.json"


class GraphBuilder:
    def __init__(self):
        self._rows: list[dict] = []
        self._edges: list[tuple[int, int]] = []
        self._last: int | None = None

    def add(self, name: str, kind: int, flops: float, *, gbuf_read: float = 0.0, gbuf_write: float = 0.0,
            main_read: float = 0.0, main_write: float = 0.0, alloc: float = 0.0,
            dims: tuple[float, float, float] = (1.0, 1.0, 1.0), deps: list[int] | None = None,
            chain: bool = True) -> int:
        vid = len(self._rows)
        local = flops * 1.0  # ~1 byte of register-file traffic per FLOP
        n_read = np.zeros(N_MEM, np.float32)
        n_write = np.zeros(N_MEM, np.float32)
        n_alloc = np.zeros(N_MEM, np.float32)
        n_read[MEM_IDX["localMem"]] = local
        n_write[MEM_IDX["localMem"]] = local * 0.5
        n_read[MEM_IDX["globalBuf"]] = gbuf_read
        n_write[MEM_IDX["globalBuf"]] = gbuf_write
        n_read[MEM_IDX["mainMem"]] = main_read
        n_write[MEM_IDX["mainMem"]] = main_write
        n_alloc[MEM_IDX["globalBuf"]] = alloc
        n_alloc[MEM_IDX["mainMem"]] = main_read + main_write
        self._rows.append(dict(name=name, kind=kind, n_comp=_KIND_ROUTE[kind] * np.float32(flops), n_read=n_read,
                               n_write=n_write, n_alloc=n_alloc, dims=np.asarray(dims, np.float32)))
        if deps is not None:
            for d in deps:
                self._edges.append((d, vid))
        elif chain and self._last is not None:
            self._edges.append((self._last, vid))
        self._last = vid
        return vid

    def build(self) -> dict:
        rows = self._rows
        return dict(
            n_comp=np.stack([r["n_comp"] for r in rows]),
            n_read=np.stack([r["n_read"] for r in rows]),
            n_write=np.stack([r["n_write"] for r in rows]),
            n_alloc=np.stack([r["n_alloc"] for r in rows]),
            dims=np.stack([r["dims"] for r in rows]),
            op_kind=np.array([r["kind"] for r in rows], np.int32),
            edges=np.array(self._edges, np.int32).reshape(-1, 2) if self._edges else np.zeros((0, 2), np.int32),
            names=tuple(r["name"] for r in rows),
        )


def stack(graphs: list[dict], bucket: int) -> dict:
    """Pad each graph to ``bucket`` vertices with no-op vertices and stack them
    on a leading workload axis (edges: an empty [W, 0, 2] list, as the
    simulator's ``Graph.stack`` gives)."""
    out = {}
    for f in DATA_FIELDS[:-1]:
        parts = []
        for g in graphs:
            v = g[f].shape[0]
            if v > bucket:
                raise ValueError(f"a graph of {v} vertices does not fit the bucket {bucket}")
            pad = np.zeros((bucket - v,) + g[f].shape[1:], g[f].dtype)
            parts.append(np.concatenate([g[f], pad], 0))
        out[f] = np.stack(parts)
    out["edges"] = np.zeros((len(graphs), 0, 2), np.int32)
    return out


# --------------------------------------------------------------------------- #
# the paper's evaluation set (bf16 operands: 2 bytes an element)
# --------------------------------------------------------------------------- #

BYTES = 2.0


def _conv(b, name, H, W, cin, cout, k, stride, batch, mode):
    mult = 3.0 if mode == "train" else 1.0
    ho, wo = H // stride, W // stride
    flops = 2.0 * batch * ho * wo * cin * cout * k * k * mult
    act_in = batch * H * W * cin * BYTES
    act_out = batch * ho * wo * cout * BYTES
    w_bytes = cin * cout * k * k * BYTES
    b.add(name, CONV, flops, gbuf_read=(act_in + w_bytes) * mult, gbuf_write=act_out * mult,
          main_read=w_bytes * (2.0 if mode == "train" else 1.0), main_write=w_bytes if mode == "train" else 0.0,
          alloc=act_in + act_out + w_bytes, dims=(batch * ho * wo, cout, cin * k * k))
    return ho, wo


def _fc(b, name, M, K, N, mode):
    mult = 3.0 if mode == "train" else 1.0
    w = K * N * BYTES
    b.add(name, MATMUL, 2.0 * M * K * N * mult, gbuf_read=(M * K * BYTES + w) * mult,
          gbuf_write=M * N * BYTES * mult, main_read=w * (2.0 if mode == "train" else 1.0),
          main_write=w if mode == "train" else 0.0, alloc=(M * K + M * N) * BYTES + w, dims=(M, N, K))


def resnet50(batch: int = 32, mode: str = "inference") -> dict:
    b = GraphBuilder()
    H = W = 224
    H, W = _conv(b, "stem", H, W, 3, 64, 7, 2, batch, mode)
    H, W = H // 2, W // 2
    cin = 64
    for si, (width, blocks, stride0) in enumerate([(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)]):
        for bi in range(blocks):
            s = stride0 if bi == 0 else 1
            _conv(b, f"s{si}b{bi}.c1", H, W, cin, width, 1, 1, batch, mode)
            H2, W2 = _conv(b, f"s{si}b{bi}.c2", H, W, width, width, 3, s, batch, mode)
            _conv(b, f"s{si}b{bi}.c3", H2, W2, width, width * 4, 1, 1, batch, mode)
            if bi == 0:
                _conv(b, f"s{si}b{bi}.proj", H, W, cin, width * 4, 1, s, batch, mode)
            H, W, cin = H2, W2, width * 4
            b.add(f"s{si}b{bi}.relu", ELEMWISE, batch * H * W * cin,
                  gbuf_read=batch * H * W * cin * BYTES, gbuf_write=batch * H * W * cin * BYTES,
                  alloc=2 * batch * H * W * cin * BYTES, dims=(batch * H * W * cin, 1.0, 1.0))
    _fc(b, "fc", batch, 2048, 1000, mode)
    return b.build()


def vgg16(batch: int = 32, mode: str = "inference") -> dict:
    b = GraphBuilder()
    H = W = 224
    cin = 3
    for si, (width, n) in enumerate([(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]):
        for i in range(n):
            _conv(b, f"s{si}c{i}", H, W, cin, width, 3, 1, batch, mode)
            cin = width
        H, W = H // 2, W // 2
    _fc(b, "fc1", batch, 512 * 7 * 7, 4096, mode)
    _fc(b, "fc2", batch, 4096, 4096, mode)
    _fc(b, "fc3", batch, 4096, 1000, mode)
    return b.build()


def lstm(batch: int = 64, seq: int = 128, d: int = 1024, layers: int = 4, mode: str = "inference") -> dict:
    b = GraphBuilder()
    mult = 3.0 if mode == "train" else 1.0
    for li in range(layers):
        w = (d * 4 * d * 2) * BYTES
        b.add(f"l{li}.gates", MATMUL, 2.0 * batch * seq * d * 4 * d * 2 * mult,
              gbuf_read=(batch * seq * d * 2 * BYTES + w * seq) * mult, gbuf_write=batch * seq * 4 * d * BYTES * mult,
              main_read=w * (2.0 if mode == "train" else 1.0), main_write=w if mode == "train" else 0.0,
              alloc=batch * d * 8 * BYTES + w, dims=(batch, 4 * d, 2 * d))
        b.add(f"l{li}.cell", ELEMWISE, batch * seq * d * 8 * mult, gbuf_read=batch * seq * d * 4 * BYTES,
              gbuf_write=batch * seq * d * BYTES, alloc=batch * d * 6 * BYTES, dims=(batch * seq * d, 1.0, 1.0))
    _fc(b, "proj", batch * seq, d, 32000, mode)
    return b.build()


def dlrm(batch: int = 2048, n_tables: int = 26, emb_dim: int = 128, mode: str = "inference") -> dict:
    b = GraphBuilder()
    mult = 3.0 if mode == "train" else 1.0
    for i, (k, n) in enumerate([(13, 512), (512, 256), (256, emb_dim)]):
        _fc(b, f"bot{i}", batch, k, n, mode)
    lookup_bytes = batch * emb_dim * BYTES
    b.add("emb_gather", GATHER, batch * n_tables * emb_dim, main_read=lookup_bytes * n_tables,
          gbuf_write=lookup_bytes * n_tables, alloc=lookup_bytes * n_tables, dims=(batch * n_tables, emb_dim, 1.0))
    F = n_tables + 1
    b.add("interact", MATMUL, 2.0 * batch * F * F * emb_dim * mult, gbuf_read=batch * F * emb_dim * BYTES * mult,
          gbuf_write=batch * F * F * BYTES * mult, alloc=batch * (F * emb_dim + F * F) * BYTES,
          dims=(batch * F, F, emb_dim))
    top_in = F * (F - 1) // 2 + emb_dim
    for i, (k, n) in enumerate([(top_in, 1024), (1024, 512), (512, 256), (256, 1)]):
        _fc(b, f"top{i}", batch, k, n, mode)
    return b.build()


def _bert(layers: int, d: int, heads: int, seq: int, batch: int, mode: str) -> dict:
    b = GraphBuilder()
    mult = 3.0 if mode == "train" else 1.0
    hd = d // heads
    T = float(batch * seq)
    for i in range(layers):
        _fc(b, f"L{i}.qkv", T, d, 3 * d, mode)
        sc = 2.0 * batch * heads * seq * seq * hd * mult
        s_bytes = batch * heads * seq * seq * BYTES
        b.add(f"L{i}.scores", MATMUL, sc, gbuf_read=2 * T * d * BYTES * mult, gbuf_write=s_bytes * mult,
              alloc=2 * T * d * BYTES + s_bytes, dims=(batch * heads * seq, seq, hd))
        b.add(f"L{i}.softmax", SOFTMAX, batch * heads * seq * seq * 5 * mult, gbuf_read=s_bytes,
              gbuf_write=s_bytes, alloc=s_bytes, dims=(batch * heads * seq * seq, 1.0, 1.0))
        b.add(f"L{i}.av", MATMUL, sc, gbuf_read=(s_bytes + T * d * BYTES) * mult, gbuf_write=T * d * BYTES * mult,
              alloc=s_bytes + 2 * T * d * BYTES, dims=(batch * heads * seq, hd, seq))
        _fc(b, f"L{i}.o", T, d, d, mode)
        _fc(b, f"L{i}.ff1", T, d, 4 * d, mode)
        b.add(f"L{i}.gelu", ELEMWISE, T * 4 * d * 4 * mult, gbuf_read=T * 4 * d * BYTES,
              gbuf_write=T * 4 * d * BYTES, alloc=2 * T * 4 * d * BYTES, dims=(T * 4 * d, 1.0, 1.0))
        _fc(b, f"L{i}.ff2", T, 4 * d, d, mode)
        b.add(f"L{i}.ln", REDUCTION, T * d * 8 * mult, gbuf_read=T * d * BYTES, gbuf_write=T * d * BYTES,
              alloc=T * d * BYTES, dims=(T * d, 1.0, 1.0))
    _fc(b, "pooler", float(batch), d, d, mode)
    return b.build()


def bert_base(batch: int = 32, seq: int = 384, mode: str = "inference") -> dict:
    return _bert(12, 768, 12, seq, batch, mode)


def bert_large(batch: int = 32, seq: int = 384, mode: str = "inference") -> dict:
    return _bert(24, 1024, 16, seq, batch, mode)


def _mp_layer(b, name, n_nodes, n_edges, d_in, d_out, mode, concat_self=False):
    mult = 3.0 if mode == "train" else 1.0
    feat = n_nodes * d_in * BYTES
    edge_feat = n_edges * d_in * BYTES
    b.add(f"{name}.gather", GATHER, n_edges * d_in, main_read=edge_feat, gbuf_write=edge_feat, alloc=edge_feat,
          dims=(n_edges, d_in, 1.0))
    b.add(f"{name}.aggregate", REDUCTION, n_edges * d_in * mult, gbuf_read=edge_feat * mult, gbuf_write=feat * mult,
          alloc=edge_feat + feat, dims=(n_nodes, d_in, 1.0))
    k = d_in * (2.0 if concat_self else 1.0)
    w = k * d_out * BYTES
    b.add(f"{name}.transform", MATMUL, 2.0 * n_nodes * k * d_out * mult, gbuf_read=(n_nodes * k * BYTES + w) * mult,
          gbuf_write=n_nodes * d_out * BYTES * mult, main_read=w * (2.0 if mode == "train" else 1.0),
          main_write=w if mode == "train" else 0.0, alloc=n_nodes * (k + d_out) * BYTES + w, dims=(n_nodes, d_out, k))
    b.add(f"{name}.act", ELEMWISE, n_nodes * d_out * mult, gbuf_read=n_nodes * d_out * BYTES,
          gbuf_write=n_nodes * d_out * BYTES, alloc=2 * n_nodes * d_out * BYTES, dims=(n_nodes * d_out, 1.0, 1.0))


def gcn(n_nodes: int = 1 << 20, avg_degree: int = 16, d: int = 256, layers: int = 3, n_classes: int = 64,
        mode: str = "inference") -> dict:
    b = GraphBuilder()
    e = float(n_nodes * avg_degree)
    dims = [d] * layers + [n_classes]
    for i in range(layers):
        _mp_layer(b, f"L{i}", float(n_nodes), e, float(dims[i]), float(dims[i + 1]), mode)
    return b.build()


def graphsage(n_nodes: int = 1 << 20, avg_degree: int = 16, d: int = 256, layers: int = 2,
              mode: str = "inference") -> dict:
    b = GraphBuilder()
    e = float(n_nodes * avg_degree)
    for i in range(layers):
        _mp_layer(b, f"L{i}", float(n_nodes), e, float(d), float(d), mode, concat_self=True)
    return b.build()


# non-AI kernels: fp32, 4 bytes an element
_NONAI_BYTES = 4.0


def stencil2d(n: int = 4096, iters: int = 8) -> dict:
    b = GraphBuilder()
    pts = float(n * n)
    B = _NONAI_BYTES
    for it in range(iters):
        b.add(f"sweep{it}", ELEMWISE, pts * 5.0, gbuf_read=pts * 3.0 * B, gbuf_write=pts * B, main_read=pts * B,
              main_write=pts * B, alloc=3.0 * n * B * 64, dims=(pts, 1.0, 1.0))
    return b.build()


def merge_sort(n: int = 1 << 24) -> dict:
    b = GraphBuilder()
    B = _NONAI_BYTES
    for p in range(int(np.log2(n))):
        b.add(f"pass{p}", MISC, float(n) * 2.0, gbuf_read=float(n) * B, gbuf_write=float(n) * B,
              main_read=float(n) * B, main_write=float(n) * B, alloc=2.0 * min(n, 1 << 16) * B,
              dims=(float(n), 1.0, 1.0))
    return b.build()


def bfs_graph(n_vertices: int = 1 << 20, avg_degree: int = 16, frontier_rounds: int = 12) -> dict:
    b = GraphBuilder()
    B = _NONAI_BYTES
    profile = np.array([0.001, 0.01, 0.05, 0.2, 0.4, 0.2, 0.08, 0.03, 0.01, 0.004, 0.001, 0.0005])
    profile = profile[:frontier_rounds] / profile[:frontier_rounds].sum()
    edges = float(n_vertices * avg_degree)
    for r, frac in enumerate(profile):
        e = edges * float(frac)
        v = n_vertices * float(frac)
        b.add(f"round{r}.expand", GATHER, e * 2.0, main_read=e * (B + 4.0), gbuf_read=v * B,
              gbuf_write=e * 0.3 * B, alloc=min(v * B, 2.0e6), dims=(e, 1.0, 1.0))
        b.add(f"round{r}.compact", REDUCTION, e * 1.0, gbuf_read=e * 0.3 * B, gbuf_write=v * B,
              alloc=min(e * 0.3 * B, 2.0e6), dims=(e * 0.3, 1.0, 1.0))
    return b.build()


CLASSIC = {f.__name__: f for f in (resnet50, vgg16, lstm, dlrm, bert_base, bert_large, gcn, graphsage, stencil2d,
                                   merge_sort, bfs_graph)}


# --------------------------------------------------------------------------- #
# the LM tracer: a model's public config x a shape -> an operator DFG
# --------------------------------------------------------------------------- #


def _mm(b, name, M, K, N, *, mode, w_resident=False):
    mult = 3.0 if mode == "train" else 1.0
    w_bytes = K * N * BYTES
    act_in, act_out = M * K * BYTES, M * N * BYTES
    b.add(name, MATMUL, 2.0 * M * K * N * mult, gbuf_read=(act_in + w_bytes) * mult, gbuf_write=act_out * mult,
          main_read=0.0 if w_resident else w_bytes * (2.0 if mode == "train" else 1.0),
          main_write=w_bytes if mode == "train" else 0.0, alloc=act_in + act_out + w_bytes, dims=(M, N, K))


def _ew(b, name, elems, flops_per, *, mode, kind=ELEMWISE):
    mult = 3.0 if mode == "train" else 1.0
    b.add(name, kind, elems * flops_per * mult, gbuf_read=elems * BYTES * mult, gbuf_write=elems * BYTES * mult,
          alloc=2 * elems * BYTES, dims=(elems, 1.0, 1.0))


def _attention(b, name, Bq, Sq, Skv, nh, kv, hd, *, mode, causal, kv_from_main=0.0):
    mult = 3.0 if mode == "train" else 1.0
    frac = 0.5 if (causal and Sq == Skv) else 1.0
    score_flops = 2.0 * Bq * nh * Sq * Skv * hd * frac * mult
    kv_bytes = Bq * kv * Skv * hd * 2 * BYTES
    q_bytes = Bq * nh * Sq * hd * BYTES
    s_bytes = Bq * nh * Sq * Skv * frac * BYTES
    b.add(name + ".scores", MATMUL, score_flops, gbuf_read=(q_bytes + kv_bytes / 2) * mult,
          gbuf_write=s_bytes * mult, main_read=kv_from_main / 2, alloc=q_bytes + kv_bytes / 2 + s_bytes,
          dims=(Bq * nh * Sq, Skv * frac, hd))
    _ew(b, name + ".softmax", Bq * nh * Sq * Skv * frac, 5.0, mode=mode, kind=SOFTMAX)
    b.add(name + ".av", MATMUL, score_flops, gbuf_read=(s_bytes + kv_bytes / 2) * mult, gbuf_write=q_bytes * mult,
          main_read=kv_from_main / 2, alloc=s_bytes + kv_bytes / 2 + q_bytes, dims=(Bq * nh * Sq, hd, Skv * frac))


def trace_lm(cfg: dict, shape: dict) -> dict:
    """The operator DFG of one model config (``lm_models.json``'s entry) at one shape."""
    mode = shape["kind"]
    B = float(shape["global_batch"])
    S = 1.0 if mode == "decode" else float(shape["seq_len"])
    Skv = float(shape["seq_len"])
    d, V = float(cfg["d_model"]), float(cfg["vocab_size"])
    T = B * S
    nh, kv, ff = cfg["n_heads"], cfg["n_kv_heads"], float(cfg["d_ff"])
    hd = cfg.get("head_dim") or (cfg["d_model"] // nh if nh else 0)
    ssm = cfg.get("ssm")
    d_inner = ssm["expand"] * cfg["d_model"] if ssm else 0
    b = GraphBuilder()
    b.add("embed", GATHER, T * d, main_read=T * d * BYTES, gbuf_write=T * d * BYTES, alloc=T * d * BYTES,
          dims=(T, d, 1.0))

    def dense_attn_layer(i, prefix, kv_len):
        _ew(b, f"{prefix}{i}.norm1", T * d, 8.0, mode=mode, kind=REDUCTION)
        _mm(b, f"{prefix}{i}.qkv", T, d, (nh + 2 * kv) * hd, mode=mode)
        _ew(b, f"{prefix}{i}.rope", T * nh * hd, 6.0, mode=mode)
        kv_main = B * kv * kv_len * hd * 2 * BYTES if mode == "decode" else 0.0
        _attention(b, f"{prefix}{i}.attn", B, S, kv_len, nh, kv, hd, mode=mode, causal=True, kv_from_main=kv_main)
        _mm(b, f"{prefix}{i}.o", T, nh * hd, d, mode=mode)

    def mlp(i, prefix, width):
        _ew(b, f"{prefix}{i}.norm2", T * d, 8.0, mode=mode, kind=REDUCTION)
        nmat = 3 if cfg.get("mlp_type", "swiglu") == "swiglu" else 2
        _mm(b, f"{prefix}{i}.mlp_up", T, d, width * (nmat - 1), mode=mode)
        _ew(b, f"{prefix}{i}.act", T * width, 4.0, mode=mode)
        _mm(b, f"{prefix}{i}.mlp_down", T, width, d, mode=mode)

    family = cfg["family"]
    if family == "dense":
        for i in range(cfg["n_layers"]):
            dense_attn_layer(i, "L", Skv)
            mlp(i, "L", ff)
    elif family == "moe":
        e = cfg["moe"]
        for i in range(cfg["n_layers"]):
            dense_attn_layer(i, "L", Skv)
            _ew(b, f"L{i}.norm2", T * d, 8.0, mode=mode, kind=REDUCTION)
            _mm(b, f"L{i}.router", T, d, e["n_experts"], mode=mode)
            _ew(b, f"L{i}.topk", T * e["n_experts"], 3.0, mode=mode, kind=REDUCTION)
            mult = 3.0 if mode == "train" else 1.0
            tok = T * e["top_k"]
            w_bytes = e["n_experts"] * 3 * d * e["d_ff_expert"] * BYTES
            act_expert_w = min(w_bytes, tok * 3 * d * e["d_ff_expert"] * BYTES)
            b.add(f"L{i}.dispatch", GATHER, tok * d, gbuf_read=T * d * BYTES * mult,
                  gbuf_write=tok * d * BYTES * mult, alloc=(T + tok) * d * BYTES, dims=(tok, d, 1.0))
            b.add(f"L{i}.experts", MATMUL, 2.0 * tok * 3 * d * e["d_ff_expert"] * mult,
                  gbuf_read=(tok * d * BYTES + act_expert_w) * mult, gbuf_write=tok * d * BYTES * mult,
                  main_read=act_expert_w * (2.0 if mode == "train" else 1.0),
                  main_write=w_bytes if mode == "train" else 0.0, alloc=tok * d * BYTES * 2 + act_expert_w,
                  dims=(tok, e["d_ff_expert"], d))
            b.add(f"L{i}.combine", GATHER, tok * d * 2, gbuf_read=tok * d * BYTES * mult,
                  gbuf_write=T * d * BYTES * mult, alloc=(T + tok) * d * BYTES, dims=(T, d, 1.0))
    elif family == "ssm":
        di = float(d_inner)
        dtr = float(ssm.get("dt_rank") or -(-cfg["d_model"] // 16))
        for i in range(cfg["n_layers"]):
            _ew(b, f"L{i}.norm", T * d, 8.0, mode=mode, kind=REDUCTION)
            _mm(b, f"L{i}.in_proj", T, d, 2 * di, mode=mode)
            b.add(f"L{i}.conv1d", CONV, 2.0 * T * di * ssm["d_conv"] * (3.0 if mode == "train" else 1.0),
                  gbuf_read=T * di * BYTES, gbuf_write=T * di * BYTES, alloc=2 * T * di * BYTES,
                  dims=(T * di, 1.0, ssm["d_conv"]))
            _mm(b, f"L{i}.x_proj", T, di, dtr + 2 * ssm["d_state"], mode=mode)
            _mm(b, f"L{i}.dt_proj", T, dtr, di, mode=mode)
            _ew(b, f"L{i}.sel_scan", T * di, 5.0 * ssm["d_state"], mode=mode, kind=SCAN)
            _ew(b, f"L{i}.gate", T * di, 4.0, mode=mode)
            _mm(b, f"L{i}.out_proj", T, di, d, mode=mode)
    elif family == "hybrid":
        di = float(d_inner)
        nssm = di // ssm["head_dim"]
        h = cfg["hybrid"]
        for i in range(cfg["n_layers"]):
            _ew(b, f"L{i}.norm", T * d, 8.0, mode=mode, kind=REDUCTION)
            _mm(b, f"L{i}.in_proj", T, d, 2 * di + 2 * nssm * ssm["d_state"] + nssm, mode=mode)
            b.add(f"L{i}.conv1d", CONV, 2.0 * T * (di + 2 * nssm * ssm["d_state"]) * ssm["d_conv"],
                  gbuf_read=T * di * BYTES, gbuf_write=T * di * BYTES, alloc=2 * T * di * BYTES,
                  dims=(T * di, 1.0, ssm["d_conv"]))
            _ew(b, f"L{i}.ssd", T * di, 6.0 * ssm["d_state"], mode=mode, kind=SCAN)
            _mm(b, f"L{i}.out_proj", T, di, d, mode=mode)
            if (i + 1) % h["attn_every"] == 0:
                _ew(b, f"L{i}.snorm", T * 2 * d, 8.0, mode=mode, kind=REDUCTION)
                _mm(b, f"L{i}.sqkv", T, 2 * d, (nh + 2 * kv) * hd, mode=mode, w_resident=True)
                kv_main = B * kv * Skv * hd * 2 * BYTES if mode == "decode" else 0.0
                _attention(b, f"L{i}.sattn", B, S, Skv, nh, kv, hd, mode=mode, causal=True, kv_from_main=kv_main)
                _mm(b, f"L{i}.so", T, nh * hd, d, mode=mode, w_resident=True)
                mf = h["shared_attn_mlp_ff"]
                _mm(b, f"L{i}.smlp_up", T, d, 3 * mf - mf, mode=mode, w_resident=True)
                _mm(b, f"L{i}.smlp_down", T, mf, d, mode=mode, w_resident=True)
    else:
        raise ValueError(f"no tracer for family {family!r}")

    _ew(b, "final_norm", T * d, 8.0, mode=mode, kind=REDUCTION)
    _mm(b, "logits", T, d, V, mode=mode)
    if mode == "train":
        _ew(b, "xent", T * V, 6.0, mode=mode, kind=SOFTMAX)
    return b.build()


def lm_graph(name: str) -> dict:
    """An LM workload by its name, ``<model>:<shape>``."""
    lib = json.loads(LM_MODELS.read_text())
    model, shape = name.split(":")
    return trace_lm(lib["models"][model], lib["shapes"][shape])


def workload_graph(name: str) -> dict:
    return lm_graph(name) if ":" in name else CLASSIC[name]()
