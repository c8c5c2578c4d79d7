"""The paper's own evaluation workloads as DFGs (paper §8.1, Fig. 4, Table 3).

CNNs (ResNet-50, VGG-16), LSTM, DLRM, BERT — the 'vision / language /
recommendation' families of the paper's Table 3 technology-importance study.

Counts follow the standard closed forms:
  conv:   2 * H*W*Cin*Cout*k^2 / stride^2 FLOPs per image
  matmul: 2*M*K*N
  lstm:   4 gates, 2 matmuls per gate step
  dlrm:   embedding gathers (mainMem-bound) + bottom/top MLP + feature interact
"""
from __future__ import annotations

from repro_torch.core.graph import CONV, ELEMWISE, GATHER, MATMUL, REDUCTION, SOFTMAX, GraphBuilder, Graph

BYTES = 2.0  # bf16


def _conv(b: GraphBuilder, name: str, H: int, W: int, cin: int, cout: int, k: int, stride: int, batch: float, mode: str):
    mult = 3.0 if mode == "train" else 1.0
    ho, wo = H // stride, W // stride
    flops = 2.0 * batch * ho * wo * cin * cout * k * k * mult
    act_in = batch * H * W * cin * BYTES
    act_out = batch * ho * wo * cout * BYTES
    w_bytes = cin * cout * k * k * BYTES
    b.add(
        name,
        CONV,
        flops,
        gbuf_read=(act_in + w_bytes) * mult,
        gbuf_write=act_out * mult,
        main_read=w_bytes * (2.0 if mode == "train" else 1.0),
        main_write=w_bytes if mode == "train" else 0.0,
        alloc=act_in + act_out + w_bytes,
        # im2col view: M = out pixels, N = cout, K = cin*k*k
        dims=(batch * ho * wo, cout, cin * k * k),
    )
    return ho, wo


def _fc(b: GraphBuilder, name: str, M: float, K: float, N: float, mode: str):
    mult = 3.0 if mode == "train" else 1.0
    w = K * N * BYTES
    b.add(
        name,
        MATMUL,
        2.0 * M * K * N * mult,
        gbuf_read=(M * K * BYTES + w) * mult,
        gbuf_write=M * N * BYTES * mult,
        main_read=w * (2.0 if mode == "train" else 1.0),
        main_write=w if mode == "train" else 0.0,
        alloc=(M * K + M * N) * BYTES + w,
        dims=(M, N, K),
    )


def resnet50(batch: int = 32, mode: str = "inference", device=None) -> Graph:
    """ResNet-50 (ImageNet 224x224) — bottleneck blocks."""
    b = GraphBuilder()
    H = W = 224
    H, W = _conv(b, "stem", H, W, 3, 64, 7, 2, batch, mode)
    H, W = H // 2, W // 2  # maxpool
    cin = 64
    stages = [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)]
    for si, (width, blocks, stride0) in enumerate(stages):
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
    return b.build(device)


def vgg16(batch: int = 32, mode: str = "inference", device=None) -> Graph:
    b = GraphBuilder()
    H = W = 224
    cfg = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
    cin = 3
    for si, (width, n) in enumerate(cfg):
        for i in range(n):
            _conv(b, f"s{si}c{i}", H, W, cin, width, 3, 1, batch, mode)
            cin = width
        H, W = H // 2, W // 2  # maxpool
    _fc(b, "fc1", batch, 512 * 7 * 7, 4096, mode)
    _fc(b, "fc2", batch, 4096, 4096, mode)
    _fc(b, "fc3", batch, 4096, 1000, mode)
    return b.build(device)


def lstm(batch: int = 64, seq: int = 128, d: int = 1024, layers: int = 4, mode: str = "inference", device=None) -> Graph:
    """Stacked LSTM; the recurrent matmuls are sequential (one vertex per
    layer carrying seq-many steps; K dim keeps utilization honest)."""
    b = GraphBuilder()
    mult = 3.0 if mode == "train" else 1.0
    for li in range(layers):
        # input + recurrent projections for 4 gates, per timestep
        w = (d * 4 * d * 2) * BYTES
        flops = 2.0 * batch * seq * d * 4 * d * 2 * mult
        b.add(
            f"l{li}.gates",
            MATMUL,
            flops,
            gbuf_read=(batch * seq * d * 2 * BYTES + w * seq) * mult,
            gbuf_write=batch * seq * 4 * d * BYTES * mult,
            main_read=w * (2.0 if mode == "train" else 1.0),
            main_write=w if mode == "train" else 0.0,
            alloc=batch * d * 8 * BYTES + w,
            dims=(batch, 4 * d, 2 * d),  # per-step M=batch (sequential dep)
        )
        b.add(f"l{li}.cell", ELEMWISE, batch * seq * d * 8 * mult,
              gbuf_read=batch * seq * d * 4 * BYTES, gbuf_write=batch * seq * d * BYTES,
              alloc=batch * d * 6 * BYTES, dims=(batch * seq * d, 1.0, 1.0))
    _fc(b, "proj", batch * seq, d, 32000, mode)
    return b.build(device)


def dlrm(batch: int = 2048, n_tables: int = 26, emb_dim: int = 128, rows: float = 1e6, mode: str = "inference", device=None) -> Graph:
    """DLRM: sparse embedding gathers (mainMem-dominated) + MLPs + interaction."""
    b = GraphBuilder()
    mult = 3.0 if mode == "train" else 1.0
    # bottom MLP 13 -> 512 -> 256 -> 128
    for i, (k, n) in enumerate([(13, 512), (512, 256), (256, emb_dim)]):
        _fc(b, f"bot{i}", batch, k, n, mode)
    # embedding lookups: random-access reads of emb_dim vectors per table
    lookup_bytes = batch * emb_dim * BYTES
    b.add(
        "emb_gather",
        GATHER,
        batch * n_tables * emb_dim,
        main_read=lookup_bytes * n_tables,
        gbuf_write=lookup_bytes * n_tables,
        alloc=lookup_bytes * n_tables,
        dims=(batch * n_tables, emb_dim, 1.0),
    )
    # pairwise interaction: batch x (27 x 128) @ (128 x 27)
    F = n_tables + 1
    b.add("interact", MATMUL, 2.0 * batch * F * F * emb_dim * mult,
          gbuf_read=batch * F * emb_dim * BYTES * mult,
          gbuf_write=batch * F * F * BYTES * mult,
          alloc=batch * (F * emb_dim + F * F) * BYTES,
          dims=(batch * F, F, emb_dim))
    # top MLP
    top_in = F * (F - 1) // 2 + emb_dim
    for i, (k, n) in enumerate([(top_in, 1024), (1024, 512), (512, 256), (256, 1)]):
        _fc(b, f"top{i}", batch, k, n, mode)
    return b.build(device)


def _bert(layers: int, d: int, heads: int, seq: int, batch: int, mode: str, device=None) -> Graph:
    b = GraphBuilder()
    mult = 3.0 if mode == "train" else 1.0
    hd = d // heads
    T = float(batch * seq)
    for i in range(layers):
        _fc(b, f"L{i}.qkv", T, d, 3 * d, mode)
        # scores + av (full bidirectional attention)
        sc = 2.0 * batch * heads * seq * seq * hd * mult
        s_bytes = batch * heads * seq * seq * BYTES
        b.add(f"L{i}.scores", MATMUL, sc, gbuf_read=2 * T * d * BYTES * mult,
              gbuf_write=s_bytes * mult, alloc=2 * T * d * BYTES + s_bytes,
              dims=(batch * heads * seq, seq, hd))
        b.add(f"L{i}.softmax", SOFTMAX, batch * heads * seq * seq * 5 * mult,
              gbuf_read=s_bytes, gbuf_write=s_bytes, alloc=s_bytes,
              dims=(batch * heads * seq * seq, 1.0, 1.0))
        b.add(f"L{i}.av", MATMUL, sc, gbuf_read=(s_bytes + T * d * BYTES) * mult,
              gbuf_write=T * d * BYTES * mult, alloc=s_bytes + 2 * T * d * BYTES,
              dims=(batch * heads * seq, hd, seq))
        _fc(b, f"L{i}.o", T, d, d, mode)
        _fc(b, f"L{i}.ff1", T, d, 4 * d, mode)
        b.add(f"L{i}.gelu", ELEMWISE, T * 4 * d * 4 * mult, gbuf_read=T * 4 * d * BYTES,
              gbuf_write=T * 4 * d * BYTES, alloc=2 * T * 4 * d * BYTES,
              dims=(T * 4 * d, 1.0, 1.0))
        _fc(b, f"L{i}.ff2", T, 4 * d, d, mode)
        b.add(f"L{i}.ln", REDUCTION, T * d * 8 * mult, gbuf_read=T * d * BYTES,
              gbuf_write=T * d * BYTES, alloc=T * d * BYTES, dims=(T * d, 1.0, 1.0))
    _fc(b, "pooler", float(batch), d, d, mode)
    return b.build(device)


def bert_base(batch: int = 32, seq: int = 384, mode: str = "inference", device=None) -> Graph:
    return _bert(12, 768, 12, seq, batch, mode, device)


def bert_large(batch: int = 32, seq: int = 384, mode: str = "inference", device=None) -> Graph:
    return _bert(24, 1024, 16, seq, batch, mode, device)
