"""Plain PyTorch versions of the port's kernels.

They run on whatever device their inputs are on: the CPU tests use them, the
kernel wrappers take them for CPU tensors, and ``chip_smoke.py`` holds each
CUDA kernel against them on the card.  They repeat the arithmetic of their
kernels and are no yardstick of speed.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import popsim_kernel as pk

NEG_INF = -1e30  # finite mask value of the attention kernel and its plain version


def affine_scan_reference(decay, add: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Inclusive prefix of ``s' = decay*s + add_i`` (s0 = 0) along the last
    axis, as a log-step doubling scan; ``reverse`` scans from the end.
    ``decay`` is a number, or a tensor of ``add``'s shape (one a position).

    Elements are affine maps (a, b): s -> a*s + b; composing an earlier
    (a1, b1) with a later (a2, b2) gives (a1*a2, a2*b1 + b2).  After the step
    with shift ``d``, position i holds the composition of positions
    ``i-2d+1 .. i``; positions below ``d`` are already complete.
    """
    if reverse:
        flip = decay.flip(-1) if torch.is_tensor(decay) else decay
        return affine_scan_reference(flip, add.flip(-1)).flip(-1)
    a = decay.expand_as(add) if torch.is_tensor(decay) else torch.full_like(add, decay)
    b = add.clone()  # a new tensor even when V <= 1 and no step runs
    v = add.shape[-1]
    d = 1
    while d < v:
        b = torch.cat([b[..., :d], a[..., d:] * b[..., :-d] + b[..., d:]], -1)
        a = torch.cat([a[..., :d], a[..., :-d] * a[..., d:]], -1)
        d *= 2
    return b


def minaffine_scan_reference(decay: float, add: torch.Tensor, cap: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix of ``s' = min(decay*s + add_i, cap)`` (s0 = 0) along
    the last axis, ``cap`` broadcast against ``add``.

    Maps s -> min(a*s + b, c) are closed under composition (later
    (a2,b2,c2) ∘ earlier (a1,b1,c1) = (a1*a2, a2*b1 + b2,
    min(a2*c1 + b2, c2)) for a2 >= 0), so the clamped recurrence is a
    doubling scan too.  Positions below the shift ``d`` are complete and
    kept as they are, so no identity element is needed.
    """
    a = torch.full_like(add, decay)
    b = add
    c = torch.broadcast_to(cap, add.shape).to(add.dtype)
    v = add.shape[-1]
    d = 1
    while d < v:
        a2, b2, c2 = a[..., d:], b[..., d:], c[..., d:]
        a1, b1, c1 = a[..., :-d], b[..., :-d], c[..., :-d]
        a_n = torch.cat([a[..., :d], a1 * a2], -1)
        b_n = torch.cat([b[..., :d], a2 * b1 + b2], -1)
        c = torch.cat([c[..., :d], torch.minimum(a2 * c1 + b2, c2)], -1)
        a, b = a_n, b_n
        d *= 2
    return torch.minimum(b, c)  # applied to s0 = 0


def _exclusive(after: torch.Tensor) -> torch.Tensor:
    """Shift an inclusive prefix to the state *before* each position (0 first)."""
    return torch.cat([torch.zeros_like(after[..., :1]), after[..., :-1]], -1)


def _exclusive_reverse(after: torch.Tensor) -> torch.Tensor:
    """The same for a prefix taken from the end (0 last)."""
    return torch.cat([after[..., 1:], torch.zeros_like(after[..., :1])], -1)


def mapper_carries_reference(alloc: torch.Tensor, bw_x: torch.Tensor, cap: torch.Tensor, occ_decay: float,
                             bw_decay: float, bw_gain: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The mapper's two Alg.-7 carries as exclusive prefixes (the state before
    each vertex, 0 at the first), with the occupancy clamp code.

    ``alloc`` and ``bw_x`` are [..., V], ``cap`` [...]; they broadcast, and
    every output has the broadcast shape [..., V]:

      * ``occ_prev``: s before vertex j of ``s' = min(occ_decay*s + alloc_j, cap)``;
      * ``bw_prev``: t before vertex j of ``t' = bw_decay*t + bw_gain*bw_x_j``;
      * ``code`` (uint8): 2*m_j, m_j = d s'/d u at u = occ_decay*s + alloc_j:
        1 below ``cap``, 0 above, 1/2 on a tie (``torch.minimum``'s split).
    """
    lead = torch.broadcast_shapes(alloc.shape[:-1], bw_x.shape[:-1], cap.shape)
    v = bw_x.shape[-1]
    alloc = alloc.expand(*lead, v)
    cap = cap.expand(lead)[..., None]
    occ_prev = _exclusive(minaffine_scan_reference(occ_decay, alloc, cap))
    bw_prev = _exclusive(affine_scan_reference(bw_decay, bw_gain * bw_x.expand(*lead, v)))
    u = occ_decay * occ_prev + alloc
    code = (u < cap).to(torch.uint8) * 2 + (u == cap).to(torch.uint8)
    return occ_prev, bw_prev, code


def mapper_carries_backward_reference(g_occ: torch.Tensor, g_bw: torch.Tensor, code: torch.Tensor,
                                      occ_decay: float, bw_decay: float, bw_gain: float
                                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The closed-form gradient of :func:`mapper_carries_reference` from the
    cotangents of ``occ_prev`` and ``bw_prev`` ([..., V]) and the forward's
    ``code``: (grad_alloc [..., V], grad_bw_x [..., V], grad_cap [...]).

    With m = code/2: lambda_j = g_occ[j+1] + occ_decay*m_{j+1}*lambda_{j+1}
    (0 at the last vertex), a reversed doubling scan with a per-position
    decay, shifted by one; grad_alloc = m*lambda, grad_cap = sum (1-m)*lambda;
    mu_j = g_bw[j+1] + bw_decay*mu_{j+1}, grad_bw_x = bw_gain*mu.
    """
    m = 0.5 * code.to(torch.float32)
    lam = _exclusive_reverse(affine_scan_reference(occ_decay * m, g_occ, reverse=True))
    mu = _exclusive_reverse(affine_scan_reference(bw_decay, g_bw, reverse=True))
    return m * lam, bw_gain * mu, torch.sum((1.0 - m) * lam, -1)


def _t(x: torch.Tensor, y) -> torch.Tensor:
    """``y`` as a tensor on ``x``'s device (a scalar is filled there, with no
    host copy)."""
    return y if torch.is_tensor(y) else torch.full((), y, dtype=x.dtype, device=x.device)


def _nan_max(x: torch.Tensor, y) -> torch.Tensor:
    return torch.maximum(x, _t(x, y))


def _nan_min(x: torch.Tensor, y) -> torch.Tensor:
    return torch.minimum(x, _t(x, y))


def popsim_reference(graph_packed: torch.Tensor, chw_packed: torch.Tensor) -> torch.Tensor:
    """A loop over the vertices, vectorised over the P candidates, with the
    popsim kernel's exact math and operation order.  Returns [P, OUT_COLS]."""
    c = chw_packed.to(torch.float32)
    g_all = graph_packed.to(torch.float32)
    P = c.shape[0]
    freq = c[:, pk.FREQ]
    cap_gbuf = c[:, pk.CAP_GBUF] * pk.HEADROOM
    # a tensor divisor keeps '/' an IEEE division on the card (a Python-scalar
    # divisor is turned into a multiply by its reciprocal there)
    occ_cap = cap_gbuf / torch.full_like(cap_gbuf, pk.HEADROOM)
    bw, rlat, wlat = c[:, pk.BW], c[:, pk.RLAT], c[:, pk.WLAT]
    re_pb, we_pb = c[:, pk.RE_PB], c[:, pk.WE_PB]
    e_flop, rate = c[:, pk.E_FLOP], c[:, pk.RATE]
    sys_x, sys_y = c[:, pk.SYS_X], c[:, pk.SYS_Y]
    eff = [_nan_max(rate[:, k], 1e-9) * freq for k in range(4)]
    rate_sys = _nan_max(rate[:, pk._SYS], 1e-9)

    zeros = torch.zeros(P, dtype=torch.float32, device=c.device)
    cycles, e_dyn, t_comp_acc, t_mem_acc, t_exp_acc, tiles_acc = (zeros,) * 6
    occupancy, bw_ema = zeros, zeros
    for v in range(g_all.shape[0]):
        g = g_all[v]  # 0-dim views of the row broadcast against the [P] designs
        n_comp = [g[pk.G_COMP.start + k] for k in range(4)]
        n_read = [g[pk.G_READ.start + lv] for lv in range(3)]
        n_write = [g[pk.G_WRITE.start + lv] for lv in range(3)]
        alloc_t, has_main_t = g[pk.G_ALLOC_GBUF], g[pk.G_MAIN_PRESENT]
        M, N, K = (g[pk.G_DIMS.start + i] for i in range(3))

        tiles = _nan_max(torch.ceil(alloc_t / cap_gbuf), 1.0)
        m_t = _nan_max(M / tiles, 1.0)
        waves = torch.ceil(m_t / sys_x) * torch.ceil(_nan_max(N, 1.0) / sys_y)
        cyc_sys_tile = waves * (torch.ceil(_nan_max(K, 1.0)) + sys_x + sys_y)
        ops_sys_tile = n_comp[0] / tiles
        cyc_sys_tile = _nan_max(cyc_sys_tile, ops_sys_tile / rate_sys)
        t_sys = torch.where(ops_sys_tile > 0, tiles * cyc_sys_tile / freq, 0.0)
        t_other = zeros
        for k in range(1, 4):
            t_other = _nan_max(t_other, n_comp[k] / eff[k])
        t_comp = _nan_max(t_other, t_sys)

        t_lvl = [(n_read[lv] + n_write[lv]) / bw[:, lv] * 1.04 for lv in range(3)]
        t_tile_lat = [tiles * (rlat[:, lv] + wlat[:, lv]) for lv in range(3)]
        t_onchip = _nan_max(t_lvl[1] + t_tile_lat[1], t_lvl[0])
        t_main = t_lvl[2] + t_tile_lat[2] * has_main_t

        bw_ok = (bw_ema < pk.HEADROOM).to(torch.float32)
        can_prefetch = ((occupancy + alloc_t / tiles) < cap_gbuf).to(torch.float32) * bw_ok
        hide = _nan_max(can_prefetch, bw_ok)

        t_core = _nan_max(t_comp, t_onchip)
        t_exposed = _nan_max(t_main - hide * t_core, 0.0)
        mass = ((n_comp[0] + n_comp[1]) + n_comp[2]) + n_comp[3]
        mass = mass + ((n_read[0] + n_read[1]) + n_read[2]) + ((n_write[0] + n_write[1]) + n_write[2])
        active = (mass + alloc_t + has_main_t > 0).to(torch.float32)
        t_vertex = tiles * torch.ceil((t_core + t_exposed) * freq / tiles) / freq * active

        t_full = tiles * torch.ceil((t_core + t_main) * freq / tiles) / freq
        used_bw = torch.where(
            t_full > 0,
            (n_read[pk._GBUF] + n_write[pk._GBUF]) / _nan_max(t_full, 1e-30) / bw[:, pk._GBUF],
            0.0,
        )
        bw_ema = 0.8 * bw_ema + 0.2 * _nan_min(_nan_max(used_bw, 0.0), 2.0)
        occupancy = _nan_min(0.5 * occupancy + alloc_t, occ_cap)

        e_mem = zeros
        for lv in range(3):
            e_mem = e_mem + (n_read[lv] * re_pb[:, lv] + n_write[lv] * we_pb[:, lv])
        e_comp = zeros
        for k in range(4):
            e_comp = e_comp + n_comp[k] * e_flop[:, k]

        cycles = cycles + t_vertex * freq
        e_dyn = e_dyn + (e_mem + e_comp)
        t_comp_acc = t_comp_acc + t_comp
        t_mem_acc = t_mem_acc + t_onchip * active
        t_exp_acc = t_exp_acc + t_exposed
        tiles_acc = tiles_acc + tiles * active
    return torch.stack([cycles, e_dyn, t_comp_acc, t_mem_acc, t_exp_acc, tiles_acc, zeros, zeros], -1)


# --------------------------------------------------------------------------- #
# the model kernels: attention, the Mamba2 SSD scan, the Mamba1 selective scan
# --------------------------------------------------------------------------- #


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                        scale: float | None = None) -> torch.Tensor:
    """Dense attention with grouped KV heads and a float32 softmax.
    q [B, Hq, Sq, D], k and v [B, Hkv, Skv, D]; the mask is suffix-causal
    (query i sees key j when j <= i + Skv - Sq) with the finite -1e30."""
    Hq, Sq, D = q.shape[1:]
    Hkv, Skv = k.shape[1:3]
    group = Hq // Hkv
    scale = D ** -0.5 if scale is None else scale
    kf = k.float().repeat_interleave(group, 1)
    vf = v.float().repeat_interleave(group, 1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale
    if causal:
        mask = torch.ones(Sq, Skv, dtype=torch.bool, device=q.device).tril(Skv - Sq)
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, -1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def _pad_steps(chunk: int, *xs: torch.Tensor) -> tuple[int, list[torch.Tensor]]:
    """Zero-pad axis 1 of each array up to a multiple of ``chunk``.  With
    dt = 0 a padded step of either scan is the identity."""
    S = xs[0].shape[1]
    pad = -S % chunk
    out = []
    for x in xs:
        x = x.float()
        if pad:
            x = F.pad(x, (0, 0) * (x.ndim - 2) + (0, pad))
        out.append(x)
    return (S + pad) // chunk, out


def ssd_scan_phases(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                    chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Chunked SSD (Mamba2) in the three phases of its kernels, every chunk at
    once but for the pass: (1) each chunk's own state contribution
    dS_c = B^T diag(exp(cum_L - cum) dt) x; (2) the pass
    S_c = exp(cum_L) S_{c-1} + dS_c; (3) each chunk's output
    y = (C B^T o decay o dt) x + exp(cum) (C S_{c-1}).  x [B, S, H, P],
    dt [B, S, H], A [H], B and C [B, S, N].  Returns (y [B, S, H, P] in x's
    type, final state [B, H, N, P] float32, the state entering each chunk
    [B, chunks, H, N, P] float32).  Any S: the last chunk is padded with zero
    steps."""
    B_, S, H, P = x.shape
    N = Bm.shape[-1]
    L = chunk
    nc, (xf, dtf, Bf, Cf) = _pad_steps(chunk, x, dt, Bm, Cm)
    xc, dtc = xf.reshape(B_, nc, L, H, P), dtf.reshape(B_, nc, L, H)
    Bc, Cc = Bf.reshape(B_, nc, L, N), Cf.reshape(B_, nc, L, N)
    # [B, c, L, H] log-decay from the chunk's start, in float64 as the kernels take
    # it: the decays are exponentials of its differences
    cum = torch.cumsum(dtc.double() * A.double(), 2)
    total = cum[:, :, -1]  # [B, c, H]
    # 1. chunk states
    ds = torch.einsum("bclh,bcln,bclhp->bchnp", torch.exp((total[:, :, None] - cum).float()) * dtc, Bc, xc)
    # 2. the pass
    entering = torch.empty_like(ds)
    state = torch.zeros(B_, H, N, P, dtype=torch.float32, device=x.device)
    decay = total.float().exp()
    for c in range(nc):
        entering[:, c] = state
        state = decay[:, c, :, None, None] * state + ds[:, c]
    # 3. chunk outputs; the decay only where i >= j: above the diagonal exp would overflow to inf
    mask = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B, c, i, j, H]
    scores = (li.float().masked_fill(~mask[:, :, None], float("-inf")).exp()
              * torch.einsum("bcin,bcjn->bcij", Cc, Bc)[..., None] * dtc[:, :, None])
    y = (torch.einsum("bcijh,bcjhp->bcihp", scores, xc)
         + cum.float().exp()[..., None] * torch.einsum("bcin,bchnp->bcihp", Cc, entering))
    return y.reshape(B_, nc * L, H, P)[:, :S].to(x.dtype), state, entering


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
             chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD (Mamba2), :func:`ssd_scan_phases` without the entering
    states: (y [B, S, H, P] in x's type, final state [B, H, N, P] float32)."""
    return ssd_scan_phases(x, dt, A, Bm, Cm, chunk)[:2]


def ssd_reference(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor, C: torch.Tensor, *,
                  dtype: torch.dtype = torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-step recurrence that SSD reformulates (the test oracle):
    state_t = exp(dt_t A_h) state_{t-1} + dt_t (B_t outer x_t);  y_t = C_t . state_t.
    ``dtype`` is the type it accumulates in.  At float32 (the default) y
    comes back in x's type and the state in float32; at a wider type
    (float64: the oracle the float32 versions are held against) both stay in
    that type."""
    B_, S, H, P = x.shape
    N = Bm.shape[-1]
    xf, dtf, Bf, Cf, Af = (t.to(dtype) for t in (x, dt, Bm, C, A))
    state = torch.zeros(B_, H, N, P, dtype=dtype, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * Af[None])  # [B, H]
        upd = dtf[:, t, :, None, None] * (Bf[:, t, None, :, None] * xf[:, t, :, None, :])
        state = decay[..., None, None] * state + upd
        ys.append(torch.einsum("bn,bhnp->bhp", Cf[:, t], state))
    y = torch.stack(ys, 1) if ys else xf
    return (y.to(x.dtype) if dtype == torch.float32 else y), state


def selective_scan_reference(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                             Cm: torch.Tensor, D: torch.Tensor, *,
                             dtype: torch.dtype = torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-step Mamba1 recurrence (the test oracle):
    s_t = exp(dt_t A) s_{t-1} + dt_t u_t B_t;  y_t = C_t . s_t + D u_t.
    ``dtype`` is the type it accumulates in, as in :func:`ssd_reference`."""
    B_, S, C = u.shape
    uf, dtf, Af, Bf, Cf, Df = (t.to(dtype) for t in (u, dt, A, Bm, Cm, D))
    state = torch.zeros(B_, C, A.shape[1], dtype=dtype, device=u.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t, :, None] * Af)  # [B, C, N]
        state = decay * state + (dtf[:, t] * uf[:, t])[..., None] * Bf[:, t, None, :]
        ys.append(torch.einsum("bcn,bn->bc", state, Cf[:, t]))
    y = (torch.stack(ys, 1) if ys else uf) + uf * Df
    return (y.to(u.dtype) if dtype == torch.float32 else y), state


def selective_scan_states(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                          Cm: torch.Tensor, D: torch.Tensor,
                          chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Chunked Mamba1 selective scan: a log-step doubling scan of the affine
    pairs (exp(dt A), dt u B) inside each chunk, the state carried across.
    u and dt [B, S, C], A [C, N], B and C [B, S, N], D [C].  Returns
    (y [B, S, C] in u's type, final state [B, C, N] float32, the state
    entering each chunk [B, chunks, C, N] float32).  Any S."""
    B_, S, C = u.shape
    N = A.shape[1]
    nc, (uf, dtf, Bf, Cf) = _pad_steps(chunk, u, dt, Bm, Cm)
    Af = A.float()
    state = torch.zeros(B_, C, N, dtype=torch.float32, device=u.device)
    entering = torch.empty(B_, nc, C, N, dtype=torch.float32, device=u.device)
    y = torch.empty(B_, nc * chunk, C, dtype=torch.float32, device=u.device)
    for ch in _blocks(C, B_ * chunk * N, u.device):  # channels are independent
        for c in range(nc):
            sl = slice(c * chunk, (c + 1) * chunk)
            uc, dtc, Bc, Cc = uf[:, sl, ch], dtf[:, sl, ch], Bf[:, sl], Cf[:, sl]
            a = torch.exp(dtc[..., None] * Af[ch])  # [B, L, C, N]
            b = (dtc * uc)[..., None] * Bc[:, :, None, :]
            a, b = _doubling(a, b, 1)
            entering[:, c, ch] = state[:, ch]
            s = a * state[:, None, ch] + b
            y[:, sl, ch] = torch.einsum("btcn,btn->btc", s, Cc)
            state[:, ch] = s[:, -1]
    y = y[:, :S] + uf[:, :S] * D.float()
    return y.to(u.dtype), state, entering


def selective_scan(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                   D: torch.Tensor, chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`selective_scan_states` without the entering states: (y [B, S, C]
    in u's type, final state [B, C, N] float32)."""
    return selective_scan_states(u, dt, A, Bm, Cm, D, chunk)[:2]


# --------------------------------------------------------------------------- #
# the scans' backwards
# --------------------------------------------------------------------------- #
#
# Each takes the forward's inputs, the state entering each chunk (which the
# kernel writes beside its outputs) and the cotangents of y and of the final
# state, and returns the inputs' gradients.  Both are chunk-parallel: a first
# pass gives each chunk's share of the gradient of the state entering it in
# closed form, a sequential pass over the chunks (one [B, ..., N, P] update a
# chunk, as the forward's state pass) carries the state cotangent back, and a
# last pass recomputes each chunk's intermediates from its entering state and
# its carried cotangent.  The chunks go through both chunk-parallel passes in
# groups (and the selective scan's channels, which are independent, in
# blocks) whose largest temporary holds at most GROUP_ELEMENTS of the
# device's elements: few launches on the card, and tiles that stay nearer
# the caches on the CPU (a third of the time of 2^27 there at falcon-mamba's
# width).

GROUP_ELEMENTS = {"cuda": 1 << 27, "cpu": 1 << 20}  # float32 elements: 512 MiB, 4 MiB


def _blocks(n: int, per_item: int, device: torch.device) -> list[slice]:
    """Slices of ``n`` items (chunks, channels) of ``per_item`` elements each,
    as few as keep each slice within GROUP_ELEMENTS (one item at least)."""
    g = max(1, GROUP_ELEMENTS.get(device.type, 1 << 27) // max(1, per_item))
    return [slice(c, min(n, c + g)) for c in range(0, n, g)]


def _doubling(a: torch.Tensor, b: torch.Tensor, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of the affine pairs (a_t, b_t) along ``dim`` (s_t = a_t
    s_{t-1} + b_t from s = 0) by log-step doubling: (the products of a up to
    t, s_t)."""
    L = a.shape[dim]
    d = 1
    while d < L:  # (a1, b1) then (a2, b2) compose to (a1 a2, a2 b1 + b2)
        b = torch.cat([b.narrow(dim, 0, d), a.narrow(dim, d, L - d) * b.narrow(dim, 0, L - d)
                       + b.narrow(dim, d, L - d)], dim)
        a = torch.cat([a.narrow(dim, 0, d), a.narrow(dim, 0, L - d) * a.narrow(dim, d, L - d)], dim)
        d *= 2
    return a, b


def _carry_back(decay: torch.Tensor, local: torch.Tensor, g_state) -> torch.Tensor:
    """The cotangent of the state leaving each chunk, [B, chunks, ...]: the
    last chunk's is ``g_state`` (None: 0), and the one before chunk c is
    ``local[:, c] + decay[:, c] * (chunk c's)``, with ``decay`` [B, chunks, ...]
    broadcasting against ``local``."""
    out = torch.empty_like(local)
    g = torch.zeros_like(local[:, 0]) if g_state is None else g_state.float()
    for c in range(local.shape[1] - 1, -1, -1):
        out[:, c] = g
        g = local[:, c] + decay[:, c] * g
    return out


def selective_scan_bwd(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                       D: torch.Tensor, entering: torch.Tensor, g_y: torch.Tensor, g_state=None,
                       chunk: int = 64) -> tuple[torch.Tensor, ...]:
    """The gradient of :func:`selective_scan_states`'s (y, final state) at
    the cotangents ``g_y`` [B, S, C] and ``g_state`` [B, C, N] (None: 0),
    from the state entering each chunk of ``chunk`` steps ([B, chunks, C, N]).
    Returns (gu in u's type, gdt, gA, gB, gC, gD), float32 but gu.

    With a_t = exp(dt_t A) and b_t = dt_t u_t B_t, the state cotangent is
    the reverse scan gs_t = g_y_t (x) C_t + a_{t+1} gs_{t+1}, seeded by
    ``g_state`` at the last step; then gC_t = sum_c g_y_t s_t, gB_t =
    sum_c gs_t dt_t u_t, d(dt_t A) = gs_t s_{t-1} a_t, and gu, gdt, gA and
    gD follow, gA and gD summed over the batch and time."""
    B_, S, C = u.shape
    N = A.shape[1]
    nc, (uf, dtf, Bf, Cf, gyf) = _pad_steps(chunk, u, dt, Bm, Cm, g_y)
    L = chunk
    uc, dtc, gyc = (t.reshape(B_, nc, L, C) for t in (uf, dtf, gyf))
    Bc, Cc = Bf.reshape(B_, nc, L, N), Cf.reshape(B_, nc, L, N)
    Af = A.float()
    cum = torch.cumsum(dtc, 2)  # [B, c, L, C]: the products of a inside a chunk are exp(cum A)
    channels = _blocks(C, B_ * L * N, u.device)
    groups = _blocks(nc, B_ * L * (channels[0].stop - channels[0].start) * N, u.device)
    # 1. each chunk's share of the gradient of the state entering it,
    #    sum_t exp(cum_t A) g_y_t (x) C_t, and its decay exp(cum_L A)
    local = torch.empty(B_, nc, C, N, dtype=torch.float32, device=u.device)
    for ch in channels:
        for g in groups:
            local[:, g, ch] = torch.einsum("bqlcn,bqlc,bqln->bqcn", torch.exp(cum[:, g, :, ch, None] * Af[ch]),
                                           gyc[:, g, :, ch], Cc[:, g])
    # 2. the state cotangent leaving each chunk, carried back over the chunks
    carry = _carry_back(torch.exp(cum[:, :, -1, :, None] * Af), local, g_state)
    del local
    # 3. each chunk's intermediates again, from its entering state and carried cotangent
    gu, gdt = torch.empty_like(uc), torch.empty_like(dtc)
    gB, gC = torch.zeros_like(Bc), torch.zeros_like(Cc)  # sums over the channel blocks
    gA = torch.empty_like(Af)
    for ch in channels:
        gA[ch] = 0.0
        for g in groups:
            u_, dt_, gy_, B2, C2 = uc[:, g, :, ch], dtc[:, g, :, ch], gyc[:, g, :, ch], Bc[:, g], Cc[:, g]
            a = torch.exp(dt_[..., None] * Af[ch])  # [B, q, L, c, N]
            du = dt_ * u_
            prod, s = _doubling(a, du[..., None] * B2[:, :, :, None, :], 2)
            s = s + prod * entering[:, g, None, ch]
            del prod
            gC[:, g] += torch.einsum("bqlc,bqlcn->bqln", gy_, s)
            s_prev = torch.cat([entering[:, g, None, ch], s[:, :, :-1]], 2)
            del s
            # the reverse scan: step j of it is step L-1-j of the chunk, whose decay
            # is a_{L-j} (1 at j = 0, where the carried cotangent enters)
            alpha = torch.cat([torch.ones_like(a[:, :, :1]), a.flip(2)[:, :, :-1]], 2)
            prod, gs = _doubling(alpha, (gy_[..., None] * C2[:, :, :, None, :]).flip(2), 2)
            del alpha
            gs = (gs + prod * carry[:, g, None, ch]).flip(2)
            del prod
            q = gs * s_prev * a  # the cotangent of dt A
            del s_prev, a
            g_du = torch.einsum("bqlcn,bqln->bqlc", gs, B2)
            gB[:, g] += torch.einsum("bqlcn,bqlc->bqln", gs, du)
            del gs
            gdt[:, g, :, ch] = g_du * u_ + torch.einsum("bqlcn,cn->bqlc", q, Af[ch])
            gA[ch] += torch.einsum("bqlcn,bqlc->cn", q, dt_)
            gu[:, g, :, ch] = g_du * dt_ + gy_ * D.float()[ch]
            del q
    gD = torch.einsum("bqlc,bqlc->c", gyc, uc)
    unpad = lambda t, w: t.reshape(B_, nc * L, w)[:, :S]  # noqa: E731
    return unpad(gu, C).to(u.dtype), unpad(gdt, C), gA, unpad(gB, N), unpad(gC, N), gD


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                 entering: torch.Tensor, g_y: torch.Tensor, g_state=None,
                 chunk: int = 64) -> tuple[torch.Tensor, ...]:
    """The gradient of :func:`ssd_scan_phases`'s (y, final state) at the
    cotangents ``g_y`` [B, S, H, P] and ``g_state`` [B, H, N, P] (None: 0),
    from the state entering each chunk ([B, chunks, H, N, P]).  Returns (gx
    in x's type, gdt, gA, gB, gC), float32 but gx.

    A chunk's state leaves as exp(total) S_in + sum_s exp(total - cum_s) dt_s
    B_s (x) x_s, so the state cotangent G entering it from the right carries
    back as exp(total) G + sum_t exp(cum_t) C_t (x) g_y_t; inside the chunk
    the products of the forward's three phases are recomputed and
    differentiated, and the log-decay's cotangent goes back through
    cum = cumsum(dt A) as a reverse cumulative sum."""
    B_, S, H, P = x.shape
    N = Bm.shape[-1]
    L = chunk
    nc, (xf, dtf, Bf, Cf, gyf) = _pad_steps(chunk, x, dt, Bm, Cm, g_y)
    xc, gyc, dtc = xf.reshape(B_, nc, L, H, P), gyf.reshape(B_, nc, L, H, P), dtf.reshape(B_, nc, L, H)
    Bc, Cc = Bf.reshape(B_, nc, L, N), Cf.reshape(B_, nc, L, N)
    Af = A.float()
    cum = torch.cumsum(dtc.double() * A.double(), 2)  # [B, c, L, H], in float64 as the forward takes it
    total = cum[:, :, -1]
    ecum = cum.exp().float()
    # 1-2. the state cotangent leaving each chunk, carried back over the chunks
    local = torch.einsum("bclh,bcln,bclhp->bchnp", ecum, Cc, gyc)
    carry = _carry_back(total.exp().float()[..., None, None], local, g_state)
    del local
    # 3. each chunk's products again
    gx, gdt = torch.empty_like(xc), torch.empty_like(dtc)
    gB, gC = torch.empty_like(Bc), torch.empty_like(Cc)
    gA = torch.zeros_like(Af)
    mask = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    for g in _blocks(nc, B_ * L * L * H, x.device):
        x_, gy_, dt_, B2, C2 = xc[:, g], gyc[:, g], dtc[:, g], Bc[:, g], Cc[:, g]
        S_in, G = entering[:, g], carry[:, g]
        cm, tot, ec = cum[:, g], total[:, g], ecum[:, g]
        # y's share from the entering state: exp(cum_t) C_t . S_in
        g_cum = ec * torch.einsum("bcln,bchnp,bclhp->bclh", C2, S_in, gy_)
        gC_ = torch.einsum("bclh,bchnp,bclhp->bcln", ec, S_in, gy_)
        # the intra-chunk products: W_ij = exp(cum_i - cum_j) (C_i . B_j) dt_j for j <= i
        M = (cm[:, :, :, None, :] - cm[:, :, None, :, :]).float().masked_fill(~mask[:, :, None], float("-inf")).exp()
        CB = torch.einsum("bcin,bcjn->bcij", C2, B2)
        W = M * CB[..., None] * dt_[:, :, None]
        gW = torch.einsum("bcihp,bcjhp->bcijh", gy_, x_) * mask[:, :, None]
        gx_ = torch.einsum("bcijh,bcihp->bcjhp", W, gy_)
        gWM = gW * M
        del M
        gCB = torch.einsum("bcijh,bcjh->bcij", gWM, dt_)
        gC_ = gC_ + torch.einsum("bcij,bcjn->bcin", gCB, B2)
        gB_ = torch.einsum("bcij,bcin->bcjn", gCB, C2)
        gdt_ = torch.einsum("bcijh,bcij->bcjh", gWM, CB)
        del gWM
        gWW = gW * W
        del gW, W
        g_cum = g_cum + gWW.sum(3) - gWW.sum(2)
        del gWW
        # the state leaving: exp(total) S_in + sum_s v_s B_s (x) x_s, v_s = exp(total - cum_s) dt_s
        e_out = (tot[:, :, None] - cm).exp().float()
        v = e_out * dt_
        BG = torch.einsum("bcln,bchnp->bclhp", B2, G)
        gx_ = gx_ + v[..., None] * BG
        gv = (BG * x_).sum(-1)
        del BG
        gB_ = gB_ + torch.einsum("bclh,bchnp,bclhp->bcln", v, G, x_)
        gdt_ = gdt_ + gv * e_out
        g_tot = (gv * v).sum(2) + tot.exp().float() * (G * S_in).sum((-2, -1))
        g_cum = g_cum - gv * v
        g_cum[:, :, -1] += g_tot
        # cum = cumsum(dt A): the reverse cumulative sum
        g_dtA = g_cum.flip(2).cumsum(2).flip(2)
        gdt[:, g] = gdt_ + g_dtA * Af
        gA += torch.einsum("bclh,bclh->h", g_dtA, dt_)
        gx[:, g], gB[:, g], gC[:, g] = gx_, gB_, gC_
    unpad = lambda t, *w: t.reshape(B_, nc * L, *w)[:, :S]  # noqa: E731
    return unpad(gx, H, P).to(x.dtype), unpad(gdt, H), gA, unpad(gB, N), unpad(gC, N)
