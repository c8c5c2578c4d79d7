"""Logical-axis -> mesh-axis sharding rules, as DTensor placements.

The production mesh axes are ("data", "model") single-pod and
("pod", "data", "model") multi-pod (``launch/mesh.py``).  Sharding policy:

  * batch            -> ("pod", "data")   pure DP across pods, DP within
  * TP dims          -> "model"           heads / ff / experts / vocab / d_inner
  * FSDP (ZeRO-3)    -> params' "embed" dim over fsdp_axes (cfg.fsdp);
                        large-MoE configs extend fsdp_axes to ("data","pod")
                        so 1T-param optimizer state fits device memory
  * activations      -> tokens over ("pod","data"), d_model over "model"

A spec is a :class:`Spec`: one entry per tensor dim, each None (replicated),
a mesh axis name, or a tuple of them (the dim split over their product),
compared entry by entry with the reference's ``PartitionSpec``.
:func:`to_placements` turns a spec into one DTensor placement per mesh dim.

Every spec function takes any ``mesh`` with ``.shape`` (axis -> size) and
``.axis_names``, or a ``DeviceMesh`` (its ``mesh_dim_names`` and sizes).
All helpers silently drop mesh axes that don't exist on the current mesh, so
the same model code runs on the single-pod, multi-pod and one-rank meshes.
:func:`constrain` and :func:`constrain_logical` redistribute a DTensor to the
repaired spec's placements; on a plain tensor, or with no mesh, they do
nothing, as the reference's do off-mesh.
"""
from __future__ import annotations

import contextvars
from contextlib import contextmanager
from typing import Optional, Sequence

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models import defs as D

BATCH_AXES = ("pod", "data")
TP_AXIS = "model"


class Spec(tuple):
    """A tuple of per-dim entries.  As ``PartitionSpec`` does, a one-name
    tuple entry is stored as the name itself."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def is_spec(x) -> bool:
    return isinstance(x, Spec)


def mesh_axes(mesh) -> dict:
    """axis name -> size, in mesh order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def axis_names(mesh) -> tuple:
    return tuple(mesh_axes(mesh))


# --------------------------------------------------------------------------- #
# parallelism policy: "tp" (default) uses the mesh's model axis for tensor
# parallelism; "dp" folds it into data parallelism + ZeRO-3.  Selected per
# (arch, shape) by launch.policy.parallelism_for.
# --------------------------------------------------------------------------- #

_POLICY: contextvars.ContextVar = contextvars.ContextVar("parallelism", default="tp")


@contextmanager
def parallelism(mode: str):
    assert mode in ("tp", "dp"), mode
    tok = _POLICY.set(mode)
    try:
        yield
    finally:
        _POLICY.reset(tok)


def current_parallelism() -> str:
    return _POLICY.get()


def _dp_mode() -> bool:
    return _POLICY.get() == "dp"


def fsdp_axes_for(cfg) -> tuple:
    """ZeRO-3 axes policy: large MoE shards params/optimizer over data AND
    pod (1T-param optimizer state cannot fit otherwise)."""
    if not getattr(cfg, "fsdp", False):
        return ()
    if getattr(cfg, "moe", None) is not None and cfg.moe.n_experts >= 64:
        return ("data", "pod")
    return ("data",)


# logical axis -> mesh axes (None = replicated). "embed" is resolved per-config.
_TP_AXES = {"vocab", "heads", "kv_heads", "ff", "experts", "d_inner"}


def _filter(mesh_axes_: Sequence[str], want) -> Optional[tuple]:
    """Keep only axes present on the mesh; None if nothing survives."""
    if want is None:
        return None
    if isinstance(want, str):
        want = (want,)
    got = tuple(a for a in want if a in mesh_axes_)
    return got or None


def logical_to_spec(axes: tuple, mesh_axes_: Sequence[str], fsdp_axes=()) -> Spec:
    """Map a tuple of logical axis names to a Spec (policy-aware).

    TP dims claim mesh axes FIRST (priority), then batch, then FSDP "embed" —
    so e.g. lm_head ("embed", "vocab") keeps vocab on "model" even when
    dp-mode extends the fsdp axes."""
    out: list = [None] * len(axes)
    used: set = set()
    dp = _dp_mode()

    def take(want):
        got = _filter(mesh_axes_, want)
        if got is None:
            return None
        got = tuple(a for a in got if a not in used)
        if not got:
            return None
        used.update(got)
        return got if len(got) > 1 else got[0]

    # pass 1: TP dims ("vocab" stays model-sharded even in dp-mode)
    for i, name in enumerate(axes):
        if name in _TP_AXES:
            if name == "vocab" or not dp:
                out[i] = take(TP_AXIS)
    # pass 2: batch
    for i, name in enumerate(axes):
        if name == "batch":
            out[i] = take(BATCH_AXES + ((TP_AXIS,) if dp else ()))
    # pass 3: fsdp embed
    for i, name in enumerate(axes):
        if name == "embed":
            out[i] = take(tuple(fsdp_axes) + ((TP_AXIS,) if dp and fsdp_axes else ()))
    return Spec(*out)


# logical dims whose mesh axis must NOT be relocated when it doesn't divide:
# moving "model" onto head_dim would reshard every attention product;
# replicating K/V/Q projections over model is the GQA-TP standard when
# kv_heads < TP degree.
_NO_RELOCATE = {"heads", "kv_heads"}


def _astuple(e) -> tuple:
    return () if e is None else (e if isinstance(e, tuple) else (e,))


def nshards(mesh, entry) -> int:
    sizes = mesh_axes(mesh)
    n = 1
    for a in _astuple(entry):
        n *= sizes.get(a, 1)
    return n


def repair_spec(spec, shape: tuple, mesh, axes_names: tuple = (), relocate: bool = True) -> Spec:
    """Make ``spec`` valid for ``shape``:

    1. drop any mesh-axis assignment whose shard count does not divide the
       dimension;
    2. relocate each dropped mesh axis onto the largest *free* dim that it
       does divide (granite's vocab 49155 -> d_model; decode caches ->
       sequence dim), EXCEPT axes dropped from head dims (_NO_RELOCATE),
       which replicate instead; with no free dim, extend an entry whose
       combined shard count still divides.
    """
    entries = list(spec) + [None] * (len(shape) - len(spec))
    names = tuple(axes_names) + (None,) * (len(shape) - len(axes_names))
    dropped = []
    for i, (e, dim) in enumerate(zip(entries, shape)):
        if e is not None and dim % nshards(mesh, e) != 0:
            if relocate and names[i] not in _NO_RELOCATE:
                dropped.append(e)
            entries[i] = None

    for e in dropped:
        frees = [(dim, i) for i, (ee, dim) in enumerate(zip(entries, shape))
                 if ee is None and dim % nshards(mesh, e) == 0 and dim > 1]
        if frees:
            _, i = max(frees)
            entries[i] = e
            continue
        exts = [(dim, i) for i, (ee, dim) in enumerate(zip(entries, shape))
                if ee is not None and not set(_astuple(ee)) & set(_astuple(e))
                and dim % (nshards(mesh, ee) * nshards(mesh, e)) == 0]
        if exts:
            _, i = max(exts)
            entries[i] = _astuple(entries[i]) + _astuple(e)
    return Spec(*entries)


def param_specs(defs, mesh, fsdp_axes=()):
    """Spec tree for a ParamDef tree (divisibility-repaired)."""
    ax = axis_names(mesh)
    return D.map_defs(lambda d: repair_spec(logical_to_spec(d.axes, ax, fsdp_axes), d.shape, mesh, d.axes), defs)


def batch_spec(mesh, extra_dims: int = 1) -> Spec:
    """[B, ...] tokens: batch over ("pod","data"[,"model" in dp]), rest replicated."""
    b = _filter(axis_names(mesh), BATCH_AXES + ((TP_AXIS,) if _dp_mode() else ()))
    return Spec(b, *([None] * extra_dims))


def activation_spec(mesh) -> Spec:
    """[B, S, d] hidden state: (pod,data) on batch, model on d."""
    ax = axis_names(mesh)
    return Spec(_filter(ax, BATCH_AXES), None, _filter(ax, TP_AXIS))


# --------------------------------------------------------------------------- #
# specs -> DTensor placements
# --------------------------------------------------------------------------- #


def to_placements(spec, mesh) -> tuple:
    """One placement per mesh dim: ``Shard(d)`` where the mesh axis appears in
    dim d's entry, else ``Replicate()``.  An entry naming several axes is
    split in mesh-dim order (DTensor's nesting), whatever the entry's order.
    A mesh dim of size 1 is ``Replicate()`` always: the same layout, which
    DTensor's view rules take without a redistribution."""
    where = {}
    for d, e in enumerate(spec):
        for a in _astuple(e):
            where[a] = d
    return tuple(Shard(where[a]) if a in where and n > 1 else Replicate() for a, n in mesh_axes(mesh).items())


class NamedPlacements:
    """A spec on a mesh (the counterpart of ``NamedSharding``): where a leaf
    of a restored or distributed tree goes.  Not a tuple, so a tree of them
    keeps its leaves."""

    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, Spec(*spec)

    @property
    def placements(self) -> tuple:
        return to_placements(self.spec, self.mesh)

    def __repr__(self) -> str:
        return f"NamedPlacements({self.spec!r}, {self.placements!r})"


def shard_ranges(x) -> list:
    """Per dim of a DTensor, the [start, stop) of the global index range this
    rank's shard holds (even splits, nested in mesh-dim order)."""
    ranges = [(0, n) for n in x.shape]
    coord = x.device_mesh.get_coordinate()
    for mdim, p in enumerate(x.placements):
        if p.is_shard():
            a, b = ranges[p.dim]
            step = (b - a) // x.device_mesh.size(mdim)
            ranges[p.dim] = (a + coord[mdim] * step, a + (coord[mdim] + 1) * step)
    return ranges


def local_shape(spec, shape: tuple, mesh) -> tuple:
    """The per-rank shard shape of a ``shape`` tensor under ``spec`` (every
    entry divides: a repaired spec)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    return tuple(dim // nshards(mesh, e) for e, dim in zip(entries, shape))


def distribute(x, mesh, spec):
    """A plain tensor (real or meta) -> a DTensor laid out by ``spec`` on a
    ``DeviceMesh``.  Every rank holds the whole tensor and keeps its shard: no
    communication (a meta tensor's shard is a meta tensor)."""
    if isinstance(x, DTensor):
        return x.redistribute(mesh, to_placements(spec, mesh))
    placements = to_placements(spec, mesh)
    local = x
    coord = mesh.get_coordinate()
    for mdim, p in enumerate(placements):
        if p.is_shard():
            n = mesh.size(mdim)
            step = local.shape[p.dim] // n
            local = local.narrow(p.dim, coord[mdim] * step, step)
    if x.device.type != "meta":
        local = local.contiguous()
    else:
        local = local.new_empty(local.shape)
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=x.shape,
                              stride=x.stride() if x.is_contiguous() else None)


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def einsum(subscripts: str, a, b):
    """``torch.einsum`` of two operands; on DTensors a ``local_map`` of the
    product over each rank's shards, laid out mesh dim by mesh dim as tensor
    and data parallelism have it (first rule that applies):

      1. a split on a letter both operands and the output have (a batch):
         both split on it, the output too;
      2. a split on a letter of its own (a's batch or sequence): b whole on
         that mesh dim (an FSDP gather), the output split;
      3. b split on a contracted letter: a split on it too (row-parallel),
         the output a partial sum;
      4. b split on a letter of its own: a whole (column-parallel), the
         output split;
      5. otherwise both whole.

    An operand's gradient is a partial sum on a mesh dim where the other is
    split on a letter it lacks.  DTensor's own einsum instead decomposes into
    views and batched products whose split dims it must describe as strided
    shards, or refuses (the reshapes of split dims)."""
    if not (is_dtensor(a) or is_dtensor(b)):
        return torch.einsum(subscripts, a, b)
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    mesh = a.device_mesh if is_dtensor(a) else b.device_mesh
    a, b = (t if is_dtensor(t) else DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
            for t in (a, b))
    xs, rest = subscripts.split(",")
    ws, out = rest.split("->")
    pa, pb, po, ga, gb = [], [], [], [], []
    for i in range(mesh.ndim):
        la = xs[a.placements[i].dim] if isinstance(a.placements[i], Shard) else None
        lb = ws[b.placements[i].dim] if isinstance(b.placements[i], Shard) else None
        if la is not None and la in ws and la in out or (la is None and lb is not None and lb in xs and lb in out):
            letter = la if la is not None else lb  # 1: a shared batch letter
            want = (Shard(xs.index(letter)), Shard(ws.index(letter)), Shard(out.index(letter)))
        elif la is not None and la not in ws:  # 2
            want = (Shard(xs.index(la)), Replicate(), Shard(out.index(la)))
        elif lb is not None and lb in xs:  # 3: contracted (a batch letter took rule 1)
            want = (Shard(xs.index(lb)), Shard(ws.index(lb)), Partial())
        elif lb is not None:  # 4
            want = (Replicate(), Shard(ws.index(lb)), Shard(out.index(lb)))
        else:  # 5
            want = (Replicate(), Replicate(), Replicate())
        pa.append(want[0])
        pb.append(want[1])
        po.append(want[2])
        sa = xs[want[0].dim] if isinstance(want[0], Shard) else None
        sb = ws[want[1].dim] if isinstance(want[1], Shard) else None
        ga.append(Partial() if sb is not None and sb not in xs else want[0])
        gb.append(Partial() if sa is not None and sa not in ws else want[1])
    fn = local_map(lambda x, y: torch.einsum(subscripts, x, y), out_placements=po,  # a list: one output
                   in_placements=(tuple(pa), tuple(pb)), in_grad_placements=(tuple(ga), tuple(gb)),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(a, b)


def pad(x, widths: tuple):
    """``F.pad(x, widths)`` (zeros); on a DTensor, each rank pads its shard,
    the padded dims first made whole."""
    import torch.nn.functional as F

    if not is_dtensor(x):
        return F.pad(x, widths)
    dims = [x.ndim - 1 - i // 2 for i in range(len(widths)) if widths[i]]
    pl = [Replicate() if p.is_shard() and p.dim in dims else p for p in x.placements]
    if tuple(pl) != tuple(x.placements):
        x = x.redistribute(x.device_mesh, pl)
    shape = list(x.shape)
    for i in range(0, len(widths), 2):
        shape[x.ndim - 1 - i // 2] += widths[i] + widths[i + 1]
    local = F.pad(x.to_local(), widths)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, x.device_mesh, pl, run_check=False, shape=torch.Size(shape), stride=stride)


def unsplit(x, dim: int):
    """A DTensor with its ``dim`` made whole on every mesh dim that splits it
    (an all-gather); anything else as it is."""
    if not is_dtensor(x):
        return x
    dim = dim % x.ndim
    pl = [Replicate() if p.is_shard(dim) else p for p in x.placements]
    return x if tuple(pl) == tuple(x.placements) else x.redistribute(x.device_mesh, pl)


def reduce_partial(x):
    """A DTensor's pending partial sums (a vocab-parallel lookup's masked
    ones) reduced: each partial placement made replicate.  Anything else as it is."""
    if is_dtensor(x) and any(p.is_partial() for p in x.placements):
        return x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p for p in x.placements])
    return x


def reshape(x, *shape):
    """``x.reshape(*shape)``; a DTensor whose split cannot carry over (a
    split dim reshaped into pieces the split does not divide, as 32 heads of
    a [H*hd, d] weight over 64 ranks) first gathers the dims that change,
    and its gradient is laid out as the output was before it is viewed back."""
    if not is_dtensor(x):
        return x.reshape(*shape)
    return _Reshape.apply(x, tuple(shape))


def _gathered_reshape(x, shape: tuple):
    """Reshape a DTensor, first gathering a split that the reshape would
    merge into an outer dim (DTensor could only describe the result as a
    strided shard) and, if the reshape still refuses, every split dim it
    changes."""
    old, new = tuple(x.shape), tuple(shape)
    lo = 0
    while lo < min(len(old), len(new)) and old[lo] == new[lo]:
        lo += 1
    hi = 0
    while hi < min(len(old), len(new)) - lo and old[-1 - hi] == new[-1 - hi]:
        hi += 1
    pl = [Replicate() if p.is_shard() and lo < p.dim < len(old) - hi else p for p in x.placements]
    if tuple(pl) != tuple(x.placements):
        x = x.redistribute(x.device_mesh, pl)
    try:
        return x.reshape(*shape)
    except RuntimeError:
        pl = [Replicate() if p.is_shard() and lo <= p.dim < len(old) - hi else p for p in x.placements]
        return x.redistribute(x.device_mesh, pl).reshape(*shape)


class _Reshape(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shape):
        y = _gathered_reshape(x, shape)
        ctx.shape, ctx.placements = tuple(x.shape), tuple(y.placements)
        return y

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return _gathered_reshape(g, ctx.shape), None


def _redistribute(x, mesh, spec):
    placements = to_placements(spec, mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def constrain(x, mesh, *axes):
    """Redistribute a DTensor to mesh-axis names per dim; no-op off-mesh or
    on a plain tensor.

    Drops (without relocation) any axis whose shard count does not divide
    the dimension.
    """
    if mesh is None or not is_dtensor(x):
        return x
    if _dp_mode():
        # model axis joins the batch axes; feature dims unshard
        def tr(a):
            if a == TP_AXIS or a == (TP_AXIS,):
                return None
            if isinstance(a, tuple) and set(a) <= set(BATCH_AXES):
                return tuple(a) + (TP_AXIS,)
            return a

        axes = tuple(tr(a) for a in axes)
    ax = axis_names(mesh)
    spec = repair_spec(Spec(*(_filter(ax, a) for a in axes)), tuple(x.shape), mesh, relocate=False)
    return _redistribute(x, mesh, spec)


def constrain_logical(x, mesh, *names):
    """Policy-aware activation constraint using LOGICAL axis names
    ("batch"/"vocab"/"heads"/...), repaired against x.shape with relocation
    on: a non-dividing vocab axis moves to the batch/seq dims."""
    if mesh is None or not is_dtensor(x):
        return x
    spec = logical_to_spec(tuple(names), axis_names(mesh), ())
    spec = repair_spec(spec, tuple(x.shape), mesh, tuple(names), relocate=True)
    return _redistribute(x, mesh, spec)
