"""Mesh context for in-model sharding pins, and the local regions.

Port of `repro.sharding.ctx`.  The launchers install the active mesh and
its data-parallel axis names here (`mesh_context`); model code pins the
batch dim (`constrain_batch`) or a dim on one mesh axis
(`constrain_axis`) at the reference's points.  Where the reference's pin
is a `with_sharding_constraint`, the port's is a `DTensor.redistribute`.
Outside a mesh context, and on plain tensors, every call is a no-op, so
the single-device model runs unchanged.

DTensor runs most of the model by sharding propagation.  Where an
operation's sharded form is not what the step needs (a reshape that
would split a head over two ranks, attention through the K6 extension,
the KV cache's in-place writes, the MoE routing over every token, the
SSM scans), the model runs that part in a *local region* (`local`): the
inputs are redistributed to a named layout, the function runs on each
rank's local tensors (plain tensors: a DTensor never reaches a CUDA
extension), and its outputs are wrapped back with the layout's
placements.  A layout maps tensor dims to "dp" (the context's
data-parallel axes) or "model"; an output's layout may also name an axis
under `PARTIAL`, whose ranks then hold partial sums (a row-parallel
product's) that DTensor's redistribution reduces, forward and backward.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

_state = threading.local()
PARTIAL = "partial"     # layout key: the output is a partial sum on that axis


def _get():
    return getattr(_state, "mesh", None), getattr(_state, "dp", ())


def active_mesh():
    """The mesh of the innermost `mesh_context`, or None."""
    return _get()[0]


@contextlib.contextmanager
def mesh_context(mesh, dp_axes: Sequence[str]):
    """Install ``mesh`` and its data-parallel axis names (("data",) or
    ("pod", "data")) while the block runs."""
    old = _get()
    names = tuple(mesh.mesh_dim_names)
    _state.mesh, _state.dp = mesh, tuple(a for a in dp_axes if a in names)
    try:
        yield
    finally:
        _state.mesh, _state.dp = old


@contextlib.contextmanager
def suspended():
    """Disable the data-parallel pins inside a scope (the fed step's
    per-node local SGD, whose node axis is split over the dp axes
    already).  Model-axis pins (`constrain_axis`) stay active."""
    old_dp = getattr(_state, "dp", ())
    _state.dp = ()
    try:
        yield
    finally:
        _state.dp = old_dp


def is_dtensor(x) -> bool:
    if not isinstance(x, torch.Tensor) or type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def _size(mesh, axes) -> int:
    shape = dict(zip(_names(mesh), tuple(mesh.shape)))
    n = 1
    for a in axes:
        n *= shape[a]
    return n


def dp_axes_of(mesh) -> Tuple[str, ...]:
    """The data-parallel axes in force on ``mesh``: the context's when it
    is this mesh, else every axis but "model"."""
    cur, dp = _get()
    if cur is mesh:
        return dp
    return tuple(a for a in _names(mesh) if a != "model")


def model_size(x) -> int:
    """The size of the "model" axis of ``x``'s mesh (1 off a mesh)."""
    if not is_dtensor(x) or "model" not in _names(x.device_mesh):
        return 1
    return _size(x.device_mesh, ("model",))


def _redistribute(x, placements):
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def constrain_axis(x, dim: int, axis: str = "model"):
    """Pin dim ``dim`` of ``x`` to mesh axis ``axis``; the other mesh
    dims keep their placement unless it shards the same dim.  No-op
    outside a mesh context, on a plain tensor, or when the dim does not
    divide."""
    mesh = active_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    m = x.device_mesh
    names = _names(m)
    if axis not in names:
        return x
    dim = dim % x.ndim if x.ndim else 0
    if x.ndim <= dim or x.shape[dim] % _size(m, (axis,)) != 0:
        return x
    from torch.distributed.tensor import Replicate, Shard
    pl = []
    for name, p in zip(names, x.placements):
        if name == axis:
            pl.append(Shard(dim))
        elif p.is_shard(dim) or p.is_partial():
            pl.append(Replicate())
        else:
            pl.append(p)
    return _redistribute(x, pl)


def constrain_batch(x, batch_dim: int = 0):
    """Pin dim ``batch_dim`` of ``x`` (or of every leaf of a dict tree)
    to the data-parallel axes; the model axis keeps its placement unless
    it shards the same dim.  No-op outside a mesh context, on plain
    tensors, or when the dim does not divide."""
    mesh, dp = _get()
    if mesh is None or not dp:
        return x
    if isinstance(x, dict):
        return {k: constrain_batch(v, batch_dim) for k, v in x.items()}
    if not is_dtensor(x) or x.ndim <= batch_dim:
        return x
    m = x.device_mesh
    axes = tuple(a for a in dp if a in _names(m))
    if not axes or x.shape[batch_dim] % _size(m, axes) != 0:
        return x
    from torch.distributed.tensor import Replicate, Shard
    pl = []
    for name, p in zip(_names(m), x.placements):
        if name in axes:
            pl.append(Shard(batch_dim))
        elif p.is_shard(batch_dim) or p.is_partial():
            pl.append(Replicate())
        else:
            pl.append(p)
    return _redistribute(x, pl)


# ---------------------------------------------------------------------------
# Layouts and local regions
# ---------------------------------------------------------------------------

def placements(mesh, layout: Optional[Dict[int, str]], shape) -> tuple:
    """Placements of a tensor of ``shape`` in ``layout`` ({dim: "dp" or
    "model"}): Shard on the named axes where the dim divides over them,
    Replicate elsewhere (None: replicated on every axis)."""
    from torch.distributed.tensor import Replicate, Shard
    names = _names(mesh)
    pl = [Replicate() for _ in names]
    for dim, which in (layout or {}).items():
        axes = _axes(mesh, which)
        if dim == PARTIAL or not axes or shape[dim] % _size(mesh, axes):
            continue
        for a in axes:
            pl[names.index(a)] = Shard(dim)
    return tuple(pl)


def _axes(mesh, which: str) -> Tuple[str, ...]:
    """The mesh axes a layout entry names: the data-parallel ones for
    "dp", else the axis itself (none when the mesh lacks it)."""
    axes = dp_axes_of(mesh) if which == "dp" else (which,)
    return tuple(a for a in axes if a in _names(mesh))


def to_layout(x, layout: Optional[Dict[int, str]]):
    """``x`` redistributed to ``layout`` (plain tensors pass through)."""
    if not is_dtensor(x):
        return x
    return _redistribute(x, placements(x.device_mesh, layout, x.shape))


def weight(w):
    """A weight as a layer reads it: its FSDP shards gathered (every
    placement but the "model" axis's made Replicate), as FSDP gathers a
    layer's weights before its forward; the backward reduce-scatters the
    grad back onto the shards."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    pl = tuple(p if n == "model" and not p.is_partial() else Replicate()
               for n, p in zip(_names(w.device_mesh), w.placements))
    return _redistribute(w, pl)


def placed_as(x, ref):
    """``x`` redistributed to ``ref``'s placements (a state handed back in
    the placement it came in); as it is unless both are DTensors."""
    if not (is_dtensor(x) and is_dtensor(ref)):
        return x
    return _redistribute(x, ref.placements)


def like(t: torch.Tensor, ref):
    """A plain tensor computed identically on every rank (positions, RoPE
    angles) as a replicated DTensor on ``ref``'s mesh, so it can meet
    ``ref`` in an operation; as it is when ``ref`` is plain."""
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    m = ref.device_mesh
    return DTensor.from_local(t, m, [Replicate()] * m.ndim, run_check=False)


def shard_heads(x, n_heads: int, n_kv_heads: int) -> bool:
    """Can the heads of ``x`` split over its mesh's "model" axis without
    cutting a head or a GQA group?  Both head counts must divide (on a
    "model" axis of one, Shard and Replicate hold the same data, and
    Shard matches a cache placed with its kv-heads on "model")."""
    if not is_dtensor(x) or "model" not in _names(x.device_mesh):
        return False
    m = model_size(x)
    return n_heads % m == 0 and n_kv_heads % m == 0


def heads(x, shard: bool):
    """A (B, S, heads·hd) projection in the layout its (B, S, heads, hd)
    view needs: batch on dp, and the feature dim on "model" only when
    ``shard`` (whole heads per rank); otherwise gathered, since DTensor
    cannot view a dim whose shards cut a head."""
    if not is_dtensor(x):
        return x
    return to_layout(x, {0: "dp", x.ndim - 1: "model"} if shard
                     else {0: "dp"})


def _tmap(fn, x):
    if isinstance(x, dict):
        return {k: _tmap(fn, v) for k, v in x.items()}
    return fn(x)


def _tleaves(x):
    if isinstance(x, dict):
        return [y for v in x.values() for y in _tleaves(v)]
    return [x]


def _per_leaf(lay) -> bool:
    """Is ``lay`` a tree of layouts keyed as its arg's dict (rather than
    one layout for every leaf)?"""
    return isinstance(lay, dict) and any(
        isinstance(k, str) and k != PARTIAL for k in lay)


def _lmap(fn, x, lay):
    """``fn(leaf, its layout)`` over a tensor or dict tree ``x``, with one
    layout for every leaf or a tree of them (`_per_leaf`)."""
    if isinstance(x, dict):
        return {k: _lmap(fn, v, lay[k] if _per_leaf(lay) else lay)
                for k, v in x.items()}
    return fn(x, lay)


def _lpairs(x, lay):
    """(leaf, its layout) pairs of ``x``, as `_lmap` pairs them."""
    if isinstance(x, dict):
        return [pr for k, v in x.items()
                for pr in _lpairs(v, lay[k] if _per_leaf(lay) else lay)]
    return [(x, lay)]


def local(fn: Callable, args: Sequence, layouts: Sequence,
          out_layouts):
    """Run ``fn`` on each rank's local tensors.

    ``args`` (tensors, or dict trees of them) are redistributed to
    ``layouts`` (one per arg: a layout for every leaf, or a tree of
    layouts keyed as the arg's dicts; non-tensors and plain tensors pass
    as they are), ``fn`` gets the local tensors, and its outputs (a
    tensor, a dict tree, or a tuple of them) come back as DTensors in
    ``out_layouts`` (one layout, or one per output, each a layout or a
    tree of them).  An output dim named "dp" or "model" is sharded when
    that axis sharded an input, so a dim too small to split stays
    replicated in and out; an output whose layout names an axis under
    `PARTIAL` holds a partial sum on it when that axis sharded an input.

    Autograd: an input replicated on an axis that shards another input
    is used by ranks that see different data, so its grad comes back as
    a partial sum on that axis (reduced by the redistribution's
    backward); elsewhere the grad keeps the input's placements.  Without
    a DTensor among ``args`` this is ``fn(*args)``."""
    ref = next((y for a in args for y in _tleaves(a) if is_dtensor(y)),
               None)
    if ref is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = ref.device_mesh
    names = _names(mesh)
    moved = [_lmap(to_layout, a, lay) for a, lay in zip(args, layouts)]
    used, varying = set(), set()
    for a, lay in zip(moved, layouts):
        for y, ly in _lpairs(a, lay):
            if not is_dtensor(y):
                continue
            for i, p in enumerate(y.placements):
                if p.is_shard():
                    varying.add(i)
            for dim, which in (ly or {}).items():
                if dim != PARTIAL and any(
                        y.placements[names.index(x)] == Shard(dim)
                        for x in _axes(mesh, which)):
                    used.add(which)

    def unwrap(y):
        if not is_dtensor(y):
            return y
        grad = tuple(Partial() if i in varying and p == Replicate() else p
                     for i, p in enumerate(y.placements))
        return y.to_local(grad_placements=grad)

    out = fn(*[_tmap(unwrap, a) for a in moved])

    def wrap(t, lay):
        if not isinstance(t, torch.Tensor):
            return t
        pl = [Replicate() for _ in names]
        for dim, which in (lay or {}).items():
            if which not in used:
                continue
            for x in _axes(mesh, which):
                pl[names.index(x)] = Partial() if dim == PARTIAL \
                    else Shard(dim)
        return DTensor.from_local(t, mesh, pl, run_check=False)

    if isinstance(out, tuple):
        lays = out_layouts if isinstance(out_layouts, (list, tuple)) \
            else [out_layouts] * len(out)
        return tuple(_lmap(wrap, o, lay) for o, lay in zip(out, lays))
    return _lmap(wrap, out, out_layouts)


def embedding(w, tokens):
    """The rows of a (V, d) table ``w`` (a DTensor) at ``tokens``, batch on
    the data axes and replicated on "model".  A vocab-sharded table
    looks up each rank's own rows (zeros elsewhere) and sums them over
    "model": the rows are the unsharded lookup's, exactly (one nonzero
    term per element)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    w = weight(w)
    mesh = w.device_mesh
    names = _names(mesh)
    mi = names.index("model") if "model" in names else None
    if mi is None or not w.placements[mi].is_shard(0):
        return local(lambda t, w: w[t.long()], (tokens, w),
                     [{0: "dp"}, None], {0: "dp"})
    tokens = to_layout(tokens, {0: "dp"})
    dp_dims = [i for i, p in enumerate(tokens.placements) if p.is_shard()]
    wl = w.to_local(grad_placements=tuple(
        Partial() if i in dp_dims else p for i, p in enumerate(w.placements)))
    v0 = mesh.get_coordinate()[mi] * wl.shape[0]
    t = tokens.to_local().long() - v0
    inside = (t >= 0) & (t < wl.shape[0])
    rows = wl[torch.where(inside, t, 0)] * inside[..., None].to(wl.dtype)
    pl = [Shard(0) if i in dp_dims else Replicate()
          for i in range(len(names))]
    pl[mi] = Partial()
    out = DTensor.from_local(rows, mesh, pl, run_check=False)
    return _redistribute(out, [Replicate() if i == mi else p
                               for i, p in enumerate(pl)])


def local_box(shape, mesh, placements):
    """(local shape, global offset) of this rank's shard of a tensor of
    ``shape`` placed so: each Shard(d) splits dim d as `torch.chunk`
    does, mesh dims in order.  Plain integer arithmetic (DTensor's own
    helper builds tensors, which a fake-tensor trace cannot read)."""
    coord = mesh.get_coordinate()
    shape, offset = list(shape), [0] * len(shape)
    for i, p in enumerate(placements):
        if p.is_replicate():
            continue
        if not p.is_shard():
            raise ValueError(f"no local box for placement {p}")
        d, n = p.dim, mesh.size(i)
        chunk = -(-shape[d] // n)
        offset[d] += coord[i] * chunk
        shape[d] = max(0, min(chunk, shape[d] - coord[i] * chunk))
    return tuple(shape), tuple(offset)


def same_placement(a, b) -> bool:
    """Two DTensors on one mesh with the same placements: a local region
    that read ``b`` in ``a``'s layout worked on ``b``'s own local tensor
    (`to_layout` returns it as it is), so in-place writes landed in it."""
    return is_dtensor(a) and is_dtensor(b) \
        and a.device_mesh == b.device_mesh \
        and tuple(a.placements) == tuple(b.placements)


def write(dst, src) -> None:
    """``dst.copy_(src)`` with ``src`` first redistributed to ``dst``'s
    placements (a cache slot written from a step's layout)."""
    dst.copy_(placed_as(src, dst))
