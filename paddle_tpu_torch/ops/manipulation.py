"""Shape and indexing ops (counterpart of
``paddle_tpu/ops/manipulation.py``), each a torch forward registered
with ``core.dispatch``. Index outputs are int64 (the JAX package's are
int32). ``unique``, ``nonzero`` and ``masked_select`` have data-dependent
shapes and read their input on the host, as in the JAX package."""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core.dispatch import register_op
from ..core.dtype import convert_dtype
from ..core.tensor import wrap_outputs
from ._helpers import _op, static_int_list

__all__ = [
    "cast", "reshape", "transpose", "squeeze", "unsqueeze", "flatten",
    "concat", "stack", "split", "chunk", "tile", "expand", "expand_as",
    "broadcast_to", "broadcast_tensors", "flip", "rot90", "roll", "gather",
    "gather_nd", "scatter", "scatter_nd", "scatter_nd_add", "index_select",
    "index_sample", "index_add", "index_put", "masked_select",
    "masked_fill", "where", "take_along_axis", "put_along_axis", "slice",
    "strided_slice", "unbind", "unstack", "repeat_interleave", "t",
    "moveaxis", "as_strided", "topk", "sort", "argsort", "argmax", "argmin",
    "unique", "unique_consecutive", "nonzero", "one_hot", "pad", "crop",
    "shard_index", "tensordot", "searchsorted", "bucketize", "mode",
    "kthvalue", "tolist", "atleast_1d", "atleast_2d", "atleast_3d", "view",
    "view_as", "as_complex", "as_real",
]

_pyslice = builtins.slice


def _int(v):
    return int(v.item()) if isinstance(v, torch.Tensor) else int(v)


def cast(x, dtype):
    return _op("cast", x, dtype=convert_dtype(dtype))


register_op("cast", lambda x, dtype=torch.float32: x.to(dtype))


def reshape(x, shape, name=None):
    return _op("reshape", x, shape=static_int_list(shape))


register_op("reshape", lambda x, shape=(): torch.reshape(x, shape))
view = reshape


def view_as(x, other, name=None):
    return reshape(x, other.shape)


def transpose(x, perm, name=None):
    return _op("transpose", x, perm=static_int_list(perm))


register_op("transpose", lambda x, perm=(): torch.permute(x, perm))


def t(x, name=None):
    return _op("t", x)


register_op("t", lambda x: x.transpose(-1, -2) if x.dim() >= 2 else x.clone())


def moveaxis(x, source, destination, name=None):
    return _op("moveaxis", x, source=static_int_list(source),
               destination=static_int_list(destination))


register_op("moveaxis", lambda x, source=(), destination=():
            torch.movedim(x, source, destination))


def squeeze(x, axis=None, name=None):
    """Drop the size-1 axes of ``axis`` (every one for None); an axis whose
    size is not 1 is kept."""
    if axis is None:
        return _op("squeeze", x, axis=None)
    ax = tuple(a for a in static_int_list(axis) if x.shape[a] == 1)
    return _op("squeeze", x, axis=ax)


register_op("squeeze", lambda x, axis=None:
            torch.squeeze(x) if axis is None else
            (torch.squeeze(x, axis) if axis else x.view(x.shape)))


def unsqueeze(x, axis, name=None):
    return _op("unsqueeze", x, axis=static_int_list(axis))


def _unsqueeze_fwd(x, axis=()):
    nd = x.dim() + len(axis)
    for a in sorted(a % nd for a in axis):
        x = torch.unsqueeze(x, a)
    return x


register_op("unsqueeze", _unsqueeze_fwd)


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    return _op("flatten", x, start_axis=int(start_axis),
               stop_axis=int(stop_axis))


register_op("flatten", lambda x, start_axis=0, stop_axis=-1:
            x.reshape(1) if x.dim() == 0 else
            torch.flatten(x, start_axis, stop_axis))


def concat(x, axis=0, name=None):
    return _op("concat", list(x), axis=_int(axis))


register_op("concat", lambda xs, axis=0: torch.cat(xs, dim=axis))


def stack(x, axis=0, name=None):
    return _op("stack", list(x), axis=int(axis))


register_op("stack", lambda xs, axis=0: torch.stack(xs, dim=axis))


def split(x, num_or_sections, axis=0, name=None):
    """``num_or_sections`` an int: that many equal parts (the axis must
    divide); a list: the parts' sizes, one of them -1 for the rest."""
    axis = _int(axis)
    dim = x.shape[axis]
    if isinstance(num_or_sections, int):
        n = num_or_sections
        if dim % n != 0:
            raise ValueError(
                f"split: axis {axis} size {dim} is not divisible by num {n} "
                f"(pass explicit section sizes for uneven splits)")
        sizes = [dim // n] * n
    else:
        sizes = [_int(s) for s in num_or_sections]
        neg = [i for i, s in enumerate(sizes) if s < 0]
        if neg:
            sizes[neg[0]] = dim - builtins.sum(s for s in sizes if s >= 0)
    return list(_op("split", x, sizes=tuple(sizes), axis=axis))


register_op("split", lambda x, sizes=(), axis=0:
            tuple(torch.split(x, list(sizes), dim=axis)))


def chunk(x, chunks, axis=0, name=None):
    return split(x, int(chunks), axis)


def unbind(x, axis=0, name=None):
    return list(_op("unbind", x, axis=int(axis)))


register_op("unbind", lambda x, axis=0: tuple(torch.unbind(x, axis)))
unstack = unbind


def tile(x, repeat_times, name=None):
    return _op("tile", x, reps=static_int_list(repeat_times))


register_op("tile", lambda x, reps=(): torch.tile(x, reps))


def expand(x, shape, name=None):
    tgt = static_int_list(shape)
    lead = len(tgt) - x.dim()
    tgt = tuple(x.shape[i - lead] if s == -1 else s
                for i, s in enumerate(tgt))
    return _op("broadcast_to", x, shape=tgt)


def expand_as(x, y, name=None):
    return _op("broadcast_to", x, shape=tuple(y.shape))


def broadcast_to(x, shape, name=None):
    return _op("broadcast_to", x, shape=static_int_list(shape))


register_op("broadcast_to", lambda x, shape=(): torch.broadcast_to(x, shape))


def broadcast_tensors(inputs, name=None):
    shape = torch.broadcast_shapes(*[tuple(t.shape) for t in inputs])
    return [broadcast_to(t, shape) for t in inputs]


def flip(x, axis, name=None):
    return _op("flip", x, axis=static_int_list(axis))


register_op("flip", lambda x, axis=(): torch.flip(x, axis))


def rot90(x, k=1, axes=(0, 1), name=None):
    return _op("rot90", x, k=int(k), axes=tuple(int(a) for a in axes))


register_op("rot90", lambda x, k=1, axes=(0, 1): torch.rot90(x, k, axes))


def roll(x, shifts, axis=None, name=None):
    return _op("roll", x, shifts=static_int_list(shifts),
               axis=None if axis is None else static_int_list(axis))


register_op("roll", lambda x, shifts=(), axis=None:
            torch.roll(x, shifts, axis) if axis is not None
            else torch.roll(x, shifts))


def gather(x, index, axis=0, name=None):
    """Rows of ``x`` along ``axis`` at ``index`` (Paddle's gather is
    torch's ``index_select``)."""
    return _op("gather", x, index, axis=_int(axis))


register_op("gather", lambda x, index, axis=0:
            torch.index_select(x, axis, index.reshape(-1).long())
            if index.dim() != 0 else torch.select(x, axis, int(index)))


def gather_nd(x, index, name=None):
    return _op("gather_nd", x, index)


def _gather_nd_fwd(x, index):
    depth = index.shape[-1]
    flat = index.reshape(-1, depth).long()
    out = x[tuple(flat[:, i] for i in range(depth))]
    return out.reshape(tuple(index.shape[:-1]) + tuple(x.shape[depth:]))


register_op("gather_nd", _gather_nd_fwd)


def scatter(x, index, updates, overwrite=True, name=None):
    return _op("scatter", x, index, updates, overwrite=bool(overwrite))


def _scatter_fwd(x, index, updates, overwrite=True):
    idx = index.reshape(-1).long()
    if overwrite:
        return x.index_put((idx,), updates)
    zeroed = x.index_put((idx,), torch.zeros_like(updates))
    return zeroed.index_put((idx,), updates, accumulate=True)


register_op("scatter", _scatter_fwd)


def scatter_nd_add(x, index, updates, name=None):
    return _op("scatter_nd_add", x, index, updates)


def _scatter_nd_add_fwd(x, index, updates):
    depth = index.shape[-1]
    flat = index.reshape(-1, depth).long()
    vals = updates.reshape((flat.shape[0],) + tuple(x.shape[depth:]))
    return x.index_put(tuple(flat[:, i] for i in range(depth)), vals,
                       accumulate=True)


register_op("scatter_nd_add", _scatter_nd_add_fwd)


def scatter_nd(index, updates, shape, name=None):
    from .creation import zeros
    return scatter_nd_add(zeros(shape, updates.dtype), index, updates)


def index_select(x, index, axis=0, name=None):
    return _op("index_select", x, index, axis=int(axis))


register_op("index_select", lambda x, index, axis=0:
            torch.index_select(x, axis, index.reshape(-1).long()))


def index_sample(x, index, name=None):
    return _op("index_sample", x, index)


register_op("index_sample", lambda x, index:
            torch.gather(x, 1, index.long()))


def index_add(x, index, axis, value, name=None):
    return _op("index_add", x, index, value, axis=int(axis))


register_op("index_add", lambda x, index, value, axis=0:
            torch.index_add(x, axis, index.reshape(-1).long(), value))


def index_put(x, indices, value, accumulate=False, name=None):
    return _op("index_put", x, list(indices), value,
               accumulate=bool(accumulate))


register_op("index_put", lambda x, idx, value, accumulate=False:
            x.index_put(tuple(i.long() if i.dtype != torch.bool else i
                              for i in idx), value.to(x.dtype)
                        if torch.is_tensor(value) else
                        torch.as_tensor(value, dtype=x.dtype,
                                        device=x.device), accumulate))


def masked_select(x, mask, name=None):
    return _op("masked_select", x, mask)


register_op("masked_select", torch.masked_select)


def masked_fill(x, mask, value, name=None):
    if isinstance(value, torch.Tensor):
        return _op("masked_fill_t", x, mask, value)
    return _op("masked_fill", x, mask, value=value)


register_op("masked_fill", lambda x, mask, value=0.0:
            torch.masked_fill(x, mask, value))
register_op("masked_fill_t", lambda x, mask, value:
            torch.where(mask, value.to(x.dtype), x))


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    return _op("where", condition, x, y)


def _where_fwd(c, x, y):
    if not torch.is_tensor(x):
        x = torch.as_tensor(x, dtype=y.dtype if torch.is_tensor(y)
                            else None, device=c.device)
    if not torch.is_tensor(y):
        y = torch.as_tensor(y, dtype=x.dtype, device=c.device)
    return torch.where(c, x, y)


register_op("where", _where_fwd)


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    return _op("take_along_axis", arr, indices, axis=int(axis))


register_op("take_along_axis", lambda x, idx, axis=0:
            torch.take_along_dim(x, idx.long(), axis))


def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    return _op("put_along_axis", arr, indices, values, axis=int(axis),
               reduce=str(reduce))


def _put_along_axis_fwd(x, idx, values, axis=0, reduce="assign"):
    v = values if torch.is_tensor(values) else torch.full(
        tuple(idx.shape), values, dtype=x.dtype, device=x.device)
    v = torch.broadcast_to(v, idx.shape).to(x.dtype)
    idx = idx.long()
    if reduce == "add":
        return torch.scatter_add(x, axis, idx, v)
    if reduce in ("multiply", "mul"):
        return torch.scatter_reduce(x, axis, idx, v, "prod")
    return torch.scatter(x, axis, idx, v)


register_op("put_along_axis", _put_along_axis_fwd)


def slice(input, axes, starts, ends, name=None):
    return _op("slice", input, axes=static_int_list(axes),
               starts=static_int_list(starts), ends=static_int_list(ends))


def strided_slice(x, axes, starts, ends, strides, name=None):
    return _op("slice", x, axes=static_int_list(axes),
               starts=static_int_list(starts), ends=static_int_list(ends),
               strides=static_int_list(strides))


def _slice_fwd(x, axes=(), starts=(), ends=(), strides=None):
    idx = [_pyslice(None)] * x.dim()
    steps = strides or (1,) * len(axes)
    flips = []
    for ax, s, e, st in zip(axes, starts, ends, steps):
        n = x.shape[ax]
        if st > 0:
            idx[ax] = _pyslice(*_pyslice(s, e, st).indices(n))
        else:                       # torch slices step forward only
            picked = list(range(n))[_pyslice(s, e, st)]
            idx[ax] = _pyslice(picked[-1], picked[0] + 1, -st) if picked \
                else _pyslice(0, 0)
            flips.append(ax)
    out = x[tuple(idx)]
    return torch.flip(out, flips) if flips else out


register_op("slice", _slice_fwd)


def crop(x, shape=None, offsets=None, name=None):
    shape = static_int_list(shape)
    offsets = static_int_list(offsets) if offsets is not None \
        else (0,) * len(shape)
    ends = tuple(o + (s if s != -1 else x.shape[i] - o)
                 for i, (o, s) in enumerate(zip(offsets, shape)))
    return slice(x, tuple(range(len(shape))), offsets, ends)


def repeat_interleave(x, repeats, axis=None, name=None):
    return _op("repeat_interleave", x, repeats,
               axis=None if axis is None else int(axis))


register_op("repeat_interleave", lambda x, repeats, axis=None:
            torch.repeat_interleave(x, repeats, dim=axis))


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    return tuple(_op("topk", x, k=_int(k), axis=int(axis),
                     largest=bool(largest), sorted=bool(sorted)))


register_op("topk", lambda x, k=1, axis=-1, largest=True, sorted=True:
            tuple(torch.topk(x, k, axis, largest, sorted)))


def sort(x, axis=-1, descending=False, name=None):
    return _op("sort", x, axis=int(axis), descending=bool(descending))


register_op("sort", lambda x, axis=-1, descending=False:
            torch.sort(x, dim=axis, descending=descending, stable=True)[0])


def argsort(x, axis=-1, descending=False, name=None):
    return _op("argsort", x, axis=int(axis), descending=bool(descending))


def _argsort_fwd(x, axis=-1, descending=False):
    out = torch.argsort(x, dim=axis, stable=True)
    return torch.flip(out, (axis,)) if descending else out


register_op("argsort", _argsort_fwd)


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _op("argmax", x, axis=None if axis is None else int(axis),
               keepdim=bool(keepdim), dtype=convert_dtype(dtype))


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _op("argmin", x, axis=None if axis is None else int(axis),
               keepdim=bool(keepdim), dtype=convert_dtype(dtype))


register_op("argmax", lambda x, axis=None, keepdim=False, dtype=torch.int64:
            torch.argmax(x, axis, keepdim and axis is not None).to(dtype))
register_op("argmin", lambda x, axis=None, keepdim=False, dtype=torch.int64:
            torch.argmin(x, axis, keepdim and axis is not None).to(dtype))


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` (the smallest of a tie) and
    the last index where it stands."""
    arr = np.asarray(x.numpy())
    ax = axis % arr.ndim
    moved = np.moveaxis(arr, ax, -1)
    flat = moved.reshape(-1, moved.shape[-1])
    vals = np.empty(flat.shape[0], arr.dtype)
    idxs = np.empty(flat.shape[0], np.int64)
    for i, row in enumerate(flat):
        uniq, counts = np.unique(row, return_counts=True)
        v = uniq[np.argmax(counts)]
        vals[i] = v
        idxs[i] = np.where(row == v)[0][-1]
    vals = vals.reshape(moved.shape[:-1])
    idxs = idxs.reshape(moved.shape[:-1])
    if keepdim:
        vals, idxs = np.expand_dims(vals, ax), np.expand_dims(idxs, ax)
    return (wrap_outputs(torch.as_tensor(vals, device=x.device)),
            wrap_outputs(torch.as_tensor(idxs, device=x.device)))


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    return tuple(_op("kthvalue", x, k=int(k), axis=int(axis),
                     keepdim=bool(keepdim)))


def _kthvalue_fwd(x, k=1, axis=-1, keepdim=False):
    order = torch.argsort(x, dim=axis, stable=True)
    i = torch.narrow(order, axis, k - 1, 1)
    v = torch.gather(x, axis, i)
    if not keepdim:
        v, i = v.squeeze(axis), i.squeeze(axis)
    return v, i


register_op("kthvalue", _kthvalue_fwd)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    return _op("searchsorted", sorted_sequence, values,
               out_int32=bool(out_int32), right=bool(right))


register_op("searchsorted", lambda s, v, out_int32=False, right=False:
            torch.searchsorted(s, v, out_int32=out_int32, right=right))


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32, right)


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    arr = np.asarray(x.numpy())
    res = np.unique(arr, return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    if not (return_index or return_inverse or return_counts):
        return wrap_outputs(torch.as_tensor(res, device=x.device))
    dt = convert_dtype(dtype)
    return tuple(wrap_outputs(torch.as_tensor(
        r if i == 0 else r.reshape(-1), device=x.device).to(
            x.dtype if i == 0 else dt)) for i, r in enumerate(res))


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    out = torch.unique_consecutive(x.detach(), return_inverse=return_inverse,
                                   return_counts=return_counts, dim=axis)
    if isinstance(out, tuple):
        return tuple(wrap_outputs(o) for o in out)
    return wrap_outputs(out)


def nonzero(x, as_tuple=False, name=None):
    idx = torch.nonzero(x.detach())
    if as_tuple:
        return tuple(wrap_outputs(idx[:, i].contiguous())
                     for i in range(idx.shape[1]))
    return wrap_outputs(idx)


def one_hot(x, num_classes, name=None):
    return _op("one_hot", x, num_classes=int(num_classes))


register_op("one_hot", lambda x, num_classes=1:
            torch.nn.functional.one_hot(x.long(), num_classes).float())


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """``pad`` a pair per axis of ``x`` (first axis first), or a pair per
    spatial axis, last spatial axis first (``data_format`` says where the
    channels stand)."""
    return _op("pad", x, pad=static_int_list(pad), mode=str(mode),
               value=float(value), data_format=str(data_format))


def _pad_fwd(x, pad=(), mode="constant", value=0.0, data_format="NCHW"):
    nd = x.dim()
    if len(pad) == 2 * nd:
        cfg = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        cfg = [(0, 0)] * nd
        n_spatial = len(pad) // 2
        last = nd - 1 if data_format in ("NCHW", "NCL", "NCDHW") else nd - 2
        for i in range(n_spatial):
            cfg[last - i] = (pad[2 * i], pad[2 * i + 1])
    if mode == "constant":
        flat = [v for pair in reversed(cfg) for v in pair]
        return torch.nn.functional.pad(x, flat, value=value)
    # torch pads the trailing axes of a batched tensor: move them there
    moved = [d for d in range(nd) if cfg[d] != (0, 0)]
    keep = [d for d in range(nd) if cfg[d] == (0, 0)]
    y = x.permute(keep + moved).reshape((1, -1) + tuple(
        x.shape[d] for d in moved))
    flat = [v for d in reversed(moved) for v in cfg[d]]
    y = torch.nn.functional.pad(y, flat, mode={"replicate": "replicate",
                                               "reflect": "reflect",
                                               "circular": "circular"}[mode])
    y = y.reshape(tuple(x.shape[d] for d in keep) + tuple(y.shape[2:]))
    inv = np.argsort(keep + moved).tolist()
    return y.permute(inv)


register_op("pad", _pad_fwd)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    return _op("shard_index", input, index_num=int(index_num),
               nshards=int(nshards), shard_id=int(shard_id),
               ignore_value=int(ignore_value))


def _shard_index_fwd(x, index_num=1, nshards=1, shard_id=0, ignore_value=-1):
    size = (index_num + nshards - 1) // nshards
    return torch.where(torch.div(x, size, rounding_mode="floor") == shard_id,
                       torch.remainder(x, size),
                       torch.full_like(x, ignore_value))


register_op("shard_index", _shard_index_fwd)


def tensordot(x, y, axes=2, name=None):
    if isinstance(axes, torch.Tensor):
        axes = axes.tolist()
    if isinstance(axes, (list, tuple)):
        axes = tuple(tuple(a) if isinstance(a, (list, tuple)) else (a,)
                     for a in axes)
    return _op("tensordot", x, y, axes=axes)


register_op("tensordot", lambda x, y, axes=2: torch.tensordot(
    x, y, dims=axes if isinstance(axes, int) else [list(a) for a in axes]))


def atleast_1d(*inputs, name=None):
    outs = [reshape(x, (1,)) if x.dim() == 0 else x for x in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_2d(*inputs, name=None):
    outs = [reshape(x, (1, 1)) if x.dim() == 0 else
            unsqueeze(x, 0) if x.dim() == 1 else x for x in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_3d(*inputs, name=None):
    outs = []
    for x in inputs:
        y = atleast_2d(x)
        outs.append(unsqueeze(y, -1) if y.dim() == 2 else y)
    return outs[0] if len(outs) == 1 else outs


def as_complex(x, name=None):
    return _op("as_complex", x)


register_op("as_complex", lambda x: torch.view_as_complex(x.contiguous()))


def as_real(x, name=None):
    return _op("as_real", x)


register_op("as_real", torch.view_as_real)


def as_strided(x, shape, stride, offset=0, name=None):
    return _op("as_strided", x, shape=tuple(shape), stride=tuple(stride),
               offset=int(offset))


register_op("as_strided", lambda x, shape=(), stride=(), offset=0:
            torch.as_strided(x.contiguous(), shape, stride, offset).clone())


def tolist(x):
    return x.numpy().tolist()
