"""
Lightweight labeled arrays for marex_tpu.

The reference framework exposes its API through xarray + dask
(``marEx/detect.py``, ``marEx/track.py``). This rebuild keeps the
*labeled-dimension* programming model but owns the container: a thin,
immutable-ish :class:`Field` (DataArray-analogue) and :class:`FieldSet`
(Dataset-analogue) whose payloads are plain ``numpy`` or ``jax.Array`` buffers
that move to device untouched. xarray interop happens only at the edges
(:func:`from_xarray` / :meth:`Field.to_xarray`), gated on availability.

Design rules:
  * no lazy graphs — compute is staged explicitly through jitted ops;
  * ``.persist()/.compute()/.chunk()`` exist as no-op compatibility shims so
    scripts written against the reference API keep working;
  * coords are 1-D (or small N-D) host numpy arrays; bulk data may live on
    device.
"""

from __future__ import annotations

import operator
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from .._dependencies import has_dependency
from ..exceptions import DataValidationError

ArrayLike = Any  # np.ndarray | jax.Array


def _is_jax(x: Any) -> bool:
    return type(x).__module__.startswith("jax")


def _asnumpy(x: Any) -> np.ndarray:
    if isinstance(x, np.ndarray):
        return x
    return np.asarray(x)


class Coord:
    """A named coordinate: values along one or more dims (host numpy)."""

    __slots__ = ("dims", "values")

    def __init__(self, dims: Union[str, Tuple[str, ...]], values: ArrayLike):
        if isinstance(dims, str):
            dims = (dims,)
        self.dims = tuple(dims)
        self.values = _asnumpy(values)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Coord(dims={self.dims}, shape={self.values.shape}, dtype={self.values.dtype})"

    def isel(self, indexers: Mapping[str, Any]) -> "Coord":
        idx = tuple(indexers.get(d, slice(None)) for d in self.dims)
        vals = self.values[idx]
        # Drop dims that were integer-indexed
        new_dims = tuple(d for d, i in zip(self.dims, idx) if not np.isscalar(i) and not isinstance(i, int))
        return Coord(new_dims, vals) if new_dims else Coord((), vals)


def _normalize_coords(coords: Optional[Mapping[str, Any]], dims: Tuple[str, ...], shape: Tuple[int, ...]) -> Dict[str, Coord]:
    out: Dict[str, Coord] = {}
    if not coords:
        return out
    sizes = dict(zip(dims, shape))
    for name, val in coords.items():
        if isinstance(val, Coord):
            out[name] = val
        elif isinstance(val, Field):
            out[name] = Coord(val.dims, val.values)
        elif isinstance(val, tuple) and len(val) == 2 and isinstance(val[0], (str, tuple, list)):
            out[name] = Coord(tuple(val[0]) if not isinstance(val[0], str) else val[0], val[1])
        else:
            arr = _asnumpy(val)
            if arr.ndim == 0:
                out[name] = Coord((), arr)
            elif name in sizes and arr.shape == (sizes[name],):
                out[name] = Coord(name, arr)
            else:
                # try match by length against dims
                matched = [d for d in dims if sizes[d] == arr.shape[0]] if arr.ndim == 1 else []
                if arr.ndim == 1 and name in dims:
                    out[name] = Coord(name, arr)
                elif len(matched) == 1:
                    out[name] = Coord(matched[0], arr)
                else:
                    raise DataValidationError(
                        f"Cannot infer dims for coordinate '{name}'",
                        details=f"coord shape {arr.shape} vs dims {sizes}",
                        suggestions=["Pass coords as {'name': (dims, values)}"],
                    )
    # xarray parity: an index coordinate whose length conflicts with the
    # data's dimension size is an error, not a silent mismatch (a broadcast
    # bug upstream otherwise propagates a collapsed axis all the way into
    # detect/track outputs before anything notices).
    for name, c in out.items():
        for d, n in zip(c.dims, c.values.shape):
            if d in sizes and sizes[d] != n:
                raise DataValidationError(
                    f"conflicting sizes for dimension '{d}': coordinate '{name}' has length {n} "
                    f"but the data has size {sizes[d]} along '{d}'",
                    data_info={"coord": name, "coord_shape": tuple(c.values.shape), "dim_sizes": sizes},
                    suggestions=[
                        "Check that the data array actually varies along this dimension "
                        "(a pure-broadcast construction can silently collapse an axis to length 1)",
                        "Pass coordinate values whose length matches the data shape",
                    ],
                )
    return out


class _DtAccessor:
    """numpy ``datetime64`` accessor for a 1-D time coordinate (the subset of
    xarray's ``.dt`` the pipeline uses)."""

    def __init__(self, field: "Field"):
        self._field = field
        self._days = _asnumpy(field.values).astype("datetime64[D]")

    def _wrap(self, values: np.ndarray) -> "Field":
        f = self._field
        return Field(np.asarray(values, dtype=np.int32), dims=f.dims, coords=f.coords, name=f.name)

    @property
    def year(self) -> "Field":
        return self._wrap(self._days.astype("datetime64[Y]").astype(np.int64) + 1970)

    @property
    def month(self) -> "Field":
        return self._wrap(self._days.astype("datetime64[M]").astype(np.int64) % 12 + 1)

    @property
    def day(self) -> "Field":
        return self._wrap((self._days - self._days.astype("datetime64[M]")).astype(np.int64) + 1)

    @property
    def dayofyear(self) -> "Field":
        return self._wrap((self._days - self._days.astype("datetime64[Y]")).astype(np.int64) + 1)


class Field:
    """
    A named, dimension-labeled array.

    Parameters
    ----------
    data : numpy or jax array
    dims : sequence of str
    coords : mapping, optional
        name -> values | (dims, values) | Coord | Field
    name : str, optional
    attrs : dict, optional
    """

    __slots__ = ("data", "dims", "coords", "name", "attrs")

    def __init__(
        self,
        data: ArrayLike,
        dims: Sequence[str],
        coords: Optional[Mapping[str, Any]] = None,
        name: Optional[str] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ):
        if np.isscalar(data) or (hasattr(data, "ndim") and data.ndim == 0):
            data = np.asarray(data)
        self.data = data
        self.dims = tuple(dims)
        if len(self.dims) != data.ndim:
            raise DataValidationError(
                f"dims {self.dims} do not match array rank {data.ndim}",
                data_info={"dims": self.dims, "shape": tuple(data.shape)},
            )
        self.coords = _normalize_coords(coords, self.dims, tuple(data.shape))
        self.name = name
        self.attrs = dict(attrs) if attrs else {}

    # ------------------------------------------------------------------
    # basic properties
    # ------------------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.data.shape)

    @property
    def ndim(self) -> int:
        return self.data.ndim

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.dims, self.shape))

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def values(self) -> np.ndarray:
        return _asnumpy(self.data)

    @property
    def dt(self) -> _DtAccessor:
        return _DtAccessor(self)

    def item(self):
        return self.values.item()

    def __len__(self) -> int:
        return self.shape[0]

    def __repr__(self) -> str:  # pragma: no cover
        coord_names = ", ".join(self.coords)
        return (
            f"<marex_tpu.Field {self.name or ''}{self.sizes} dtype={self.dtype} "
            f"coords=[{coord_names}] backend={'jax' if _is_jax(self.data) else 'numpy'}>"
        )

    # ------------------------------------------------------------------
    # compatibility shims (no task graph in this framework)
    # ------------------------------------------------------------------
    def persist(self) -> "Field":
        return self

    def compute(self) -> "Field":
        if _is_jax(self.data):
            return self._replace(data=np.asarray(self.data))
        return self

    def load(self) -> "Field":
        return self.compute()

    def chunk(self, *args: Any, **kwargs: Any) -> "Field":
        return self

    @property
    def chunks(self):
        # Single-chunk semantics: one chunk per dim
        return tuple((s,) for s in self.shape)

    @property
    def chunksizes(self) -> Dict[str, Tuple[int, ...]]:
        return {d: (s,) for d, s in self.sizes.items()}

    # ------------------------------------------------------------------
    # construction helpers
    # ------------------------------------------------------------------
    def _replace(
        self,
        data: Optional[ArrayLike] = None,
        dims: Optional[Sequence[str]] = None,
        coords: Optional[Mapping[str, Any]] = None,
        name: Optional[str] = None,
    ) -> "Field":
        return Field(
            self.data if data is None else data,
            self.dims if dims is None else tuple(dims),
            self.coords if coords is None else coords,
            self.name if name is None else name,
            self.attrs,
        )

    def rename(self, name: Union[str, Mapping[str, str], None] = None, **dim_renames: str) -> "Field":
        if isinstance(name, str) or name is None and not dim_renames:
            return self._replace(name=name)
        mapping = dict(name) if isinstance(name, Mapping) else {}
        mapping.update(dim_renames)
        new_dims = tuple(mapping.get(d, d) for d in self.dims)
        new_coords = {
            mapping.get(k, k): Coord(tuple(mapping.get(d, d) for d in c.dims), c.values) for k, c in self.coords.items()
        }
        return Field(self.data, new_dims, new_coords, self.name, self.attrs)

    def copy(self) -> "Field":
        data = self.data.copy() if isinstance(self.data, np.ndarray) else self.data
        return Field(data, self.dims, dict(self.coords), self.name, dict(self.attrs))

    def astype(self, dtype) -> "Field":
        return self._replace(data=self.data.astype(dtype))

    def assign_coords(self, coords: Optional[Mapping[str, Any]] = None, **kw: Any) -> "Field":
        new = dict(self.coords)
        merged = dict(coords or {})
        merged.update(kw)
        new.update(_normalize_coords(merged, self.dims, self.shape))
        return Field(self.data, self.dims, new, self.name, self.attrs)

    def drop_vars(self, names: Union[str, Iterable[str]], errors: str = "ignore") -> "Field":
        if isinstance(names, str):
            names = [names]
        new = {k: v for k, v in self.coords.items() if k not in set(names)}
        return Field(self.data, self.dims, new, self.name, self.attrs)

    # ------------------------------------------------------------------
    # indexing
    # ------------------------------------------------------------------
    def isel(self, indexers: Optional[Mapping[str, Any]] = None, **kw: Any) -> "Field":
        idxs = dict(indexers or {})
        idxs.update(kw)
        # Normalize Field/array indexers to numpy
        norm: Dict[str, Any] = {}
        for d, i in idxs.items():
            if d not in self.dims:
                continue
            if isinstance(i, Field):
                i = i.values
            if isinstance(i, (list, np.ndarray)) and np.asarray(i).dtype == bool:
                i = np.nonzero(np.asarray(i))[0]
            norm[d] = i
        index = tuple(norm.get(d, slice(None)) for d in self.dims)
        data = self.data[index]
        dropped = {d for d, i in norm.items() if isinstance(i, (int, np.integer))}
        new_dims = tuple(d for d in self.dims if d not in dropped)
        new_coords: Dict[str, Coord] = {}
        for cname, c in self.coords.items():
            if not set(c.dims) & set(norm.keys()):
                if not set(c.dims) & dropped:
                    new_coords[cname] = c
                continue
            sub = c.isel(norm)
            new_coords[cname] = sub
        return Field(data, new_dims, new_coords, self.name, self.attrs)

    def sel(self, indexers: Optional[Mapping[str, Any]] = None, method: Optional[str] = None, **kw: Any) -> "Field":
        idxs = dict(indexers or {})
        idxs.update(kw)
        pos: Dict[str, Any] = {}
        for d, label in idxs.items():
            coord = self.coords.get(d)
            if coord is None or coord.dims != (d,):
                raise DataValidationError(f"No 1-D index coordinate for dim '{d}'")
            cv = coord.values
            if isinstance(label, slice):
                lo = 0 if label.start is None else int(np.searchsorted(cv, np.asarray(label.start, dtype=cv.dtype), "left"))
                hi = len(cv) if label.stop is None else int(np.searchsorted(cv, np.asarray(label.stop, dtype=cv.dtype), "right"))
                pos[d] = slice(lo, hi)
            else:
                lab = np.asarray(label)
                if lab.ndim == 0:
                    matches = np.nonzero(cv == lab)[0]
                    if len(matches) == 0:
                        if method == "nearest":
                            pos[d] = int(np.argmin(np.abs(cv.astype("f8") - float(lab))))
                            continue
                        raise KeyError(label)
                    pos[d] = int(matches[0])
                else:
                    sorter = np.argsort(cv)
                    locs = np.clip(np.searchsorted(cv, lab, sorter=sorter), 0, len(cv) - 1)
                    taken = sorter[locs]
                    missing = cv[taken] != lab
                    if missing.any():
                        raise KeyError(list(np.asarray(lab)[missing]))
                    pos[d] = taken
        return self.isel(pos)

    def squeeze(self, dim: Optional[str] = None) -> "Field":
        if dim is not None:
            return self.isel({dim: 0}) if self.sizes[dim] == 1 else self
        out = self
        for d in list(out.dims):
            if out.sizes[d] == 1:
                out = out.isel({d: 0})
        return out

    def transpose(self, *dims: str) -> "Field":
        if not dims:
            dims = tuple(reversed(self.dims))
        if Ellipsis in dims:
            named = [d for d in dims if d is not Ellipsis]
            rest = [d for d in self.dims if d not in named]
            i = dims.index(Ellipsis)
            dims = tuple(named[:i] + rest + named[i:])
        axes = [self.dims.index(d) for d in dims]
        if _is_jax(self.data):
            import jax.numpy as jnp

            data = jnp.transpose(self.data, axes)
        else:
            data = np.transpose(self.data, axes)
        return Field(data, dims, self.coords, self.name, self.attrs)

    def expand_dims(self, dim: Union[str, Mapping[str, int]]) -> "Field":
        """Prepend new dims of the given sizes (broadcasting the data)."""
        if isinstance(dim, str):
            dim = {dim: 1}
        out = self
        for d, n in dim.items():
            data = np.broadcast_to(out.values[None, ...], (n,) + out.shape)
            out = Field(np.ascontiguousarray(data), (d,) + out.dims, out.coords, out.name, out.attrs)
        return out

    def broadcast_like(self, other: "Field") -> "Field":
        a, _ = broadcast(self, other)
        return a

    def stack_spatial(self, dims: Sequence[str], new_dim: str = "space") -> "Field":
        """Flatten the trailing spatial dims into one (device-layout helper)."""
        axes = [self.dims.index(d) for d in dims]
        if axes != sorted(axes) or axes[-1] != self.ndim - 1:
            raise DataValidationError("stack_spatial requires trailing contiguous dims")
        lead = self.shape[: axes[0]]
        data = self.data.reshape(lead + (-1,))
        return Field(data, self.dims[: axes[0]] + (new_dim,), {}, self.name, self.attrs)

    # ------------------------------------------------------------------
    # arithmetic / comparisons (dim-aligned broadcasting)
    # ------------------------------------------------------------------
    def _binop(self, other: Any, op: Callable, reflexive: bool = False) -> "Field":
        if isinstance(other, Field):
            a, b = broadcast(self, other)
            x, y = (b.data, a.data) if reflexive else (a.data, b.data)
            return Field(op(x, y), a.dims, a.coords, self.name, self.attrs)
        x, y = (other, self.data) if reflexive else (self.data, other)
        return Field(op(x, y), self.dims, self.coords, self.name, self.attrs)

    def __add__(self, o): return self._binop(o, operator.add)
    def __radd__(self, o): return self._binop(o, operator.add, True)
    def __sub__(self, o): return self._binop(o, operator.sub)
    def __rsub__(self, o): return self._binop(o, operator.sub, True)
    def __mul__(self, o): return self._binop(o, operator.mul)
    def __rmul__(self, o): return self._binop(o, operator.mul, True)
    def __truediv__(self, o): return self._binop(o, operator.truediv)
    def __rtruediv__(self, o): return self._binop(o, operator.truediv, True)
    def __pow__(self, o): return self._binop(o, operator.pow)
    def __ge__(self, o): return self._binop(o, operator.ge)
    def __gt__(self, o): return self._binop(o, operator.gt)
    def __le__(self, o): return self._binop(o, operator.le)
    def __lt__(self, o): return self._binop(o, operator.lt)
    def __eq__(self, o): return self._binop(o, operator.eq)  # type: ignore[override]
    def __ne__(self, o): return self._binop(o, operator.ne)  # type: ignore[override]
    def __and__(self, o): return self._binop(o, operator.and_)
    def __or__(self, o): return self._binop(o, operator.or_)
    def __invert__(self): return self._replace(data=~self.data)
    def __neg__(self): return self._replace(data=-self.data)

    __hash__ = object.__hash__

    # ------------------------------------------------------------------
    # reductions
    # ------------------------------------------------------------------
    def _reduce(self, fn_np: Callable, dim: Union[str, Sequence[str], None] = None, **kw: Any) -> "Field":
        if dim is None:
            axes = None
            new_dims: Tuple[str, ...] = ()
        else:
            if isinstance(dim, str):
                dim = [dim]
            axes = tuple(self.dims.index(d) for d in dim)
            new_dims = tuple(d for d in self.dims if d not in set(dim))
        vals = fn_np(self.values, axis=axes, **kw)
        coords = {k: c for k, c in self.coords.items() if set(c.dims) <= set(new_dims)}
        return Field(np.asarray(vals), new_dims, coords, self.name, self.attrs)

    def sum(self, dim=None, **kw): return self._reduce(np.nansum if kw.pop("skipna", False) else np.sum, dim, **kw)
    def mean(self, dim=None, **kw): return self._reduce(np.nanmean if kw.pop("skipna", True) and np.issubdtype(self.values.dtype, np.floating) else np.mean, dim, **kw)
    def std(self, dim=None, **kw): return self._reduce(np.nanstd if np.issubdtype(self.values.dtype, np.floating) else np.std, dim, **kw)
    def max(self, dim=None, **kw): return self._reduce(np.nanmax if np.issubdtype(self.values.dtype, np.floating) else np.max, dim, **kw)
    def min(self, dim=None, **kw): return self._reduce(np.nanmin if np.issubdtype(self.values.dtype, np.floating) else np.min, dim, **kw)
    def any(self, dim=None): return self._reduce(np.any, dim)
    def all(self, dim=None): return self._reduce(np.all, dim)
    def count(self, dim=None):
        vals = self.values
        finite = np.isfinite(vals) if np.issubdtype(vals.dtype, np.floating) else np.ones_like(vals, dtype=bool)
        return Field(finite, self.dims, self.coords)._reduce(np.sum, dim)

    def argmax(self, dim: str) -> "Field":
        return self._reduce(np.argmax, [dim]) if dim else self._reduce(np.argmax, None)

    def quantile(self, q: float, dim: Union[str, Sequence[str], None] = None) -> "Field":
        return self._reduce(lambda v, axis=None: np.nanquantile(v, q, axis=axis), dim)

    # ------------------------------------------------------------------
    # masking / selection utilities
    # ------------------------------------------------------------------
    def where(self, cond: Union["Field", ArrayLike], other: Any = np.nan, drop: bool = False) -> "Field":
        cond_f = cond if isinstance(cond, Field) else Field(np.asarray(cond), self.dims)
        a, c = broadcast(self, cond_f)
        if isinstance(other, Field):
            other = other.values
        out = np.where(_asnumpy(c.data).astype(bool), a.values, other)
        res = Field(out, a.dims, a.coords, self.name, self.attrs)
        if drop and res.ndim == 1:
            keep = _asnumpy(c.data).astype(bool)
            return res.isel({res.dims[0]: np.nonzero(keep)[0]})
        return res

    def isin(self, values: Any) -> "Field":
        vals = values.values if isinstance(values, Field) else np.asarray(values)
        return self._replace(data=np.isin(self.values, vals))

    def isnull(self) -> "Field":
        v = self.values
        if np.issubdtype(v.dtype, np.floating):
            return self._replace(data=np.isnan(v))
        return self._replace(data=np.zeros(v.shape, dtype=bool))

    def notnull(self) -> "Field":
        return self._replace(data=~self.isnull().values)

    def fillna(self, value: Any) -> "Field":
        v = self.values.copy()
        v[np.isnan(v)] = value
        return self._replace(data=v)

    def clip(self, lo=None, hi=None) -> "Field":
        return self._replace(data=np.clip(self.values, lo, hi))

    def shift(self, shifts: Optional[Mapping[str, int]] = None, fill_value: Any = np.nan, **kw: int) -> "Field":
        sh = dict(shifts or {})
        sh.update(kw)
        out = self.values.copy()
        for d, n in sh.items():
            ax = self.dims.index(d)
            out = np.roll(out, n, axis=ax)
            sl = [slice(None)] * out.ndim
            if n > 0:
                sl[ax] = slice(0, n)
            elif n < 0:
                sl[ax] = slice(n, None)
            else:
                continue
            out[tuple(sl)] = fill_value
        return self._replace(data=out)

    def pad_dim(self, dim: str, width: int, mode: str = "constant", constant_values: Any = 0) -> "Field":
        pads = [(0, 0)] * self.ndim
        pads[self.dims.index(dim)] = (width, width)
        if mode == "constant":
            data = np.pad(self.values, pads, mode=mode, constant_values=constant_values)
        else:
            data = np.pad(self.values, pads, mode=mode)
        coords = {k: c for k, c in self.coords.items() if dim not in c.dims}
        return Field(data, self.dims, coords, self.name, self.attrs)

    # ------------------------------------------------------------------
    # interop
    # ------------------------------------------------------------------
    def to_xarray(self):
        """Convert to an xarray.DataArray (requires xarray)."""
        from .._dependencies import require_dependencies

        require_dependencies(["xarray"], "Field.to_xarray")
        import xarray as xr

        coords = {k: (c.dims, c.values) for k, c in self.coords.items()}
        return xr.DataArray(self.values, dims=self.dims, coords=coords, name=self.name, attrs=self.attrs)

    def to_device(self):
        """Move payload to the default JAX device (jnp.asarray)."""
        import jax.numpy as jnp

        return self._replace(data=jnp.asarray(self.values))


def broadcast(a: Field, b: Field) -> Tuple[Field, Field]:
    """Align two Fields over the union of their dims (xarray-style)."""
    out_dims = list(a.dims) + [d for d in b.dims if d not in a.dims]
    sizes: Dict[str, int] = {}
    for f in (a, b):
        for d, s in f.sizes.items():
            if d in sizes and sizes[d] != s:
                raise DataValidationError(
                    f"Dimension size mismatch for '{d}': {sizes[d]} vs {s}",
                    data_info={"a_dims": a.sizes, "b_dims": b.sizes},
                )
            sizes[d] = s
    shape = tuple(sizes[d] for d in out_dims)

    def _expand(f: Field) -> ArrayLike:
        # reorder to the output dim order, insert missing axes, broadcast
        data = _asnumpy(f.data)
        order = [f.dims.index(d) for d in out_dims if d in f.dims]
        if order != sorted(order):
            data = data.transpose(order)
        reshaped_shape = tuple(sizes[d] if d in f.dims else 1 for d in out_dims)
        data = data.reshape(reshaped_shape)
        return np.broadcast_to(data, shape)

    coords: Dict[str, Coord] = {}
    coords.update(b.coords)
    coords.update(a.coords)
    fa = Field(_expand(a), out_dims, coords, a.name, a.attrs)
    fb = Field(_expand(b), out_dims, coords, b.name, b.attrs)
    return fa, fb


def ones_like(f: Field, dtype=None) -> Field:
    return f._replace(data=np.ones(f.shape, dtype=dtype or f.dtype))


def zeros_like(f: Field, dtype=None) -> Field:
    return f._replace(data=np.zeros(f.shape, dtype=dtype or f.dtype))


def full_like(f: Field, fill: Any, dtype=None) -> Field:
    return f._replace(data=np.full(f.shape, fill, dtype=dtype or f.dtype))


def isfinite(f: Field) -> Field:
    v = f.values
    if np.issubdtype(v.dtype, np.floating):
        return f._replace(data=np.isfinite(v))
    return f._replace(data=np.ones(v.shape, dtype=bool))


def concat(fields: List[Field], dim: str) -> Field:
    """Concatenate fields along ``dim`` (created if absent)."""
    parts = []
    for f in fields:
        if dim in f.dims:
            parts.append(f.values)
        else:
            parts.append(f.values[None, ...])
    if dim in fields[0].dims:
        ax = fields[0].dims.index(dim)
        data = np.concatenate(parts, axis=ax)
        dims = fields[0].dims
    else:
        data = np.concatenate(parts, axis=0)
        dims = (dim,) + fields[0].dims
    coords = {k: c for k, c in fields[0].coords.items() if dim not in c.dims}
    return Field(data, dims, coords, fields[0].name, fields[0].attrs)


class FieldSet:
    """
    Dataset-analogue: named Fields sharing dims/coords + global attrs.
    """

    def __init__(
        self,
        data_vars: Optional[Mapping[str, Field]] = None,
        coords: Optional[Mapping[str, Any]] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ):
        self.data_vars: Dict[str, Field] = dict(data_vars or {})
        self.attrs: Dict[str, Any] = dict(attrs or {})
        self.coords: Dict[str, Coord] = {}
        if coords:
            for k, v in coords.items():
                if isinstance(v, Coord):
                    self.coords[k] = v
                elif isinstance(v, Field):
                    self.coords[k] = Coord(v.dims, v.values)
                elif isinstance(v, tuple) and len(v) == 2:
                    self.coords[k] = Coord(v[0], v[1])
                else:
                    self.coords[k] = Coord(k, _asnumpy(v))
        # absorb variable coords
        for f in self.data_vars.values():
            for k, c in f.coords.items():
                self.coords.setdefault(k, c)

    # Mapping-ish interface ------------------------------------------------
    def __getitem__(self, key: str) -> Field:
        if key in self.data_vars:
            return self.data_vars[key]
        if key in self.coords:
            c = self.coords[key]
            return Field(c.values, c.dims, {key: c} if c.dims == (key,) else {}, name=key)
        raise KeyError(key)

    def __setitem__(self, key: str, value: Field) -> None:
        self.data_vars[key] = value
        for k, c in value.coords.items():
            self.coords.setdefault(k, c)

    def __contains__(self, key: str) -> bool:
        return key in self.data_vars

    def __getattr__(self, key: str) -> Field:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __iter__(self):
        return iter(self.data_vars)

    def keys(self):
        return self.data_vars.keys()

    @property
    def dims(self) -> Dict[str, int]:
        return self.sizes

    @property
    def sizes(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.data_vars.values():
            out.update(f.sizes)
        return out

    def __repr__(self) -> str:  # pragma: no cover
        lines = [f"<marex_tpu.FieldSet dims={self.sizes}>"]
        for k, f in self.data_vars.items():
            lines.append(f"  {k:<18} {f.dims} {f.dtype}")
        return "\n".join(lines)

    # xarray-compat no-ops -------------------------------------------------
    def persist(self, **kw: Any) -> "FieldSet":
        return self

    def compute(self) -> "FieldSet":
        return FieldSet({k: v.compute() for k, v in self.data_vars.items()}, self.coords, self.attrs)

    def chunk(self, *a: Any, **kw: Any) -> "FieldSet":
        return self

    # transforms -----------------------------------------------------------
    def isel(self, indexers: Optional[Mapping[str, Any]] = None, **kw: Any) -> "FieldSet":
        idxs = dict(indexers or {})
        idxs.update(kw)
        new_vars = {}
        for k, f in self.data_vars.items():
            sub = {d: i for d, i in idxs.items() if d in f.dims}
            new_vars[k] = f.isel(sub) if sub else f
        new_coords = {}
        for k, c in self.coords.items():
            sub = {d: i for d, i in idxs.items() if d in c.dims}
            new_coords[k] = c.isel(sub) if sub else c
        return FieldSet(new_vars, new_coords, self.attrs)

    def assign_coords(self, coords: Optional[Mapping[str, Any]] = None, **kw: Any) -> "FieldSet":
        merged = dict(coords or {})
        merged.update(kw)
        out = FieldSet(self.data_vars, self.coords, self.attrs)
        for k, v in merged.items():
            if isinstance(v, Field):
                out.coords[k] = Coord(v.dims, v.values)
            elif isinstance(v, tuple) and len(v) == 2:
                out.coords[k] = Coord(v[0], v[1])
            else:
                out.coords[k] = Coord(k, _asnumpy(v))
        return out

    def drop_vars(self, names: Union[str, Iterable[str]], errors: str = "ignore") -> "FieldSet":
        if isinstance(names, str):
            names = [names]
        names = set(names)
        return FieldSet(
            {k: v for k, v in self.data_vars.items() if k not in names},
            {k: c for k, c in self.coords.items() if k not in names},
            self.attrs,
        )

    def to_xarray(self):
        from .._dependencies import require_dependencies

        require_dependencies(["xarray"], "FieldSet.to_xarray")
        import xarray as xr

        return xr.Dataset(
            {k: v.to_xarray() for k, v in self.data_vars.items()},
            coords={k: (c.dims, c.values) for k, c in self.coords.items()},
            attrs=self.attrs,
        )


def from_xarray(obj: Any) -> Union[Field, FieldSet]:
    """Adapt an xarray DataArray/Dataset (or duck-typed equivalent)."""
    if hasattr(obj, "data_vars"):
        coords = {k: Coord(tuple(v.dims), np.asarray(v.values)) for k, v in obj.coords.items()}
        dvars = {}
        for k, v in obj.data_vars.items():
            dvars[k] = Field(np.asarray(v.values), tuple(v.dims), name=k, attrs=dict(v.attrs))
        return FieldSet(dvars, coords, dict(obj.attrs))
    coords = {k: Coord(tuple(v.dims), np.asarray(v.values)) for k, v in obj.coords.items()}
    return Field(np.asarray(obj.values), tuple(obj.dims), coords, getattr(obj, "name", None), dict(obj.attrs))


def as_field(obj: Any, dims: Optional[Sequence[str]] = None, name: Optional[str] = None) -> Field:
    """
    Coerce Field / xarray.DataArray / ndarray (+dims) into a Field.
    Dask-backed xarray inputs are materialised (this framework stages its own
    device compute instead of building task graphs).
    """
    if isinstance(obj, Field):
        return obj
    if hasattr(obj, "dims") and hasattr(obj, "values"):  # xarray duck-type
        if has_dependency("dask") and hasattr(obj, "compute"):
            try:
                from dask.base import is_dask_collection

                if is_dask_collection(getattr(obj, "data", None)):
                    obj = obj.compute()
            except Exception:  # pragma: no cover
                pass
        return from_xarray(obj)
    arr = np.asarray(obj)
    if dims is None:
        raise DataValidationError(
            "Cannot infer dims for raw array input",
            suggestions=["Pass a marex_tpu Field, an xarray.DataArray, or provide dims explicitly"],
        )
    return Field(arr, dims, name=name)
