"""NamedArray: a tensor with dimension names and feature names.

The same frozen container as the JAX package's ``NamedArray``, over
numpy arrays (the host-side data pipeline) or torch tensors (device
compute). Every transform returns a new ``NamedArray``.

The last dim is always ``features`` and ``feature_names`` labels it;
the spatial dims are every dim not in ``NON_SPATIAL``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence, Tuple, Union

import numpy as np
import torch

Array = Union[np.ndarray, torch.Tensor]

NON_SPATIAL = ("batch", "timestep", "features", "members")


@dataclasses.dataclass(frozen=True)
class NamedArray:
    """A tensor + dimension names + feature names."""

    array: Array
    names: Tuple[str, ...]
    feature_names: Tuple[str, ...]

    def __post_init__(self):
        object.__setattr__(self, "names", tuple(self.names))
        object.__setattr__(self, "feature_names", tuple(self.feature_names))
        if self.array.ndim != len(self.names):
            raise ValueError(
                f"NamedArray rank mismatch: array ndim={self.array.ndim} "
                f"vs names={self.names}"
            )
        if (
            "features" in self.names
            and self.array.shape[self.names.index("features")]
            != len(self.feature_names)
        ):
            raise ValueError(
                f"features dim has size "
                f"{self.array.shape[self.names.index('features')]} but "
                f"{len(self.feature_names)} feature names given: "
                f"{self.feature_names}"
            )

    # ------------------------------------------------------------- metadata
    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.array.shape)

    @property
    def ndim(self) -> int:
        return len(self.names)

    @property
    def dtype(self):
        return self.array.dtype

    def dim_index(self, name: str) -> int:
        return self.names.index(name)

    def dim_size(self, name: str) -> int:
        return self.array.shape[self.dim_index(name)]

    @property
    def spatial_dim_idx(self) -> List[int]:
        """Indices of the spatial dims (every dim not in ``NON_SPATIAL``)."""
        return [i for i, n in enumerate(self.names) if n not in NON_SPATIAL]

    @property
    def spatial_dim_names(self) -> List[str]:
        return [n for n in self.names if n not in NON_SPATIAL]

    @property
    def num_spatial_dims(self) -> int:
        return len(self.spatial_dim_idx)

    def feature_index(self, feature_name: str) -> int:
        return self.feature_names.index(feature_name)

    # ----------------------------------------------------------- transforms
    def replace(self, array) -> "NamedArray":
        """Same names, new data."""
        return NamedArray(array, self.names, self.feature_names)

    def astype(self, dtype) -> "NamedArray":
        """The data cast to ``dtype`` (a numpy dtype for numpy data, a
        torch dtype for a tensor)."""
        if isinstance(self.array, torch.Tensor):
            return self.replace(self.array.to(dtype))
        return self.replace(self.array.astype(dtype))

    def select(self, dim_name: str, index: int) -> "NamedArray":
        """Select one index along a named dim, dropping it (not `features`)."""
        if dim_name == "features":
            raise ValueError("use __getitem__ by feature name instead")
        axis = self.dim_index(dim_name)
        new_names = self.names[:axis] + self.names[axis + 1 :]
        return NamedArray(_take(self.array, index, axis), new_names, self.feature_names)

    def select_array(self, dim_name: str, index: int) -> Array:
        """Select one index along a named dim; return the raw array."""
        return _take(self.array, index, self.dim_index(dim_name))

    def index_select(self, dim_name: str, indices: Sequence[int]) -> "NamedArray":
        """Gather several indices along a named dim (the dim is kept)."""
        return self.replace(_take_many(self.array, indices, self.dim_index(dim_name)))

    def slice_dim(self, dim_name: str, start: int, stop: int) -> "NamedArray":
        axis = self.dim_index(dim_name)
        sl = [slice(None)] * self.ndim
        sl[axis] = slice(start, stop)
        return self.replace(self.array[tuple(sl)])

    def unsqueeze(self, dim_name: str, dim_index: int) -> "NamedArray":
        """A size-1 dim named ``dim_name`` inserted at ``dim_index``."""
        arr = (self.array.unsqueeze(dim_index) if isinstance(self.array, torch.Tensor)
               else np.expand_dims(self.array, dim_index))
        names = self.names[:dim_index] + (dim_name,) + self.names[dim_index:]
        return NamedArray(arr, names, self.feature_names)

    def squeeze(self, dim_names: Union[str, Sequence[str]]) -> "NamedArray":
        """The named size-1 dim(s) dropped; raises on a dim of another size."""
        if isinstance(dim_names, str):
            dim_names = [dim_names]
        arr, names = self.array, list(self.names)
        for dn in dim_names:
            axis = names.index(dn)
            if arr.shape[axis] != 1:
                raise ValueError(f"cannot squeeze dim {dn} of size {arr.shape[axis]}")
            arr = arr.squeeze(axis)
            names.pop(axis)
        return NamedArray(arr, tuple(names), self.feature_names)

    def flatten(self, new_name: str, start: int, stop: int) -> "NamedArray":
        """Flatten contiguous dims [start, stop] into one named dim."""
        shape = self.shape
        new_shape = shape[:start] + (-1,) + shape[stop + 1 :]
        new_names = self.names[:start] + (new_name,) + self.names[stop + 1 :]
        return NamedArray(self.array.reshape(new_shape), new_names, self.feature_names)

    def unflatten(
        self, dim_name: str, sizes: Tuple[int, ...], new_names: Tuple[str, ...]
    ) -> "NamedArray":
        axis = self.dim_index(dim_name)
        shape = self.shape
        new_shape = shape[:axis] + tuple(sizes) + shape[axis + 1 :]
        names = self.names[:axis] + tuple(new_names) + self.names[axis + 1 :]
        return NamedArray(self.array.reshape(new_shape), names, self.feature_names)

    def broadcast_like(self, other: "NamedArray") -> "NamedArray":
        """Insert the dims of ``other`` this array lacks (size 1) and
        broadcast every non-feature dim to ``other``'s sizes, keeping
        this array's feature dim."""
        arr = self.array
        names = list(self.names)
        for i, n in enumerate(other.names):
            if n not in names and n != "features":
                sl = [slice(None)] * arr.ndim
                sl.insert(i, None)
                arr = arr[tuple(sl)]
                names.insert(i, n)
        target_shape = []
        for i, n in enumerate(names):
            if n != "features" and n in other.names:
                target_shape.append(other.dim_size(n))
            else:
                target_shape.append(arr.shape[i])
        if isinstance(arr, torch.Tensor):
            arr = arr.expand(tuple(target_shape))
        else:
            arr = np.broadcast_to(arr, tuple(target_shape))
        return NamedArray(arr, tuple(names), self.feature_names)

    # ------------------------------------------------------------ accessors
    def __getitem__(self, feature_name: str):
        """Select a single feature by name; keeps a size-1 features dim."""
        idx = self.feature_index(feature_name)
        axis = self.dim_index("features")
        sl = [slice(None)] * self.ndim
        sl[axis] = slice(idx, idx + 1)
        return self.array[tuple(sl)]

    def select_features(self, feature_names: Sequence[str]) -> "NamedArray":
        """The named features, in that order."""
        idxs = [self.feature_index(f) for f in feature_names]
        return NamedArray(_take_many(self.array, idxs, self.dim_index("features")),
                          self.names, tuple(feature_names))

    def iter_dim(self, dim_name: str) -> Iterator["NamedArray"]:
        """Each index along a named dim, dropping it."""
        for i in range(self.dim_size(dim_name)):
            yield self.select(dim_name, i)

    def __or__(self, other: "NamedArray") -> "NamedArray":
        """Concatenate along the features dim."""
        return NamedArray.concat([self, other])

    # -------------------------------------------------------------- statics
    @staticmethod
    def concat(arrays: Sequence["NamedArray"]) -> "NamedArray":
        """Concatenate along the features dim; feature names are joined."""
        if not arrays:
            raise ValueError("cannot concat an empty list of NamedArrays")
        first = arrays[0]
        for a in arrays[1:]:
            if a.names != first.names:
                raise ValueError(f"concat dim-name mismatch: {a.names} vs {first.names}")
        feature_names = tuple(f for a in arrays for f in a.feature_names)
        if len(set(feature_names)) != len(feature_names):
            raise ValueError(f"duplicate feature names in concat: {feature_names}")
        axis = first.dim_index("features")
        parts = [a.array for a in arrays]
        if isinstance(first.array, torch.Tensor):
            joined = torch.cat(parts, dim=axis)
        else:
            joined = np.concatenate(parts, axis=axis)
        return NamedArray(joined, first.names, feature_names)

    @staticmethod
    def stack(arrays: Sequence["NamedArray"], dim_name: str, axis: int) -> "NamedArray":
        """Stack along a new dim named ``dim_name`` at ``axis``; the
        first array's names."""
        first = arrays[0]
        parts = [a.array for a in arrays]
        if isinstance(first.array, torch.Tensor):
            joined = torch.stack(parts, dim=axis)
        else:
            joined = np.stack(parts, axis=axis)
        names = first.names[:axis] + (dim_name,) + first.names[axis:]
        return NamedArray(joined, names, first.feature_names)

    @staticmethod
    def new_like(array, other: "NamedArray") -> "NamedArray":
        """``array`` with other's names."""
        return NamedArray(array, other.names, other.feature_names)

    @staticmethod
    def expand_to_batch_like(array, other: "NamedArray") -> "NamedArray":
        """Wrap a batched array with other's names prefixed by `batch`."""
        return NamedArray(array, ("batch",) + tuple(other.names), other.feature_names)

    def __str__(self):
        return (
            f"NamedArray(shape={self.shape}, names={self.names}, "
            f"features={self.feature_names}, dtype={self.dtype})"
        )


def _take(arr, index: int, axis: int):
    sl = [slice(None)] * arr.ndim
    sl[axis] = index
    return arr[tuple(sl)]


def _take_many(arr, indices: Sequence[int], axis: int):
    if isinstance(arr, torch.Tensor):
        return arr.index_select(axis, torch.as_tensor(list(indices), device=arr.device))
    return np.take(arr, np.asarray(list(indices)), axis=axis)
