"""The build cache of the grid and unstructured routes.

Counterpart of ``fea_tpu/solve/cache.py``: ``solve()`` on one mesh with
many load cases builds once. An entry keys on the identity of the scene's
``nodes``, ``elements`` and ``fixed`` tensors, on each one's version
counter (``Tensor._version``, which every in-place torch operation on the
tensor or a view of it bumps) and on (E, nu): an in-place torch edit of a
key tensor misses and builds again. What the check cannot see is a write
that bypasses torch: a NumPy edit of the memory a CPU tensor shares
(``tensor.numpy()``). An inference tensor has no version counter; it keys
on its identity alone, so an edit of it under ``torch.inference_mode`` is
not seen either. Loads and prescribed values are never part of a key: a
route that caches takes the current call's loads fresh.

The kinds: ``route`` (the grid route's verdict, so that a repeat solve
runs no detector), ``voxel`` (the structured operator and V-cycle of a
one-device voxel box), and the builds of the other routes. An entry holds
its key tensors by weak reference, so it lives only while the caller
holds the mesh: an entry whose key tensor is gone or written since can
never hit again, and the kind's next lookup drops it. A caller that sends
a new mesh every call keeps nothing alive that it dropped. Two entries
per kind, the least recently used out first, bound the device memory
held; :func:`clear_build_cache` gives it all back. An entry holds its
operator and hierarchy, and with the hierarchy the FCG graphs captured
over it (``solve/staged.py``), all dropped with the entry. Each lookup
counts ``build_cache.hit.<kind>`` or ``build_cache.miss.<kind>``
(``fea_tpu_torch.utils.counters()``), the kind's name its first part.
"""
from __future__ import annotations

import weakref

from ..scene import Scene, tensor_version
from ..utils.profiling import count

_BUILD_CACHE: dict = {}
_BUILD_CACHE_MAX = 2

__all__ = ["clear_build_cache"]


def clear_build_cache() -> None:
    """Drop every cached build (and the graphs captured over it); its
    device memory returns to torch's allocator for the next solve."""
    _BUILD_CACHE.clear()


def _live(entry) -> bool:
    """Whether ``entry`` can still hit: each key tensor alive and not
    written since the build."""
    for ref, version in zip(entry[0], entry[1][0]):
        t = ref()
        if t is None or tensor_version(t) != version:
            return False
    return True


def _cached_build(kind, scene: Scene, build):
    """``build()``'s value for ``scene``'s mesh under ``kind``, built at
    the first call and kept for later ones."""
    tensors = (scene.nodes, scene.elements, scene.fixed)
    key = (tuple(tensor_version(t) for t in tensors), (float(scene.material.E), float(scene.material.nu)))
    bucket = _BUILD_CACHE.setdefault(kind, [])
    bucket[:] = [entry for entry in bucket if _live(entry)]
    name = kind[0] if isinstance(kind, tuple) else kind
    for i, entry in enumerate(bucket):
        if all(ref() is t for ref, t in zip(entry[0], tensors)) and entry[1] == key:
            bucket.append(bucket.pop(i))  # most recently used last
            count(f"build_cache.hit.{name}")
            return entry[2]
    count(f"build_cache.miss.{name}")
    value = build()
    bucket.append((tuple(weakref.ref(t) for t in tensors), key, value))
    if len(bucket) > _BUILD_CACHE_MAX:
        bucket.pop(0)
    return value
