"""The build cache of the curvilinear and canonicalized routes.

Counterpart of ``fea_tpu/solve/cache.py``: ``solve()`` on one mesh with
many load cases builds once. An entry keys on the identity of the scene's
``nodes``, ``elements`` and ``fixed`` tensors and on (E, nu), and holds
strong references to those tensors, so an id cannot be reused while its
entry lives and an ``is`` match is sound. Loads and prescribed values are
never part of a key: a route that caches takes the current call's loads
fresh. Two entries per kind, the least recently used out first, bound the
device memory held; :func:`clear_build_cache` gives it all back. An entry
holds its operator and hierarchy, and with the hierarchy the FCG graphs
captured over it (``solve/staged.py``), all dropped with the entry. Each
lookup counts ``build_cache.hit.<kind>`` or ``build_cache.miss.<kind>``
(``fea_tpu_torch.utils.counters()``), the kind's name its first part.
"""
from __future__ import annotations

from ..scene import Scene
from ..utils.profiling import count

_BUILD_CACHE: dict = {}
_BUILD_CACHE_MAX = 2

__all__ = ["clear_build_cache"]


def clear_build_cache() -> None:
    """Drop every cached build (and the graphs captured over it); its
    device memory returns to torch's allocator for the next solve."""
    _BUILD_CACHE.clear()


def _cached_build(kind, scene: Scene, build):
    """``build()``'s value for ``scene``'s mesh under ``kind``, built at
    the first call and kept for later ones."""
    key_tensors = (scene.nodes, scene.elements, scene.fixed)
    material = (float(scene.material.E), float(scene.material.nu))
    bucket = _BUILD_CACHE.setdefault(kind, [])
    name = kind[0] if isinstance(kind, tuple) else kind
    for i, entry in enumerate(bucket):
        if all(a is b for a, b in zip(entry[0], key_tensors)) and entry[1] == material:
            bucket.append(bucket.pop(i))  # most recently used last
            count(f"build_cache.hit.{name}")
            return entry[2]
    count(f"build_cache.miss.{name}")
    value = build()
    bucket.append((key_tensors, material, value))
    if len(bucket) > _BUILD_CACHE_MAX:
        bucket.pop(0)
    return value
