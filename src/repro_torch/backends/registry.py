"""String-keyed softmax-backend registry with decorator registration.

A copy of the reference registry (``src/repro/backends/registry.py``) that
loads the port's own backend module. Adding a new execution substrate is

    from repro_torch.backends.registry import register_backend
    from repro_torch.backends.base import SoftmaxBackend

    @register_backend("my_backend")
    class MyBackend(SoftmaxBackend):
        name = "my_backend"
        def apply(self, scores, mask=None, axis=-1): ...

and every consumer — ``SoftmaxSpec`` in model configs, the serving engine's
cost metering — picks it up by name. A backend
may register under aliases (``"int"`` and ``"int_jax"`` are the same class).

Instances are cached per (name, PrecisionConfig): backends are stateless
beyond their config, so model code may re-resolve the backend at every call.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple, Type

from repro_torch.backends.base import SoftmaxBackend

_FACTORIES: Dict[str, Type[SoftmaxBackend]] = {}


def register_backend(*names: str):
    """Class decorator: register a SoftmaxBackend under one or more names."""
    if not names:
        raise ValueError("register_backend needs at least one name")

    def deco(cls: Type[SoftmaxBackend]) -> Type[SoftmaxBackend]:
        # validate every name before inserting any: a duplicate must not
        # leave the registry partially mutated
        for name in names:
            if name in _FACTORIES:
                raise ValueError(f"softmax backend {name!r} already registered "
                                 f"({_FACTORIES[name].__name__})")
        for name in names:
            _FACTORIES[name] = cls
        return cls

    return deco


_LOADING = False


def _load_builtins(strict: bool) -> bool:
    """Import the built-in backend modules (registration side effect).

    Lazy so that ``repro_torch.backends.registry`` itself stays import-cycle-free:
    the implementations import core/kernels/ap modules, which may themselves
    be mid-import when this module first loads. Returns False (without
    raising, unless ``strict``) when called re-entrantly or while one of
    those modules is partially initialized — the registry is not "settled"
    yet and callers must defer.
    """
    global _LOADING
    if _LOADING:
        return False
    _LOADING = True
    try:
        from repro_torch.backends import torch_backends  # noqa: F401
        return True
    except ImportError:
        if strict:
            raise
        return False  # mid-import of a dependency; retry succeeds later
    finally:
        _LOADING = False


def _require_settled() -> None:
    if not _load_builtins(strict=True):
        # re-entrant call from inside the backend modules' own import: the
        # registry is partially populated and lookups would silently miss
        raise RuntimeError(
            "softmax backend registry is mid-initialization; resolve "
            "backends after module import completes (use "
            "settled_backend_names() for import-time probing)")


def available_backends() -> Tuple[str, ...]:
    """All registered backend names (aliases included), sorted."""
    _require_settled()
    return tuple(sorted(_FACTORIES))


def settled_backend_names() -> Optional[Tuple[str, ...]]:
    """The full name set when the built-in modules are (or can be) loaded,
    else None while they are mid-import. Lets ``SoftmaxSpec.__post_init__``
    validate eagerly in a settled process yet defer (to ``backend()``
    resolution) for the module-level spec constants constructed during the
    import cycle itself."""
    if not _load_builtins(strict=False):
        return None
    return tuple(sorted(_FACTORIES))


@functools.lru_cache(maxsize=None)
def _cached_instance(cls: Type[SoftmaxBackend], cfg) -> SoftmaxBackend:
    return cls(cfg)


def get_backend(name: str, cfg=None) -> SoftmaxBackend:
    """Resolve a backend by name; ``cfg`` is the PrecisionConfig (hashable,
    ignored by the fp family)."""
    _require_settled()
    if name not in _FACTORIES:
        raise ValueError(
            f"unknown softmax backend {name!r}; available: "
            f"{', '.join(sorted(_FACTORIES))}")
    # cache on the resolved class, with cfg=None normalized to the class's
    # default, so aliases ("int" / "int_jax") and implicit-default lookups
    # all share one instance
    cls = _FACTORIES[name]
    if cfg is None:
        cfg = cls.default_cfg
    return _cached_instance(cls, cfg)
