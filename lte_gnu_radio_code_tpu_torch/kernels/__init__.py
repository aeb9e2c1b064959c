"""Wrappers of the port's hand-written CUDA kernels, each beside its plain
PyTorch twin, and their launch counts.

K1 ``ofdm_mod``, K2 ``equalize``, K3 ``channel_conv``, K4 ``sync_search``,
``tracker`` (the tracker's step loop) and ``mimo_detect`` (the 2x2 LMMSE
detection, a pair of kernels), the last two with no Pallas kernel behind.
Each module keeps ``launches``, a plain int that its wrapper raises by one
per kernel launch (the twin never counts); K4 and the tracker also keep
``route_launches``, the same launches by route, and K4 ``peak_launches``,
those of its launches in the peaks form, by route.
:func:`reset_launch_counts` sets them all to 0; :func:`launch_state` reads
them all and :func:`add_launches` raises them (a replayed CUDA graph adds
the launches its capture made).
"""

import functools

KERNEL_MODULES = ("ofdm_mod", "equalize", "channel_conv", "sync_search",
                  "tracker", "mimo_detect")


@functools.cache
def _modules():
    import importlib
    return {name: importlib.import_module(f"{__name__}.{name}")
            for name in KERNEL_MODULES}


def launch_counts() -> dict[str, int]:
    return {name: m.launches for name, m in _modules().items()}


def launch_state() -> dict[tuple, int]:
    """Every counter at once: {(module, "launches", None): n,
    (module, "route_launches" | "peak_launches", route): n}."""
    out = {}
    for name, m in _modules().items():
        out[name, "launches", None] = m.launches
        for attr in ("route_launches", "peak_launches"):
            for kind, n in getattr(m, attr, {}).items():
                out[name, attr, kind] = n
    return out


def add_launches(delta: dict[tuple, int]) -> None:
    """Raise the counters by ``delta`` (keys of :func:`launch_state`): a
    replayed CUDA graph adds the launches its capture made."""
    mods = _modules()
    for (name, attr, kind), n in delta.items():
        m = mods[name]
        if kind is None:
            m.launches += n
        else:
            getattr(m, attr)[kind] += n


def reset_launch_counts() -> None:
    for m in _modules().values():
        m.launches = 0
        for by_route in (getattr(m, "route_launches", {}),
                         getattr(m, "peak_launches", {})):
            for kind in by_route:
                by_route[kind] = 0
