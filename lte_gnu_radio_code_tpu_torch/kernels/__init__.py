"""Wrappers of the port's hand-written CUDA kernels, each beside its plain
PyTorch twin, and their launch counts.

K1 ``ofdm_mod``, K2 ``equalize``, K3 ``channel_conv``, K4 ``sync_search``,
and ``tracker`` (the tracker's step loop, which has no Pallas kernel).
Each module keeps ``launches``, a plain int that its wrapper raises by one
per kernel launch (the twin never counts); K4 and the tracker also keep
``route_launches``, the same launches by route, and K4 ``peak_launches``,
those of its launches in the peaks form, by route.
:func:`reset_launch_counts` sets them all to 0.
"""

KERNEL_MODULES = ("ofdm_mod", "equalize", "channel_conv", "sync_search",
                  "tracker")


def _modules():
    import importlib
    return {name: importlib.import_module(f"{__name__}.{name}")
            for name in KERNEL_MODULES}


def launch_counts() -> dict[str, int]:
    return {name: m.launches for name, m in _modules().items()}


def reset_launch_counts() -> None:
    for m in _modules().values():
        m.launches = 0
        for by_route in (getattr(m, "route_launches", {}),
                         getattr(m, "peak_launches", {})):
            for kind in by_route:
                by_route[kind] = 0
