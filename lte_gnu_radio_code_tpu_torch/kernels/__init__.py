"""Wrappers of the port's hand-written CUDA kernels, each beside its plain
PyTorch twin, and their launch counts.

K1 ``ofdm_mod``, K2 ``equalize``, K3 ``channel_conv``, K4 ``sync_search``.
Each module keeps ``launches``, a plain int that its wrapper raises by one
per kernel launch (the twin never counts).
"""

KERNEL_MODULES = ("ofdm_mod", "equalize", "channel_conv", "sync_search")


def _modules():
    import importlib
    return {name: importlib.import_module(f"{__name__}.{name}")
            for name in KERNEL_MODULES}


def launch_counts() -> dict[str, int]:
    return {name: m.launches for name, m in _modules().items()}


def reset_launch_counts() -> None:
    for m in _modules().values():
        m.launches = 0
