"""Flowgraph composition: the gr.top_block replacement.

Copy of ``lte_gnu_radio_code_tpu/runtime/flowgraph.py`` (``NullSink``,
``CollectSink``, ``Flowgraph``).  A Flowgraph is a linear chain source ->
blocks -> sink driven in fixed-size chunks.  Sources are callables
n_samples -> np.ndarray, blocks callables chunk -> chunk (the port's
streaming receivers' ``push`` among them: they carry their state on the
device), sinks take each block output.  It replaces the reference's Qt /
GNU Radio apps (GNU-Radio-Repositories/ofdm_chain.py:42-91: TX -> RX ->
null sink).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np


class NullSink:
    """gr.blocks.null_sink equivalent (ofdm_chain.py:80)."""

    def __call__(self, chunk) -> None:
        pass


class CollectSink:
    """Accumulates everything pushed into it (diagnostics/testing)."""

    def __init__(self):
        self.items = []

    def __call__(self, chunk) -> None:
        self.items.append(chunk)


class Flowgraph:
    """Linear top_block: connect(src, *blocks, sink), then run(n_chunks)."""

    def __init__(self, chunk_len: int):
        self.chunk_len = chunk_len
        self.src: Callable[[int], np.ndarray] | None = None
        self.blocks: Sequence[Callable] = []
        self.sink: Callable | None = None

    def connect(self, src, *blocks_and_sink):
        """connect(tx_source, rx_block, ..., sink) — mirrors
        ofdm_chain.py:90-91's self.connect((tx,0), (rx,0)) chain."""
        self.src = src
        *blocks, sink = blocks_and_sink
        self.blocks = list(blocks)
        self.sink = sink
        return self

    def run(self, n_chunks: int):
        """Drive the chain; the analog of tb.start()/wait()."""
        if self.src is None or self.sink is None:
            raise RuntimeError("Flowgraph.run: connect() a source and a sink "
                               "first")
        for _ in range(n_chunks):
            data = self.src(self.chunk_len)
            for blk in self.blocks:
                data = blk(data)
            self.sink(data)
        return self
