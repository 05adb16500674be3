"""Core of the PyTorch port: the paper's host analysis and the block codec.

Paper: "An Irredundant and Compressed Data Layout to Optimize Bandwidth
Utilization of FPGA Accelerators" (Ferry, Derumigny, Derrien, Rajopadhye).

Ported so far: the MARS analysis (``mars``), the layout ILP (``layout``),
the stencil catalogue and dense references (``stencil``), the
variable-width codec (``compression``, ``packing``), the transfer-cycle
model (``transfer``) and the tiled-accelerator executor (``executor``) —
host numpy, the reference's own arithmetic — and the delta + bitplane block
codec in PyTorch (``blockcodec``), whose pack and unpack run on the card.
"""
from . import (blockcodec, compression, executor, layout, mars, packing,
               stencil, transfer)
from .blockcodec import BlockCodecConfig
from .executor import ExecStats, Jacobi1dMarsExecutor
from .layout import LayoutResult, layout_for_analysis, solve_layout
from .mars import Mars, MarsAnalysis, analyze
from .stencil import SPECS, StencilSpec
from .transfer import MODES, TileIO, TileIOModel, TransferModel

__all__ = [
    "BlockCodecConfig", "ExecStats", "Jacobi1dMarsExecutor", "LayoutResult",
    "Mars", "MarsAnalysis", "MODES", "SPECS", "StencilSpec", "TileIO",
    "TileIOModel", "TransferModel", "analyze", "blockcodec", "compression",
    "executor", "layout", "layout_for_analysis", "mars", "packing",
    "solve_layout", "stencil", "transfer",
]
