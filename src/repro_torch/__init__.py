"""PyTorch / CUDA port of the reproduction (reference: the JAX package ``repro``).

Laid out module for module like ``repro``.  Ported so far:

* the paper's device pipeline: the delta + bitplane block codec
  (``core.blockcodec``) and the chunked-stencil macro-pipeline with its
  on-chip MARS carry, behind ``kernels.ops`` (``pack_codes``,
  ``unpack_codes``, ``jacobi1d_tiled``);
* the serving path of the dense and vlm model families: ``configs``,
  ``models`` (``model_zoo.get_api(...).prefill`` runs flash attention) and
  ``serve.ServeEngine.generate`` (its packed KV cache is written by
  ``kv_quant_store`` and read by ``kv_decode_attention``, one kernel a layer
  and step that dequantizes the codes on chip and attends);
* their training path: ``train.step.make_train_step`` (loss, backward
  through the flash forward and both flash backward kernels, AdamW from
  ``optim``) and the fault-tolerant ``train.loop.train`` with ``data``'s
  synthetic pipeline and ``checkpoint``'s manager (the reference's on-disk
  layout); on a card without a mesh the loop replays the whole step as a
  CUDA graph (``train.step.GraphedTrainStep``);
* the paper's host analysis in ``core`` (host numpy, the reference's own
  arithmetic): the MARS analysis, the layout ILP, the variable-width codec,
  the transfer-cycle model and the tiled-accelerator executor behind
  Table 1/2 and Fig. 10/11;
* the obs exporters (``obs.sink``, ``python -m repro_torch.obs.report`` and
  ``python -m repro_torch.obs.regress``) with ``launch.report``'s table
  helpers, and ``python -m repro_torch.launch.report``'s roofline and
  dry-run tables over ``launch.dryrun``'s records;
* training on a mesh of torch.distributed ranks (``launch.mesh``): the
  sharding rules (``distributed.sharding``), the ``pod`` and ``data`` axes
  as data parallelism, and the paper's compressed cross-pod gradient
  exchange with error feedback (``distributed.collectives``);
* serving on such a mesh: ``decode_step`` on a rank's blocks of the
  decode state (``ModelApi.decode_state_specs``,
  ``init_decode_state(batch, mesh=)``), the KV cache's slots split over
  ``model``;

with hand-written CUDA kernels for Hopper (sm_90a) in ``kernels/csrc``.

The package imports ``torch`` and numpy, never ``jax`` or ``repro``.  It
imports without a GPU; kernels are built with ``nvcc`` at first launch.
``python3 chip_smoke.py`` at the repository root drives it on a card.
"""
from . import (checkpoint, configs, convert, core, data, distributed, kernels,
               launch, models, obs, optim, serve, train)

__all__ = ["checkpoint", "configs", "convert", "core", "data", "distributed",
           "kernels", "launch", "models", "obs", "optim", "serve", "train"]
