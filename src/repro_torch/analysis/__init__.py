"""Static layout/access-pattern linter of the PyTorch port (port of
``repro.analysis``).

Three pass families, one findings model, one CLI
(``python -m repro_torch.analysis``):

* ``access`` — the kernel routes walked under the dispatcher
  (``launch.op_walk``): redundant traffic against the irredundant byte
  model, and a wrapper's own copies around a launch (ACC101),
  non-contiguous innermost access on argument data (ACC102), pack-width
  alignment (ACC103);
* ``obs_discipline`` — AST proof that no ``repro_torch.obs`` recording
  call is reachable inside code that ``torch.compile`` traces, a CUDA
  graph captures or ``torch.utils.checkpoint`` replays (OBS201);
* ``layout_invariants`` — solved layouts over the config zoo are valid
  permutations with honest burst accounting (LAY301/LAY302), MARS
  partitions hold (LAY303), codec bit format stays in bounds (LAY304).

Findings gate via a fingerprint suppression baseline
(``baseline.json``, kept empty) and publish as ``analysis/*`` obs
series.  The rule catalog is the reference's
(``src/repro/analysis/README.md``).
"""
from .findings import Finding, SEVERITIES  # noqa: F401
