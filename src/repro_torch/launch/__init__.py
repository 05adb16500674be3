"""The port's counterpart of ``repro.launch``: device meshes over
torch.distributed ranks (``mesh``), reporting helpers (``report``), the
(arch x shape) grid (``cells``), the roofline on the card (``roofline``),
PyTorch's own view of a program (``op_walk``, for ``hlo_text`` and
``hlo_walk``), the walked-vs-analytic audit (``audit``) and the dry run
of a rank's step on the fake device and process group (``dryrun``)."""
