"""The port's counterpart of ``repro.launch``: device meshes over
torch.distributed ranks (``mesh``) and reporting helpers (``report``)."""
