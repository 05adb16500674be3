"""What a step dispatches: the check that a step can be captured as a CUDA
graph, shared by ``tests/test_torch_train_graph.py`` (one device) and
``tests/test_torch_distributed.py`` (the mesh step, inside its gloo ranks).

A graph can only replay what reads and writes tensors at fixed addresses:
no tensor made from host data (``aten.lift_fresh`` / ``lift_fresh_copy``)
and no value read back (``aten._local_scalar_dense``), apart from the
range check of ``F.one_hot`` on CPU tensors (two reads a call, its min and
max; the CUDA op does not check).
"""
import torch
from torch.utils._python_dispatch import TorchDispatchMode

HOST_TENSOR_OPS = ("aten.lift_fresh.default", "aten.lift_fresh_copy.default")
SCALAR_READ = "aten._local_scalar_dense.default"


class OpsSeen(TorchDispatchMode):
    """Records each aten op, and whether it ran inside ``F.one_hot``
    (``one_hot``, which ``install`` puts in its place, counts the calls
    under way; a ``TorchFunctionMode`` would miss the remat's recompute)."""

    def __init__(self):
        super().__init__()
        self.seen, self.depth, self.calls = [], 0, 0

    def install(self, monkeypatch):
        plain = torch.nn.functional.one_hot

        def one_hot(*args, **kw):
            self.calls += 1
            self.depth += 1
            try:
                return plain(*args, **kw)
            finally:
                self.depth -= 1
        monkeypatch.setattr(torch.nn.functional, "one_hot", one_hot)
        return self

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.append((str(func), self.depth > 0))
        return func(*args, **(kwargs or {}))

    def summary(self) -> dict:
        """The ops seen, the host-made tensors, and the scalar reads outside
        ``F.one_hot`` and inside it."""
        names = [f for f, _ in self.seen]
        reads = [inside for f, inside in self.seen if f == SCALAR_READ]
        return {"names": names,
                "host_tensors": [f for f in names if f in HOST_TENSOR_OPS],
                "reads_outside": reads.count(False),
                "reads_inside": reads.count(True)}
