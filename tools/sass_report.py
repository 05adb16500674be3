"""ptxas' registers and spills, and the static SASS opcode counts, of every
kernel in the given CUDA sources.

Each source (any path, e.g. an earlier version of a kernel unpacked from
git) is compiled with the port's nvcc flags into a temporary directory.
Needs nvcc and cuobjdump, so it runs on a machine with the CUDA toolkit:

    python3 tools/sass_report.py path/to/a.cu [path/to/b.cu ...]
"""
import json
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import _build  # noqa: E402


def report(src: str, tmp: str) -> dict:
    lib = Path(tmp) / f"{Path(src).stem}.so"
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    ptxas = _build.ptxas_by_kernel(proc.stdout + proc.stderr)
    return {fn: {**ptxas.get(fn, {}), **sass}
            for fn, sass in _build.sass_opcodes(lib).items()}


def main(sources) -> int:
    if not sources:
        print(__doc__, file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        print(json.dumps({src: report(src, tmp) for src in sources}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
