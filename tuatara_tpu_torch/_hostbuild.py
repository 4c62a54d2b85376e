"""Build a host (C or C++) target of the port with the host's compilers.

`target` names the output by a hash of its sources and flags, so an edited
source is rebuilt and an unchanged one reused; `compile_once` runs the
compiler into a temporary file and renames it whole, so concurrent builds
never load half a file. A failed build raises with the compiler's output.
`native.py` (the host post-processing library) and `capi.py` (the C ABI,
its example and the compiled binding) build through these two functions;
the CUDA kernels have their own parallel nvcc build (`kernels/_build.py`).
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from typing import List, Sequence


def target(build_dir: str, stem: str, suffix: str, sources: Sequence[str],
           flags: Sequence[str]) -> str:
    """`build_dir/<stem>-<hash of flags and sources><suffix>`."""
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sources:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(build_dir, f"{stem}-{h.hexdigest()[:16]}{suffix}")


def compile_once(out: str, cmd: List[str], what: str) -> str:
    """Unless `out` exists, run `cmd` with its "{tmp}" argument replaced by
    a temporary path, and rename that file to `out`. -> out."""
    if os.path.isfile(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [tmp if a == "{tmp}" else a for a in cmd]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"building {what} failed: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"building {what} failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out
