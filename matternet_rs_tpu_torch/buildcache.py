"""Build native sources into shared objects, cached by content.

Each library is compiled at first use into ``_build/`` beside this file
(listed in ``.gitignore``), named by a hash of its compiler command and
the bytes of its sources and of the headers they include (``deps``: hashed,
never handed to the compiler), so an edited file is rebuilt and an
unchanged one is not.
Several libraries build at once (one compiler process each). The output is
written to a per-process temporary name and renamed into place, so two
processes building the same library never see a half-written file.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pathlib
import subprocess

BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
BUILD_TIMEOUT_S = 600.0       # per compiler process

# Compiler output (e.g. ``-Xptxas -v`` register/shared-memory reports) by
# library name, of the builds this process ran; a library found built has
# no entry.
BUILD_LOG: dict[str, str] = {}


@dataclasses.dataclass(frozen=True)
class Spec:
    name: str
    sources: tuple[pathlib.Path, ...]
    cmd: tuple[str, ...]          # compiler and flags, without -o / sources
    deps: tuple[pathlib.Path, ...] = ()   # included headers: hashed, not compiled

    def target(self) -> pathlib.Path:
        h = hashlib.sha256("\0".join(self.cmd).encode())
        for src in (*self.sources, *self.deps):
            h.update(src.read_bytes())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:16]}.so"


def build(specs: list[Spec]) -> list[pathlib.Path]:
    """Build every spec whose target is missing, all at once; return the
    targets in order. Raises ``RuntimeError`` with the compiler output on
    a failed build."""
    targets = [s.target() for s in specs]
    running = []
    for spec, out in zip(specs, targets):
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        argv = [*spec.cmd, "-o", str(tmp), *map(str, spec.sources)]
        proc = subprocess.Popen(
            argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running.append((spec, out, tmp, proc))
    errors = []
    for spec, out, tmp, proc in running:
        try:
            log, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            log += f"\n(build timed out after {BUILD_TIMEOUT_S:.0f}s)"
        BUILD_LOG[spec.name] = log
        if proc.returncode == 0 and tmp.exists():
            os.replace(tmp, out)
        else:
            tmp.unlink(missing_ok=True)
            errors.append(f"{spec.name}: {' '.join(spec.cmd)}\n{log}")
    if errors:
        raise RuntimeError("native build failed:\n" + "\n".join(errors))
    return targets
