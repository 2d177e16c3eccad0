"""What the run's process must not hold, and what the reference must not
import: compared by the top-level name of each module, whole, since the
port's name begins with the JAX package's."""

from __future__ import annotations

import ast
import glob
import os
import sys
from typing import List

FORBIDDEN = ("jax", "jaxlib", "flax", "reef_tpu")
REFERENCE_FORBIDDEN = FORBIDDEN + ("reef_tpu_torch",)


def loaded_forbidden() -> List[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def reference_imports(root: str) -> List[str]:
    """`file: module` for every import under `root` (the reference)
    whose top-level name is forbidden there."""
    bad = []
    for path in sorted(glob.glob(os.path.join(root, "**", "*.py"),
                                 recursive=True)):
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, root)}: {n}" for n in names
                    if n.split(".")[0] in REFERENCE_FORBIDDEN]
    return bad
