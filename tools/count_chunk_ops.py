#!/usr/bin/env python3
"""Count the torch operations the device MSM's chunk glue issues, on the CPU.

    python3 tools/count_chunk_ops.py [--repo DIR] [--cap 4096]

Runs `ec/msm_v3.py` `chunk_prefixes` of the checkout DIR (default: the
one that holds this script) once on CPU tensors, with its kernels (the
tree, the point add and, where the checkout has it, the halving reduce)
replaced by stubs that issue nothing, and
counts every aten operation the glue dispatches (views included).  On a
card each non-view operation is one or more kernel launches, and the
chunk is bound by its host's launches, so this count is what the glue
costs the host.  Prints one JSON line: the total and the most frequent
operations.
"""

from __future__ import annotations

import argparse
import collections
import inspect
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--cap", type=int, default=4096)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))

    import numpy as np
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from reef_tpu_torch.backend.commitment import PedersenGens
    from reef_tpu_torch.ec import msm_v3
    from reef_tpu_torch.ec.msm import pallas_kernels

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, fargs=(), kwargs=None):
            self.ops[str(func)] += 1
            return func(*fargs, **(kwargs or {}))

    ck = pallas_kernels()
    cap, W = args.cap, msm_v3.N_WINDOWS
    basis = msm_v3.DeviceBasisV3(ck, PedersenGens(ck.curve, b"count", cap).G,
                                 cap=cap, device="cpu")
    rng = np.random.default_rng(1)
    scb = torch.from_numpy(rng.integers(0, 256, (cap, 32), dtype=np.uint8))
    acc = ck.ident_t("cpu")[:, :, None, None].expand(
        3, 8, W, msm_v3.DP).contiguous()

    def tree(c, placed):
        return torch.zeros((3, 8, W, cap), dtype=torch.int32)

    def padd(c, a, b):
        return a

    def reduce(c, X, acc=None):
        return acc

    kernels = {"padd": padd, "tree": tree}
    if "reduce" in inspect.signature(msm_v3.chunk_prefixes).parameters:
        kernels["reduce"] = reduce
    with Count() as counted:
        msm_v3.chunk_prefixes(ck, basis.arr[0], scb, acc, True, **kernels)
    print(json.dumps({"repo": os.path.abspath(args.repo), "cap": cap,
                      "aten_ops": sum(counted.ops.values()),
                      "most_common": counted.ops.most_common(8)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
