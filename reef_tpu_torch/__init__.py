"""reef_tpu_torch — the PyTorch/CUDA port of reef_tpu for NVIDIA Hopper.

Zero-knowledge proofs that a committed document matches (or does not
match) a regular expression.  The protocol stack (frontend, constraint
compiler, Nova folding, Spartan, Hyrax/IPA/Pedersen commitments) is host
Python plus the shared C++ in the repository's `native/` directory; the
prover's Pedersen commit MSMs, its large nlookup sumchecks (with their
Poseidon sponge) and the batched Merkle build run on the GPU through
hand-written CUDA kernels (csrc/), built with nvcc at first use.

Layer map:
  L5 cli.py            -- commit/prove/verify/e2e parties, --device
  L4 frontend/         -- regex AST + derivatives, OpenSet, SAFA, solver
  L3 backend/{table,r1cs,costs}.py -- lookup table, constraint compiler
  L2 backend/{framework,nova,commitment,merkle,witness,sumcheck}.py
                       -- proof-system glue and the device routing
  L1 ops/ + ec/ + models/ -- field and curve arithmetic, the device MSM,
                          batched Poseidon, the device sumcheck, the
                          flagship step
  L0 csrc/             -- CUDA kernels (field.cuh, ec.cuh, padd.cu,
                          msm_tree.cu, poseidon.cu, sumcheck.cu) and
                          utils/cudabuild.py
"""

__version__ = "0.1.0"
