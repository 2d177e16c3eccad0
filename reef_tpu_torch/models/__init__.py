"""Device workloads of the prover (the flagship step)."""
