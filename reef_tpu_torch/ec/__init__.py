"""Pasta curve arithmetic: host oracle, batched torch point adds, CUDA MSM."""
