"""Field, Poseidon and limb arithmetic: host python ints and torch tensors."""
