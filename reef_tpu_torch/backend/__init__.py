"""Constraint compiler + proof-system glue (tables, R1CS, nlookup, Nova)."""
