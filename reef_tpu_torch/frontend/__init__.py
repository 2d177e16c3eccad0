"""Host-side frontend: regex AST + derivatives, OpenSet ranges, SAFA."""
