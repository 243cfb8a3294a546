"""Storage layer: the reference block-file codec and the seeded generator."""
