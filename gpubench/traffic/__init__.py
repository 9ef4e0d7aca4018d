"""Traffic generators: ``generate(params, config, seed) -> dict`` of the
arrays a stage writes as its input files. The same seed gives the same
inputs; every seed gives the same sizes."""
